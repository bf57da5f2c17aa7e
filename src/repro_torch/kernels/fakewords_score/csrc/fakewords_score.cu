// Dense fake-words score matrix for Hopper (sm_90a), CUDA C++ with a plain C
// interface (bound with ctypes by ../kernel.py).
//
// Replaces the TPU kernel repro/kernels/fakewords_score/kernel.py::
// score_matmul (def 48, pallas_call 70): scores = q @ docs.T, (B, N), with
// bf16 operands accumulated in f32 (classic: the query against `scored`) or
// int8 operands accumulated in int32 (dot: the [u; -u] query against `tf`),
// the int32 sums written as f32 (the reference's default) or as int32.
//
// Bound on an H100 SXM at the ann-word2vec cell (B = 256, N = 2,999,808,
// T = 600): classic reads 3.60 GB of `scored` and writes 3.07 GB of f32
// scores, 1.99 ms at 3.35 TB/s, above the 0.93 ms its 9.2e11 products take
// on bf16 tensor cores: bytes bound it.  Dot reads 1.80 GB of int8 tf:
// 1.45 ms, bytes again.  This first kernel multiplies on CUDA cores (bf16
// widened to f32, int8 by __dp4a; no tensor cores, no TMA), so it runs well
// above that bound.  The 1,200-byte bf16 rows take 16-byte loads, the
// 600-byte int8 rows 8-byte loads.  The tile is the shared
// ../../csrc/dense_scores.cuh (K6 and K8 use it too).

#include "dense_scores.cuh"

extern "C" {

// mode 1 (bf16, f32 out) or 2 (int8; out_int: int32 out, else f32).
int score_matmul_launch(int mode, int out_int, const void* q, const void* docs, void* out, int B,
                        int N, int T, int q_align, int d_align, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kBF16 && !out_int)
    return launch_dense_scores<kBF16, kOutF32>(q, docs, nullptr, out, B, N, T, q_align, d_align,
                                               s);
  if (mode == kI8 && !out_int)
    return launch_dense_scores<kI8, kOutF32>(q, docs, nullptr, out, B, N, T, q_align, d_align, s);
  if (mode == kI8)
    return launch_dense_scores<kI8, kOutI32>(q, docs, nullptr, out, B, N, T, q_align, d_align, s);
  return (int)cudaErrorInvalidValue;
}

const char* fakewords_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
