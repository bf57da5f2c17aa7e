// Dense cosine score matrix for Hopper (sm_90a), CUDA C++ with a plain C
// interface (bound with ctypes by ../kernel.py).
//
// Replaces the TPU kernel repro/kernels/cosine_score/kernel.py::
// cosine_scores (def 36, pallas_call 57): scores = (q @ docs.T) * inv_norm,
// (B, N) f32, for unit-normalized f32 queries against raw f32 documents,
// with each document's inverse norm applied in the epilogue, so the store
// streams once, unmodified, and no normalized copy exists.
//
// Bound on an H100 SXM at the ann-word2vec cell (B = 256, N = 2,999,808,
// dim = 300): 4.6e11 f32 operations, 6.88 ms at 67 TFLOP/s (CUDA cores,
// full f32), above the 1.99 ms of its bytes (3.60 GB in, 3.07 GB out):
// operations bound it.  The product runs on CUDA cores in f32, the rate
// that bound assumes; the 1,200-byte rows take 16-byte loads.  The tile is
// the shared ../../csrc/dense_scores.cuh (K8 uses it too).

#include "dense_scores.cuh"

extern "C" {

int cosine_scores_launch(const void* q, const void* docs, const float* inv_norm, void* out, int B,
                         int N, int T, int q_align, int d_align, void* stream) {
  return launch_dense_scores<kF32, kOutScaled>(q, docs, inv_norm, out, B, N, T, q_align, d_align,
                                               static_cast<cudaStream_t>(stream));
}

const char* cosine_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
