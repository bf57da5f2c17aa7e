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
// dim = 300): its bytes (3.60 GB of rows in, 3.07 GB of scores out) take
// 1.99 ms at 3.35 TB/s; its 4.6e11 f32 products, run as split TF32 (three
// tf32 products each), take 2.79 ms at 495 TFLOP/s: operations bound it
// (6.88 ms at the 67 TFLOP/s of f32 FMA on CUDA cores).
//
// Design: K7's tensor-core body, the shared ../../csrc/score_matmul.cuh, over
// product type Tf32x3Product: raw f32 rows are not exact in tf32, so both
// fragments are split by bit masks after ldmatrix, the query's (A) into
// hi = q cut to tf32 and lo = (q - hi) cut to tf32, each doc's (B) alike,
// and a k-step of 8 columns is three mma.sync m16n8k8 tf32, the small terms
// first: q hi x doc lo, q lo x doc hi, q hi x doc hi (a score within
// ~3 x 2^-20 |q| |d|; K1 f32's MmaTf32x3 order, mma_topk.cuh, with A and B
// swapped).  Each 16-column chunk's products are summed from zero in a
// fragment of their own that an f32 add folds into the row's sum: the
// tensor cores' own running sums lose low bits (K1 f32's kFold; PERF.md).
// That second set of accumulators is why a warp takes 64 queries x 32 docs
// (64 + 64 accumulators a thread; K7's 64 x 64 would need 256 registers),
// so a block's tile is 128 queries x 128 docs.  1,200-byte rows take the
// 16-byte cp.async ring, and the block's queries stay resident in shared
// memory up to 384 columns (24 chunks beside four 8 KB stages); rows
// aligned to 4 bytes (T = 257) take the register loader.

#include <stdint.h>

#include "score_matmul.cuh"  // the body, its loaders and launch; mma_tf32, kTf32Bits

namespace {

// An f32 query against raw f32 rows, 128-doc tiles: A fragments a[0..3] as
// loaded become hi, a[4..7] lo; B fragments b[0..1] hi, b[2..3] lo.
struct Tf32x3Product {
  using Elem = float;
  using Acc = float;
  static constexpr int kMode = kF32;
  static constexpr int kCols = kChunk / 4;
  static constexpr int kBD = 128;
  static constexpr int kARegs = 8, kBRegs = 4;
  static constexpr bool kFold = true;
  static __device__ __forceinline__ void split_a(unsigned (&a)[8]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = __uint_as_float(a[r]);
      a[r] &= kTf32Bits;
      a[4 + r] = __float_as_uint(x - __uint_as_float(a[r])) & kTf32Bits;
    }
  }
  static __device__ __forceinline__ void split_b(unsigned (&b)[4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x = __uint_as_float(b[r]);
      b[r] &= kTf32Bits;
      b[2 + r] = __float_as_uint(x - __uint_as_float(b[r])) & kTf32Bits;
    }
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[8],
                                             const unsigned (&b)[4]) {
    const unsigned q_hi[4] = {a[0], a[1], a[2], a[3]}, q_lo[4] = {a[4], a[5], a[6], a[7]};
    mma_tf32(c, q_hi, b[2], b[3]);  // q hi x doc lo
    mma_tf32(c, q_lo, b[0], b[1]);
    mma_tf32(c, q_hi, b[0], b[1]);
  }
};

// One block a SM: 64 + 64 accumulators a thread.
template <int CP, bool RESIDENT, int NS>
__global__ void __launch_bounds__(kThreads, 1) cosine_scores_tf32(
    const float* __restrict__ q, const float* __restrict__ docs,
    const float* __restrict__ inv_norm, float* __restrict__ out, int B, int N, int T,
    int q_align, int d_align, int q_tiles, int tiles_per_split) {
  score_matmul_body<Tf32x3Product, float, true, CP, RESIDENT, NS>(
      q, docs, inv_norm, out, B, N, T, q_align, d_align, q_tiles, tiles_per_split);
}

}  // namespace

extern "C" {

int cosine_scores_launch(const void* q, const void* docs, const float* inv_norm, void* out, int B,
                         int N, int T, int q_align, int d_align, void* stream) {
  if (B <= 0 || N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* df = static_cast<const float*>(docs);
  const int n_chunks = (T + Tf32x3Product::kCols - 1) / Tf32x3Product::kCols;
  return (int)by_loader<Tf32x3Product>(q_align, d_align, n_chunks, [&](auto l) {
    using L = decltype(l);
    return launch<Tf32x3Product, L::kResident, L::kStages>(
        cosine_scores_tf32<L::kCp, L::kResident, L::kStages>, B, N, n_chunks, s, qf, df,
        inv_norm, static_cast<float*>(out), B, N, T, q_align, d_align);
  });
}

const char* cosine_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
