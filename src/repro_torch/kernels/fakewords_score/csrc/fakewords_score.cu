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
// on bf16 tensor cores (989 TFLOP/s): bytes bound it.  Dot reads 1.80 GB of
// int8 tf and writes the same 3.07 GB: 1.45 ms, above its 0.47 ms of int8
// products (1,979 TOP/s).  The output is 46% of classic's bytes and 63% of
// dot's, so the epilogue's stores count as much as the products.
//
// Design: one body, the shared ../../csrc/score_matmul.cuh (K6 runs it too),
// templated on the product type (score_matmul_bf16: mma.sync m16n8k16 bf16
// x bf16 -> f32, HMMA; score_matmul_int8: m16n8k32 s8 x s8 -> s32, IMMA,
// the exact int32 sum cast to f32 once, or written as it is).  Here: 128
// queries x 256-doc tiles, each of 8 warps 64 x 64, 128 accumulators a
// thread, so an ldmatrix feeds four mma (at 64 x 32 a warp it fed 2.7: no
// faster); the block's queries resident in shared memory where T <= 640
// bf16 or 1,280 int8 columns (at B = 256 L2 then serves 7.2 GB to the SMs
// and not 14.4: a 128 x 128 block re-read the queries with every doc tile,
// and its loads alone took 3.5 ms); int8 rows of 600 bytes take the ring of
// 8-byte cp.async.ca copies (eight stages beside dot's resident queries
// left L1 too small and ran slower).
//   * What sets the pace (chip_smoke.py --ablate, PERF.md): classic's
//     products alone take ~2.6 ms on mma.sync, and the whole kernel runs at
//     the card's 700 W limit with the SM clock down to ~1.7 GHz; dot's
//     stores and products.

#include <stdint.h>

#include <type_traits>

#include "score_matmul.cuh"  // the body, its loaders and launch; the mma wrappers

namespace {

// The product types (score_matmul.cuh): a bf16 or int8 query against rows
// of the same type, 256-doc tiles, the mma straight onto the row's sums.
struct Bf16Product {
  using Elem = uint16_t;  // bf16 bits
  using Acc = float;
  static constexpr int kMode = kBF16;
  static constexpr int kCols = kChunk / 2;
  static constexpr int kBD = 256;
  static constexpr int kARegs = 4, kBRegs = 2;
  static constexpr bool kFold = false;
  static __device__ __forceinline__ void split_a(unsigned (&)[4]) {}
  static __device__ __forceinline__ void split_b(unsigned (&)[2]) {}
  static __device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                             const unsigned (&b)[2]) {
    mma_bf16(c, a, b);
  }
};
struct S8Product {
  using Elem = int8_t;
  using Acc = int;
  static constexpr int kMode = kI8;
  static constexpr int kCols = kChunk;
  static constexpr int kBD = 256;
  static constexpr int kARegs = 4, kBRegs = 2;
  static constexpr bool kFold = false;
  static __device__ __forceinline__ void split_a(unsigned (&)[4]) {}
  static __device__ __forceinline__ void split_b(unsigned (&)[2]) {}
  static __device__ __forceinline__ void mma(int (&c)[4], const unsigned (&a)[4],
                                             const unsigned (&b)[2]) {
    mma_s8(c, a, b);
  }
};

// One block a SM: 128 accumulators a thread.
template <int CP, bool RESIDENT, int NS>
__global__ void __launch_bounds__(kThreads, 1) score_matmul_bf16(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ docs, float* __restrict__ out,
    int B, int N, int T, int q_align, int d_align, int q_tiles, int tiles_per_split) {
  score_matmul_body<Bf16Product, float, false, CP, RESIDENT, NS>(
      q, docs, nullptr, out, B, N, T, q_align, d_align, q_tiles, tiles_per_split);
}

template <int OUT_INT, int CP, bool RESIDENT, int NS>
__global__ void __launch_bounds__(kThreads, 1) score_matmul_int8(
    const int8_t* __restrict__ q, const int8_t* __restrict__ docs, void* __restrict__ out,
    int B, int N, int T, int q_align, int d_align, int q_tiles, int tiles_per_split) {
  using O = typename std::conditional<OUT_INT != 0, int, float>::type;
  score_matmul_body<S8Product, O, false, CP, RESIDENT, NS>(
      q, docs, nullptr, static_cast<O*>(out), B, N, T, q_align, d_align, q_tiles,
      tiles_per_split);
}

}  // namespace

extern "C" {

// mode 1 (bf16, f32 out) or 2 (int8; out_int: int32 out, else f32).
int score_matmul_launch(int mode, int out_int, const void* q, const void* docs, void* out, int B,
                        int N, int T, int q_align, int d_align, void* stream) {
  if (B <= 0 || N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kBF16 && !out_int) {
    const auto* qb = static_cast<const uint16_t*>(q);
    const auto* db = static_cast<const uint16_t*>(docs);
    const int n_chunks = (T + Bf16Product::kCols - 1) / Bf16Product::kCols;
    return (int)by_loader<Bf16Product>(q_align, d_align, n_chunks, [&](auto l) {
      using L = decltype(l);
      return launch<Bf16Product, L::kResident, L::kStages>(
          score_matmul_bf16<L::kCp, L::kResident, L::kStages>, B, N, n_chunks, s, qb, db,
          static_cast<float*>(out), B, N, T, q_align, d_align);
    });
  }
  if (mode == kI8) {
    const auto* qi = static_cast<const int8_t*>(q);
    const auto* di = static_cast<const int8_t*>(docs);
    const int n_chunks = (T + S8Product::kCols - 1) / S8Product::kCols;
    return (int)by_loader<S8Product>(q_align, d_align, n_chunks, [&](auto l) {
      using L = decltype(l);
      return out_int
                 ? launch<S8Product, L::kResident, L::kStages>(
                       score_matmul_int8<1, L::kCp, L::kResident, L::kStages>, B, N, n_chunks, s,
                       qi, di, out, B, N, T, q_align, d_align)
                 : launch<S8Product, L::kResident, L::kStages>(
                       score_matmul_int8<0, L::kCp, L::kResident, L::kStages>, B, N, n_chunks, s,
                       qi, di, out, B, N, T, q_align, d_align);
    });
  }
  return (int)cudaErrorInvalidValue;
}

const char* fakewords_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
