// The MinHash collision count on CUDA cores that K2 (K1's lsh mode,
// ../fused_topk/csrc/fused_topk.cu: fused_topk_lsh_partial) and K8 (the dense
// (B, N) counts, ../lsh_match/csrc/lsh_match.cu: lsh_match_counts) share: the
// thread tile of a block of BQ queries (LshTile), the staged chunk's layout
// (kBK slots a row, kLshStride words apart, kLshStages stages of a cp.async
// ring), and the count of a staged chunk (lsh_chunk) on one compare a query
// word and doc word (lsh_word).  A count of 32-bit equalities is no product,
// so it runs on CUDA cores: one ISETP (the INT32 pipe, 64 lanes an SM) and
// one predicated FADD (the FP32 pipe) a compare, counts in f32 registers
// (exact up to 2^24).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_operands.cuh"  // kBK

namespace {

constexpr int kLshThreads = 256;     // threads a block
constexpr int kLshStride = kBK + 4;  // staged row stride in words: 16-byte rows, LDS.128 conflict-free
constexpr int kLshStages = 3;        // cp.async ring: two chunks in flight

// The thread tile of a block of BQ queries (64, 8, 4, 2 or 1): each of
// its NT threads counts TQ queries against TD docs; QG query groups x DG doc
// groups make the block, and BN = DG x TD docs a tile.  TQ x TD is 4 x 8 at
// 64 queries, 4 x 2 at 8, and BQ x 1 below.
template <int BQ>
struct LshTile {
  static constexpr int NT = kLshThreads;
  static constexpr int TQ = BQ < 4 ? BQ : 4;
  static constexpr int QG = BQ / TQ;
  static constexpr int DG = NT / QG;
  static constexpr int TD = BQ == 64 ? 8 : (BQ == 8 ? 2 : 1);
  static constexpr int BN = DG * TD;
  static_assert(QG * TQ == BQ && QG * DG == NT, "query groups must tile the block");
};

// Docs a tile of the instance for bq queries (LshTile<bq>::BN).
__host__ __device__ constexpr int lsh_bn(int bq) { return bq == 64 ? 128 : 256; }

// acc[j] += 1 where query word qw equals doc word d[j] and is not the
// sentinel: the sentinel test once per query word, as the predicate that
// every equality ISETP ANDs in, and a predicated FADD a compare (the FP32
// pipe, beside the ISETPs on the INT32 one).  Counts up to 2^24 are exact in
// f32.
template <int TD>
__device__ __forceinline__ void lsh_word(float (&acc)[TD], uint32_t qw, const uint32_t (&d)[TD]) {
  if constexpr (TD == 8) {
    asm("{\n .reg .pred q, p;\n setp.ne.u32 q, %8, 0xFFFFFFFF;\n"
        " setp.eq.and.u32 p, %8, %9, q;\n @p add.f32 %0, %0, 0f3F800000;\n"
        " setp.eq.and.u32 p, %8, %10, q;\n @p add.f32 %1, %1, 0f3F800000;\n"
        " setp.eq.and.u32 p, %8, %11, q;\n @p add.f32 %2, %2, 0f3F800000;\n"
        " setp.eq.and.u32 p, %8, %12, q;\n @p add.f32 %3, %3, 0f3F800000;\n"
        " setp.eq.and.u32 p, %8, %13, q;\n @p add.f32 %4, %4, 0f3F800000;\n"
        " setp.eq.and.u32 p, %8, %14, q;\n @p add.f32 %5, %5, 0f3F800000;\n"
        " setp.eq.and.u32 p, %8, %15, q;\n @p add.f32 %6, %6, 0f3F800000;\n"
        " setp.eq.and.u32 p, %8, %16, q;\n @p add.f32 %7, %7, 0f3F800000;\n}"
        : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]), "+f"(acc[4]), "+f"(acc[5]),
          "+f"(acc[6]), "+f"(acc[7])
        : "r"(qw), "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]), "r"(d[4]), "r"(d[5]), "r"(d[6]),
          "r"(d[7]));
  } else if constexpr (TD == 2) {
    asm("{\n .reg .pred q, p;\n setp.ne.u32 q, %2, 0xFFFFFFFF;\n"
        " setp.eq.and.u32 p, %2, %3, q;\n @p add.f32 %0, %0, 0f3F800000;\n"
        " setp.eq.and.u32 p, %2, %4, q;\n @p add.f32 %1, %1, 0f3F800000;\n}"
        : "+f"(acc[0]), "+f"(acc[1])
        : "r"(qw), "r"(d[0]), "r"(d[1]));
  } else {
    static_assert(TD == 1, "a thread counts 8, 2 or 1 docs");
    asm("{\n .reg .pred q, p;\n setp.ne.u32 q, %1, 0xFFFFFFFF;\n"
        " setp.eq.and.u32 p, %1, %2, q;\n @p add.f32 %0, %0, 0f3F800000;\n}"
        : "+f"(acc[0])
        : "r"(qw), "r"(d[0]));
  }
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int w) {
  return w == 0 ? v.x : (w == 1 ? v.y : (w == 2 ? v.z : v.w));
}

// This thread's counts of a staged chunk of `words` slots: the first
// `rows` of its TQ queries (kAll: all of them) against its TD docs, 4 slots
// a step (one LDS.128 a doc row and a query row), the last step cut to the
// slots the chunk has (words % 4, the ring's zero-filled words never read);
// the full steps unrolled kUnroll times.
template <int BQ, bool kAll, int kUnroll = 4>
__device__ __forceinline__ void lsh_chunk(float (&acc)[LshTile<BQ>::TQ][LshTile<BQ>::TD],
                                          const uint32_t* ds, const uint32_t* qs, int dg, int qg,
                                          int words, int rows) {
  using L = LshTile<BQ>;
  auto step = [&](int kk, int n) {
    uint4 dv[L::TD], qv[L::TQ];
#pragma unroll
    for (int j = 0; j < L::TD; ++j)
      dv[j] = *reinterpret_cast<const uint4*>(ds + (dg + L::DG * j) * kLshStride + kk);
#pragma unroll
    for (int i = 0; i < L::TQ; ++i)
      if (kAll || i < rows)
        qv[i] = *reinterpret_cast<const uint4*>(qs + (qg * L::TQ + i) * kLshStride + kk);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (w >= n) break;
      uint32_t d[L::TD];
#pragma unroll
      for (int j = 0; j < L::TD; ++j) d[j] = word_of(dv[j], w);
#pragma unroll
      for (int i = 0; i < L::TQ; ++i)
        if (kAll || i < rows) lsh_word<L::TD>(acc[i], word_of(qv[i], w), d);
    }
  };
  const int full = words / 4;
#pragma unroll (kUnroll)
  for (int g = 0; g < full; ++g) step(4 * g, 4);
  if (words % 4) step(4 * full, words % 4);
}

}  // namespace
