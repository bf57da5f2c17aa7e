// Causal GQA flash attention (forward) for Hopper (sm_90a), CUDA C++ with a
// plain C interface (bound with ctypes by ../kernel.py).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (def 74, pallas_call 99): out = softmax(mask(q k^T /
// sqrt(D))) v for q (B, Hq, S, D) and k, v (B, Hkv, S, D), Hq % Hkv == 0;
// query head h reads KV head h / (Hq / Hkv) by index, with no copy of K or
// V.  As in the reference, the logits and the online-softmax statistics (row
// max m, row sum l) are f32, masked logits are -1e30 (finite: a row's first
// tile always holds key 0, and -1e30 - (-1e30) is 0, where -inf would give
// NaN), and the output is acc / max(l, 1e-30) cast to the input dtype (f32
// or bf16, rounded to nearest even).  The TPU kernel has no backward; the
// port's is flash_attention_bwd.cu, which recomputes the probabilities from
// the row log-sum-exp that flash_attention_lse_launch also writes: lse =
// m ln 2 + ln l, in natural-log units of the scaled logits (m is kept in
// log2 units, below).
//
// Bound on an H100 SXM at deepseek-coder-33b's prefill_32k sequence (one
// layer: Hq 56, Hkv 8, D 128, S 32,768, bf16, B 1): the causal products are
// 4 * Hq * D * S (S + 1) / 2 = 1.54e13 operations, 15.6 ms at the bf16
// tensor-core rate of wgmma (989 TFLOP/s), far above the 0.32 ms of its
// bytes (q, k, v and the output read or written once): operations bound it.
// The bf16 instances below issue mma.sync, whose peak on Hopper is below
// wgmma's (not measured here; this kernel issues its own 2.3e13 mma
// operations at deepseek's layer, the split P's included, at ~360 TFLOP/s,
// a floor of that peak: PERF.md), so that bound is out of their reach.
//
// bf16 (flash_attention_bf16<D>, D in {32, 64, 96, 128}): a
// FlashAttention-2-style forward on mma.sync m16n8k16 bf16 -> f32 (HMMA).
//   * One block of 8 warps per (query head, batch, 128-row query tile); warp
//     w owns rows 16 w .. 16 w + 15.  The grid's slowest axis is the query
//     tile, walked from the last (the most KV tiles) to the first, and the
//     query heads of one KV head are adjacent, so they share its tiles in L2.
//     128 rows a block, not 64, halve the KV bytes read from L2 (at 64 the
//     loads alone took 45 of ~70 ms at deepseek's layer; PERF.md).
//   * Q is copied once by 16-byte cp.async into shared memory (rows D + 8
//     bf16 apart: the eight rows an ldmatrix phase reads fall on distinct
//     banks) and held in registers as the A fragments of every k-step
//     (D / 16 of them) for the whole block.
//   * 64-key tiles of K and V stream through a ring of kStages stages by
//     16-byte cp.async, rows past S zero-filled by the copy's source size;
//     the next tile's copy is in flight while this one is multiplied, with
//     one barrier a tile.  Q's staging lies in the last stage, which no tile
//     fills before every warp holds its Q fragments.  Tiles wholly above the
//     diagonal are never read; only the tiles across it are masked, so
//     the others carry no compare.
//   * S = Q K^T: K fragments by ldmatrix from K's rows (keys on N).  The
//     products of bf16 values are exact in f32, so only the order of the
//     f32 sums differs from the reference.
//   * Online softmax on the accumulator fragments: each thread holds rows
//     r and r + 8 of its warp's 16 (16 logits of each a tile); the row max
//     takes two __shfl_xor_sync within the quad that shares a row.  The
//     exponentials are ex2.approx (exp2f as fast math compiles it) of the
//     logit times log2(e) / sqrt(D), the max kept in those units.  Each
//     thread sums its own share of l from the f32 probabilities; the quad's
//     shares, all rescaled by the same alpha, are added once at the end.
//   * P V without shared memory: P stays in the accumulator registers,
//     which are the A fragments of the P V mma in place (the m16n8
//     accumulators of two adjacent key fragments are exactly an m16k16 A
//     fragment), split into two bf16 parts: hi, P rounded to bf16, and lo,
//     the remainder rounded to bf16, each multiplied by V (two mma, lo
//     first).  hi alone is off by up to 2^-8 of each probability; on random
//     data at S >= 1024 that moves whole bf16 output rows past the check's
//     1e-2 row rule (tests/test_torch_flash_attention.py), where hi + lo,
//     within 2^-16, stays at the f32 product's error.  V fragments come by
//     ldmatrix.trans from V's rows.  O stays in f32 registers (16 x D a
//     warp: 64 floats a thread at D 128), rescaled by alpha each tile, and
//     is written as bf16 pairs.
// Left for wgmma and TMA: a warpgroup-wide product with K and V read by the
// tensor cores from shared memory (here each warp re-reads the whole K and V
// tile through ldmatrix), TMA copies with mbarriers in place of the cp.async
// ring, and a producer warp so that softmax, copies and products overlap.
//
// f32 (flash_attention_tf32<D>, D in {32, 64, 96, 128}): the same block
// shape, grid order, ring, masking and online softmax on mma.sync m16n8k8
// tf32 -> f32 (HMMA on TF32 operands), as split TF32.  f32 attention's 1e-4
// row rule leaves no room for one tf32 rounding (10 fraction bits) of an
// operand, so each f32 operand x is split by bit masks into hi, x cut to
// tf32, and lo, the remainder cut to tf32, and a product is three tf32
// products: a hi x b lo, a lo x b hi, a hi x b hi (small terms first; lo x
// lo, ~2^-22 of it, is left out), as in K6 and K1 f32.
//   Bound at phi3-mini's f32 layer (Hq = Hkv = 32, D 96, S 4,096, B 1):
//   3 x 1.03e11 tf32 operations, 0.625 ms at the TF32 rate of wgmma (495
//   TFLOP/s; mma.sync reaches less), far above the 0.06 ms of its bytes;
//   the plain product's f32 FMAs alone would take 1.539 ms at 67 TFLOP/s.
//   * Staged rows are D + 4 floats apart (16 bytes past a multiple of 128),
//     so the eight rows an ldmatrix phase reads fall on distinct banks.  A
//     tf32 m16n8k8 fragment sits at the bytes of a bf16 m16n8k16 one, so
//     Q's A fragments and K's B fragments come by plain ldmatrix.  The ring
//     takes 2 x 2 x 64 x (D + 4) floats (102 KB at D 96).  Q has a 128-row
//     region of its own beside the ring and is read by ldmatrix and split
//     at each k-step of every tile (kQRegs false): held split in registers
//     for the whole block it takes D registers a thread beside O, the
//     fold's sums and the logits, and spilled at D 96 and 128 (PERF.md).
//   * S = Q K^T: a k-step (8 columns) is three mma a key fragment, q hi x k
//     lo, q lo x k hi, q hi x k hi, with K's fragments split after ldmatrix.
//   * P V with P in registers, by a permutation of the keys: the tf32 A
//     fragment wants row r at k-columns t and t + 4 (t = lane % 4), and an
//     8-key fragment's logits hold keys 2t and 2t + 1 of rows r and r + 8
//     (c0..c3), so A = {c0, c2, c1, c3}, k-column t read as key 2t and t +
//     4 as key 2t + 1.  V's B fragment follows: b0 = V[2t][n], b1 = V[2t +
//     1][n].  ldmatrix.trans cannot transpose 32-bit elements, so V comes
//     by 16-byte shared loads, which permute O's columns too: column n (=
//     lane / 4) of O's fragment 4 c + i is column 32 c + 4 n + i, so one
//     load of V[2t][32 c + 4 n ..] holds b0 of four fragments, and a thread
//     ends with eight adjacent columns of each of its rows (two 16-byte
//     stores).  (D + 4) % 32 = 4, so a quarter warp's loads fall on
//     distinct banks.  P and V are split as Q and K: three mma a (key
//     fragment, O fragment), p hi x v lo, p lo x v hi, p hi x v hi.  l is
//     the sum of the f32 probabilities, as for bf16.
//   * The fold (kFold): a tile's P V is summed from zero in a second set of
//     D / 2 accumulators and added into O with the rescale that happens
//     anyway, o = fmaf(o, alpha, tile), so that the tensor cores' own
//     running sums span 24 products and not all 3 S / 8 of the row's:
//     without it the worst row at phi3-mini's layer came within 2x of the
//     1e-4 row rule (PERF.md), as K4's and K6's sums drifted.
// Left for f32 besides wgmma and TMA: every warp splits the whole K and V
// tile again; a split once at staging into hi and lo planes would double
// the ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

// ---- the block shape of both dtypes ----------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;  // query rows per block
constexpr int kMmaBK = 64;              // keys per KV tile
constexpr int kKeyFrags = kMmaBK / 8;   // n8 fragments of a warp's logits
constexpr int kStages = 2;              // K, V ring: one tile in flight
static_assert(kMmaBQ <= 2 * kMmaBK, "Q's staging fits in a stage");

template <int D>
struct Bf16Tile {
  using Elem = uint16_t;
  static constexpr int kCols = D;
  static constexpr int kStride = D + 8;    // staged row stride in bf16 (2 D + 16 bytes)
  static constexpr int kPacks = D / 8;     // 16-byte packs of a row
  static constexpr int kKSteps = D / 16;   // k-steps of Q K^T
  static constexpr int kDFrags = D / 8;    // n8 fragments of O
  static constexpr int kElems = kMmaBK * kStride;  // one staged K or V tile
  static constexpr size_t kSmem = sizeof(uint16_t) * 2 * kStages * kElems;
  static_assert(kPacks * kMmaBK % kMmaThreads == 0, "whole copy rounds");
  static_assert(kPacks * kMmaBQ % kMmaThreads == 0, "whole copy rounds");
};

// f32 tiles for split TF32.  kFold: each tile's P V summed from zero and
// folded into O; kQRegs: Q split once into registers for the whole block
// (staged in the last stage), else re-read from a region of its own.
template <int D>
struct Tf32Tile {
  using Elem = float;
  static constexpr int kCols = D;
  static constexpr int kStride = D + 4;    // staged row stride in floats (4 D + 16 bytes)
  static constexpr int kPacks = D / 4;     // 16-byte packs of a row
  static constexpr int kKSteps = D / 8;    // k-steps of Q K^T
  static constexpr int kDFrags = D / 8;    // n8 fragments of O
  static constexpr int kDGroups = D / 32;  // four O fragments a 16-byte load of V
  static constexpr int kElems = kMmaBK * kStride;  // one staged K or V tile
  static constexpr bool kFold = true;
  static constexpr bool kQRegs = false;
  static constexpr size_t kSmem =
      sizeof(float) * (2 * kStages * kElems + (kQRegs ? 0 : kMmaBQ * kStride));
  static_assert(D % 32 == 0, "whole 32-column groups of O");
  static_assert(kPacks * kMmaBK % kMmaThreads == 0, "whole copy rounds");
  static_assert(kPacks * kMmaBQ % kMmaThreads == 0, "whole copy rounds");
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The row's log-sum-exp of the scaled logits, m ln 2 + ln l (m in log2 units).
__device__ __forceinline__ void store_lse(float* lse, size_t row, float m, float l) {
  lse[row] = fmaf(m, 0.69314718055994531f, logf(l));
}

// Two f32 as bf16 (round to nearest even) in one register, the first in the
// low half: an mma fragment's or the output's element pair.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Two probabilities a, b as the bf16 pairs hi (each rounded to bf16) and lo
// (each remainder, exact in f32, rounded to bf16): hi + lo is each to 2^-16
// of itself, where hi alone is off by up to 2^-8.
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi, unsigned& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xFFFF0000u));
}

// Rows [r0, r0 + ROWS) of a head's (S, D) matrix into staged rows of the
// tile Tl (bf16 or f32) by 16-byte cp.async; rows past S are zero-filled and
// read nothing.
template <class Tl, int ROWS = kMmaBK>
__device__ __forceinline__ void copy_tile(typename Tl::Elem* dst,
                                          const typename Tl::Elem* __restrict__ src, int r0,
                                          int S) {
  constexpr int kPerPack = 16 / sizeof(typename Tl::Elem);
#pragma unroll
  for (int j = 0; j < Tl::kPacks * ROWS / kMmaThreads; ++j) {
    const int i = j * kMmaThreads + threadIdx.x;
    const int r = i / Tl::kPacks, c = kPerPack * (i % Tl::kPacks);
    const bool ok = r0 + r < S;
    cp_async16(dst + r * Tl::kStride + c,
               src + (ok ? (size_t)(r0 + r) * Tl::kCols + c : 0), ok ? 16 : 0);
  }
}

// The online softmax of one tile for a thread's rows r (e = 0, 1) and r + 8
// (e = 2, 3): s[j][e] holds the logits of keys 8 j + 2 t + (e & 1), t =
// lane % 4, and becomes their f32 probability; m (in units of log2 e /
// sqrt(D), the scale folded into one fmaf) and this thread's share of l are
// updated, and alpha is what the row's earlier sums must be scaled by.
__device__ __forceinline__ void online_softmax(float (&s)[kKeyFrags][4], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2],
                                               float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = s[0][2 * r];
#pragma unroll
    for (int j = 0; j < kKeyFrags; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m[r], mx * scale_log2);
    alpha[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeyFrags; ++j) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[j][e] = exp2_approx(fmaf(s[j][e], scale_log2, -m_new));
        sum += s[j][e];
      }
    }
    l[r] = fmaf(alpha[r], l[r], sum);
  }
}

template <int D, bool kLse = false>
__global__ void __launch_bounds__(kMmaThreads) flash_attention_bf16(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, uint16_t* __restrict__ out, int Hq, int Hkv, int S,
    float scale_log2, float* __restrict__ lse) {
  using Tl = Bf16Tile<D>;
  extern __shared__ __align__(16) uint16_t staged[];  // kStages x (K tile, V tile)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kMmaBQ;  // the longest rows first
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (Hq / Hkv);
  const size_t q_head = ((size_t)b * Hq + h) * S * D;
  const uint16_t* kh = k + ((size_t)b * Hkv + hk) * S * D;
  const uint16_t* vh = v + ((size_t)b * Hkv + hk) * S * D;
  const int n_tiles = (min(q0 + kMmaBQ, S) - 1) / kMmaBK + 1;  // none wholly above the diagonal
  const int n_unmasked = q0 / kMmaBK;  // tiles whose every key precedes every row

  // Q (in the last stage) and the first kStages - 1 KV tiles, a copy group
  // each.
  uint16_t* qs = staged + 2 * (kStages - 1) * Tl::kElems;
  copy_tile<Tl, kMmaBQ>(qs, q + q_head, q0, S);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      copy_tile<Tl>(staged + 2 * t * Tl::kElems, kh, t * kMmaBK, S);
      copy_tile<Tl>(staged + (2 * t + 1) * Tl::kElems, vh, t * kMmaBK, S);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  unsigned qf[Tl::kKSteps][4];  // A fragments of the warp's 16 rows
#pragma unroll
  for (int ks = 0; ks < Tl::kKSteps; ++ks)
    ldmatrix_x4(qf[ks], smem_addr(qs + (16 * warp + (lane & 15)) * Tl::kStride + 16 * ks +
                                  8 * (lane >> 4)));

  float o[Tl::kDFrags][4], m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < Tl::kDFrags; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // ldmatrix lane offsets: K (keys on N): key lane % 8 + 8 (lane / 16), column
  // 8 ((lane / 8) % 2); V (keys on K, transposed): key lane % 16, column 8 (lane / 16).
  const int k_lane = ((lane & 7) + 8 * (lane >> 4)) * Tl::kStride + 8 * ((lane >> 3) & 1);
  const int v_lane = (lane & 15) * Tl::kStride + 8 * (lane >> 4);
  const int row0 = q0 + 16 * warp + (lane >> 2);  // rows row0 and row0 + 8

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1's stage (or Q)
    if (t + kStages - 1 < n_tiles) {
      const int st = (t + kStages - 1) % kStages;
      copy_tile<Tl>(staged + 2 * st * Tl::kElems, kh, (t + kStages - 1) * kMmaBK, S);
      copy_tile<Tl>(staged + (2 * st + 1) * Tl::kElems, vh, (t + kStages - 1) * kMmaBK, S);
    }
    cp_async_commit();
    const unsigned ks_addr = smem_addr(staged + 2 * (t % kStages) * Tl::kElems + k_lane);
    const unsigned vs_addr = smem_addr(staged + (2 * (t % kStages) + 1) * Tl::kElems + v_lane);

    float s[kKeyFrags][4];
#pragma unroll
    for (int j = 0; j < kKeyFrags; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < Tl::kKSteps; ++ks) {
#pragma unroll
      for (int j = 0; j < kKeyFrags; j += 2) {
        unsigned kb[4];  // b0, b1 of key fragments j and j + 1
        ldmatrix_x4(kb, ks_addr + 2 * (8 * j * Tl::kStride + 16 * ks));
        const unsigned b0[2] = {kb[0], kb[1]}, b1[2] = {kb[2], kb[3]};
        mma_bf16(s[j], qf[ks], b0);
        mma_bf16(s[j + 1], qf[ks], b1);
      }
    }
    if (t >= n_unmasked) {  // a tile across the diagonal: keys past the row are masked
#pragma unroll
      for (int j = 0; j < kKeyFrags; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t * kMmaBK + 8 * j + 2 * (lane & 3) + (e & 1) > row0 + 8 * (e >> 1))
            s[j][e] = kMasked;
    }

    float alpha[2];
    online_softmax(s, m, l, alpha, scale_log2);
#pragma unroll
    for (int j = 0; j < Tl::kDFrags; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[j][e] *= alpha[e >> 1];

#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      // P of keys 16 kk .. 16 kk + 15 as two A fragments, hi and lo: rows
      // r, r + 8 of key fragment 2 kk, then of 2 kk + 1.
      unsigned hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_bf16(s[2 * kk + (i >> 1)][2 * (i & 1)], s[2 * kk + (i >> 1)][2 * (i & 1) + 1],
                   hi[i], lo[i]);
#pragma unroll
      for (int j = 0; j < Tl::kDFrags; j += 2) {
        unsigned vb[4];  // b0, b1 of O's fragments j and j + 1
        ldmatrix_x4_trans(vb, vs_addr + 2 * (16 * kk * Tl::kStride + 8 * j));
        const unsigned b0[2] = {vb[0], vb[1]}, b1[2] = {vb[2], vb[3]};
        mma_bf16(o[j], lo, b0);
        mma_bf16(o[j + 1], lo, b1);
        mma_bf16(o[j], hi, b0);
        mma_bf16(o[j + 1], hi, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    if (kLse && (lane & 3) == 0) store_lse(lse, q_head / D + row, m[r], l[r]);
    const float denom = fmaxf(l[r], 1e-30f);
    unsigned* dst = reinterpret_cast<unsigned*>(out + q_head + (size_t)row * D + 2 * (lane & 3));
#pragma unroll
    for (int j = 0; j < Tl::kDFrags; ++j)
      dst[4 * j] = pack_bf16(o[j][2 * r] / denom, o[j][2 * r + 1] / denom);
  }
}

// x (N registers of f32) split in place into tf32 hi (x's top 19 bits) and
// lo (the remainder, exact in f32, cut to tf32): hi + lo is x to ~2^-22.
template <int N>
__device__ __forceinline__ void split_tf32(unsigned (&hi)[N], unsigned (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float x = __uint_as_float(hi[i]);
    hi[i] &= kTf32Bits;
    lo[i] = __float_as_uint(x - __uint_as_float(hi[i])) & kTf32Bits;
  }
}

template <int D, bool kLse = false>
__global__ void __launch_bounds__(kMmaThreads) flash_attention_tf32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int Hq, int Hkv, int S, float scale_log2,
    float* __restrict__ lse) {
  using Tl = Tf32Tile<D>;
  extern __shared__ __align__(16) float staged_f32[];  // kStages x (K tile, V tile), then Q
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kMmaBQ;  // the longest rows first
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (Hq / Hkv);
  const size_t q_head = ((size_t)b * Hq + h) * S * D;
  const float* kh = k + ((size_t)b * Hkv + hk) * S * D;
  const float* vh = v + ((size_t)b * Hkv + hk) * S * D;
  const int n_tiles = (min(q0 + kMmaBQ, S) - 1) / kMmaBK + 1;  // none wholly above the diagonal
  const int n_unmasked = q0 / kMmaBK;  // tiles whose every key precedes every row

  // Q and the first kStages - 1 KV tiles, a copy group each (Q in the first).
  float* qs = staged_f32 + 2 * (Tl::kQRegs ? kStages - 1 : kStages) * Tl::kElems;
  copy_tile<Tl, kMmaBQ>(qs, q + q_head, q0, S);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      copy_tile<Tl>(staged_f32 + 2 * t * Tl::kElems, kh, t * kMmaBK, S);
      copy_tile<Tl>(staged_f32 + (2 * t + 1) * Tl::kElems, vh, t * kMmaBK, S);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  // ldmatrix lane offsets: Q (rows on M) row lane % 16, column 4 (lane / 16);
  // K (keys on N) key lane % 8 + 8 (lane / 16), column 4 ((lane / 8) % 2).
  // V by 16-byte loads: key 2 (lane % 4), column 4 (lane / 4).
  const unsigned q_addr =
      smem_addr(qs + (16 * warp + (lane & 15)) * Tl::kStride + 4 * (lane >> 4));
  const int k_lane = ((lane & 7) + 8 * (lane >> 4)) * Tl::kStride + 4 * ((lane >> 3) & 1);
  const int v_lane = 2 * (lane & 3) * Tl::kStride + 4 * (lane >> 2);
  const int row0 = q0 + 16 * warp + (lane >> 2);  // rows row0 and row0 + 8
  unsigned qf_hi[Tl::kQRegs ? Tl::kKSteps : 1][4], qf_lo[Tl::kQRegs ? Tl::kKSteps : 1][4];
  if constexpr (Tl::kQRegs) {  // Q's A fragments, split once
#pragma unroll
    for (int kq = 0; kq < Tl::kKSteps; ++kq) {
      ldmatrix_x4(qf_hi[kq], q_addr + 4 * 8 * kq);
      split_tf32(qf_hi[kq], qf_lo[kq]);
    }
  }

  float o[Tl::kDFrags][4], m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < Tl::kDFrags; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1's stage (or Q)
    if (t + kStages - 1 < n_tiles) {
      const int st = (t + kStages - 1) % kStages;
      copy_tile<Tl>(staged_f32 + 2 * st * Tl::kElems, kh, (t + kStages - 1) * kMmaBK, S);
      copy_tile<Tl>(staged_f32 + (2 * st + 1) * Tl::kElems, vh, (t + kStages - 1) * kMmaBK, S);
    }
    cp_async_commit();
    const unsigned ks_addr = smem_addr(staged_f32 + 2 * (t % kStages) * Tl::kElems + k_lane);
    const float* vs = staged_f32 + (2 * (t % kStages) + 1) * Tl::kElems + v_lane;

    float s[kKeyFrags][4];
#pragma unroll
    for (int j = 0; j < kKeyFrags; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < Tl::kKSteps; ++ks) {
      unsigned q_hi[4], q_lo[4];  // Q's A fragment of the k-step
      if constexpr (Tl::kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) q_hi[i] = qf_hi[ks][i], q_lo[i] = qf_lo[ks][i];
      } else {
        ldmatrix_x4(q_hi, q_addr + 4 * 8 * ks);
        split_tf32(q_hi, q_lo);
      }
#pragma unroll
      for (int j = 0; j < kKeyFrags; j += 2) {
        unsigned kb[4], kl[4];  // b0, b1 of key fragments j and j + 1: hi, then lo
        ldmatrix_x4(kb, ks_addr + 4 * (8 * j * Tl::kStride + 8 * ks));
        split_tf32(kb, kl);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          mma_tf32(s[j + u], q_hi, kl[2 * u], kl[2 * u + 1]);  // q hi x k lo
          mma_tf32(s[j + u], q_lo, kb[2 * u], kb[2 * u + 1]);  // q lo x k hi
          mma_tf32(s[j + u], q_hi, kb[2 * u], kb[2 * u + 1]);  // q hi x k hi
        }
      }
    }
    if (t >= n_unmasked) {  // a tile across the diagonal: keys past the row are masked
#pragma unroll
      for (int j = 0; j < kKeyFrags; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t * kMmaBK + 8 * j + 2 * (lane & 3) + (e & 1) > row0 + 8 * (e >> 1))
            s[j][e] = kMasked;
    }

    float alpha[2];
    online_softmax(s, m, l, alpha, scale_log2);
    float pv[Tl::kDFrags][4];  // with the fold: this tile's P V
    float(&acc)[Tl::kDFrags][4] = Tl::kFold ? pv : o;
#pragma unroll
    for (int j = 0; j < Tl::kDFrags; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (Tl::kFold) pv[j][e] = 0.f;
        else o[j][e] *= alpha[e >> 1];
      }

#pragma unroll
    for (int j = 0; j < kKeyFrags; ++j) {
      // P of keys 8 j .. 8 j + 7 as an A fragment: k-column t is key 2t,
      // t + 4 is key 2t + 1.
      unsigned p_hi[4] = {__float_as_uint(s[j][0]), __float_as_uint(s[j][2]),
                          __float_as_uint(s[j][1]), __float_as_uint(s[j][3])};
      unsigned p_lo[4];
      split_tf32(p_hi, p_lo);
#pragma unroll
      for (int c = 0; c < Tl::kDGroups; ++c) {
        // b0 (key 2t) and b1 (key 2t + 1) of O's fragments 4 c .. 4 c + 3
        const float4 x0 = *reinterpret_cast<const float4*>(vs + 8 * j * Tl::kStride + 32 * c);
        const float4 x1 =
            *reinterpret_cast<const float4*>(vs + (8 * j + 1) * Tl::kStride + 32 * c);
        unsigned v0[4] = {__float_as_uint(x0.x), __float_as_uint(x0.y), __float_as_uint(x0.z),
                          __float_as_uint(x0.w)};
        unsigned v1[4] = {__float_as_uint(x1.x), __float_as_uint(x1.y), __float_as_uint(x1.z),
                          __float_as_uint(x1.w)};
        unsigned l0[4], l1[4];
        split_tf32(v0, l0);
        split_tf32(v1, l1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_tf32(acc[4 * c + i], p_hi, l0[i], l1[i]);  // p hi x v lo
          mma_tf32(acc[4 * c + i], p_lo, v0[i], v1[i]);  // p lo x v hi
          mma_tf32(acc[4 * c + i], p_hi, v0[i], v1[i]);  // p hi x v hi
        }
      }
    }
    if (Tl::kFold) {
#pragma unroll
      for (int j = 0; j < Tl::kDFrags; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = fmaf(o[j][e], alpha[e >> 1], pv[j][e]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    if (kLse && (lane & 3) == 0) store_lse(lse, q_head / D + row, m[r], l[r]);
    const float denom = fmaxf(l[r], 1e-30f);
    // columns 32 c + 8 t + 4 hh + i (t = lane % 4) are element 2 r + hh of
    // O's fragment 4 c + i
    float* dst = out + q_head + (size_t)row * D + 8 * (lane & 3);
#pragma unroll
    for (int c = 0; c < Tl::kDGroups; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float4*>(dst + 32 * c + 4 * hh) =
            make_float4(o[4 * c][2 * r + hh] / denom, o[4 * c + 1][2 * r + hh] / denom,
                        o[4 * c + 2][2 * r + hh] / denom, o[4 * c + 3][2 * r + hh] / denom);
  }
}

template <int D, bool kLse>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                        int Hq, int Hkv, int S, cudaStream_t stream) {
  constexpr size_t smem = Bf16Tile<D>::kSmem;
  auto kernel = flash_attention_bf16<D, kLse>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, (S + kMmaBQ - 1) / kMmaBQ);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), Hq, Hkv, S,
      (float)(1.4426950408889634 / sqrt((double)D)), lse);
  return cudaGetLastError();
}

template <int D, bool kLse>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                        int Hq, int Hkv, int S, cudaStream_t stream) {
  constexpr size_t smem = Tf32Tile<D>::kSmem;
  auto kernel = flash_attention_tf32<D, kLse>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, (S + kMmaBQ - 1) / kMmaBQ);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Hq, Hkv, S, (float)(1.4426950408889634 / sqrt((double)D)),
      lse);
  return cudaGetLastError();
}

template <bool kLse>
cudaError_t launch_d(int dtype, int D, const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int Hq, int Hkv, int S, cudaStream_t stream) {
  switch (dtype * 1000 + D) {
    case 32: return launch_tf32<32, kLse>(q, k, v, out, lse, B, Hq, Hkv, S, stream);
    case 64: return launch_tf32<64, kLse>(q, k, v, out, lse, B, Hq, Hkv, S, stream);
    case 96: return launch_tf32<96, kLse>(q, k, v, out, lse, B, Hq, Hkv, S, stream);
    case 128: return launch_tf32<128, kLse>(q, k, v, out, lse, B, Hq, Hkv, S, stream);
    case 1032: return launch_bf16<32, kLse>(q, k, v, out, lse, B, Hq, Hkv, S, stream);
    case 1064: return launch_bf16<64, kLse>(q, k, v, out, lse, B, Hq, Hkv, S, stream);
    case 1096: return launch_bf16<96, kLse>(q, k, v, out, lse, B, Hq, Hkv, S, stream);
    case 1128: return launch_bf16<128, kLse>(q, k, v, out, lse, B, Hq, Hkv, S, stream);
    default: return cudaErrorInvalidValue;
  }
}

int check_args(int dtype, const void* q, const void* k, const void* v, const void* out, int B,
               int Hq, int Hkv, int S) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || Hq % Hkv != 0 || B > 65535 ||
      (S + kMmaBQ - 1) / kMmaBQ > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

}  // namespace

extern "C" {

// dtype 0: f32, 1: bf16.  Both kernels copy 16-byte packs and write the
// output by 16-byte (f32) or 4-byte (bf16) stores: q, k, v and out must
// start on 16 bytes (the wrapper copies operands that do not).
int flash_attention_launch(int dtype, int D, const void* q, const void* k, const void* v,
                           void* out, int B, int Hq, int Hkv, int S, void* stream) {
  const int err = check_args(dtype, q, k, v, out, B, Hq, Hkv, S);
  if (err) return err;
  return (int)launch_d<false>(dtype, D, q, k, v, out, nullptr, B, Hq, Hkv, S,
                              static_cast<cudaStream_t>(stream));
}

// The same, and each row's log-sum-exp of its scaled logits into lse
// (B, Hq, S) f32: what the backward (flash_attention_bwd.cu) reads.
int flash_attention_lse_launch(int dtype, int D, const void* q, const void* k, const void* v,
                               void* out, float* lse, int B, int Hq, int Hkv, int S,
                               void* stream) {
  const int err = check_args(dtype, q, k, v, out, B, Hq, Hkv, S);
  if (err) return err;
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_d<true>(dtype, D, q, k, v, out, lse, B, Hq, Hkv, S,
                             static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
