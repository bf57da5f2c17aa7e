// Causal GQA flash attention, backward, for Hopper (sm_90a), CUDA C++ with a
// plain C interface (bound with ctypes by ../kernel.py).
//
// Replaces no TPU kernel: repro/kernels/flash_attention/kernel.py has no
// backward, and the JAX package's LM differentiates its einsum / blockwise
// attention through XLA.  The port's LM runs every layer's attention
// through K9 (flash_attention.cu), so training needs K9's gradient; this is
// it.  It recomputes the probabilities from the row log-sum-exp that the
// forward's flash_attention_lse_launch writes, so no (S, S) matrix is kept
// or stored between the passes:
//   P = exp(scale q k^T - lse), masked causal (0 past the row);
//   Delta = rowsum(dO o O) in f32;
//   dV = P^T dO,  dS = P o (dO V^T - Delta),  dQ = scale dS K,  dK = scale dS^T Q.
// q, dq, O and dO are (B, Hq, S, D); k, v, dk and dv (B, Hkv, S, D), query
// head h reading KV head h / (Hq / Hkv); lse (B, Hq, S) f32.  Every sum is
// f32 and every output is written once, in a fixed order, with no atomics:
// two launches on the same inputs give the same bits.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 and 495 TFLOP/s tf32 on the tensor
// cores, 67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s): five products of 2 D
// operations per unmasked (query, key) pair (two recompute S and dP, three
// make dV, dQ, dK), 2.5x the forward's, above the bytes (q, k, v, O, dO, lse
// read once, dq, dk, dv written once) in every case of chip_smoke.py:
//   phi3-mini-3.8b's training layer (B 4, 32 / 32 heads, D 96, S 1,024):
//     6.45e10 operations, 0.065 ms (bytes 0.046 ms);
//   deepseek-coder-33b's layer (B 1, 56 / 8 heads, D 128, S 2,048): 1.50e11,
//     0.152 ms (bytes 0.038 ms);
//   S 1,000 (B 2, 8 / 2 heads): D 32 2.56e9, 0.0026 ms; D 64 5.13e9, 0.0052 ms;
//   f32 as split TF32 (three tf32 products a product) at 495 TFLOP/s:
//     phi3-mini's layer at B 1, S 512 (4.03e9 f32 operations) 0.0244 ms
//     (bytes 0.011); S 1,000 D 32 0.0155 ms, D 64 0.0311; GQA 7 (1 KV head,
//     D 128, S 300) 0.0025 ms (bytes 0.0014).  The same products as f32 FMA
//     at 67 TFLOP/s: 0.060, 0.038, 0.077, 0.0060 ms.
//
// The bf16 kernels, and what they do about what held back their mma.sync
// predecessor (10x its bound at phi3-mini's layer, 1.55x SDPA's backward at
// deepseek's; PERF.md has the times of both):
//
// 1. Products on wgmma (m64nNk16 bf16 -> f32, ../../csrc/wgmma.cuh), one
//   warpgroup a block.  (b) owns 64 keys (M): S^T = K Q^T and dP^T = V dO^T
//   read K and V (resident for the block's life) and the streamed Q and dO
//   tiles (64 query rows) from shared memory; P^T and dS^T are formed in the
//   accumulators (masked only on the diagonal tile) and become the register
//   A operand of dV += P^T dO and dK += dS^T Q, whose B (dO, Q: stored
//   query-major) is read through an MN-major descriptor.  (c) owns 64 query
//   rows: Q and dO, resident, are taken into registers once (ldmatrix) as
//   the A operand of S = Q K^T and dP = dO V^T; dQ += dS K with K MN-major.
//   No other ldmatrix: the tensor cores read each shared operand themselves.
//   P and dS enter their products split into bf16 hi + lo (to 2^-16 of
//   each): rounded once to bf16 they move the outputs past the bf16 row rule
//   (1e-2 of a row's elements, 5e-3 of its norm) against the plain f32
//   formulas, P through dv's rows and dS through dq's, where the split keeps
//   them inside (emulated at S 1,000, D 32: tests/
//   test_torch_flash_attention.py::test_bwd_p_and_ds_need_their_low_parts).
//   So 20 D operations a pair, as before, 2x the bound's, now at wgmma's rate.
// 2. Loads by TMA: rank-3 tensor maps (D, S, heads) with the 64-byte
//   swizzle, which tiles D 32, 64, 96 and 128 (the 128-byte one does not
//   tile 96), so rows past a head's S read zeros, never the next head's.
//   One thread issues them; each stage's arrival is counted by an mbarrier
//   ("full") and its release by another ("empty": every thread arrives once
//   its products are done), with no __syncthreads in the loop.  Three stages
//   (two tiles in flight while one is used) at D <= 96; two at D 128, where
//   a block's 98 KB leaves room for two blocks an SM only so (the two then
//   keep two tiles in flight between them).
// 3. Balanced GQA: a dK / dV block walks the query heads of one slice of its
//   KV head's group, heads_per_block of them (the host's plan,
//   kernel.py::bwd_plan, which splits a group only where its longest walk
//   would exceed half a block slot's share of the work).  Split, each slice
//   writes f32 partial dK and dV to the caller's scratch, and (d) sums the
//   slices in a fixed order, applies dK's scale and rounds to bf16; one slice
//   (MHA, or enough blocks) writes bf16 outright.  At deepseek's layer: 7 x 8
//   x 32 blocks, the longest walking 32 query tiles of 64 rows (its
//   predecessor's 448 of 32).
// 4. Delta: (a), its own kernel (a few lanes a row, 16-byte loads), writes
//   (lse log2 e, Delta) pairs padded to whole 64-row tiles (zeros past S),
//   which (b) takes by one 512-byte bulk copy a stage and (c) reads once a row.
//
// The f32 kernels (flash_attention_bwd_dkdv_f32<D>, flash_attention_bwd_dq_f32
// <D>; every LM config with dtype float32 trains through them), and what they
// do about what held back their CUDA-core predecessor (12-250x its FMA bound,
// 1.6-6.5x SDPA's memory-efficient f32 backward; PERF.md):
//
// 1. Split TF32 on mma.sync m16n8k8 tf32 (HMMA on TF32 operands).  f32's 1e-4
//   row rule leaves no room for one tf32 rounding of an operand, so each f32
//   operand x is split into hi (x rounded to tf32, to nearest) and lo (x - hi,
//   exact in f32, rounded the same way), hi + lo being x to 2^-22, and each
//   of the five products keeps all three tf32 products a hi x b lo, a lo x b
//   hi, a hi x b hi (mma_x3; a lo x b lo, below 2^-22, is left out): without
//   any one lo term the emulation misses the row rule at S 1,000, D 32
//   (tests/test_torch_flash_attention.py::test_bwd_tf32_kernel_needs_each_low_part),
//   so 30 D tf32 operations a pair.  Not wgmma: it reads 32-bit operands
//   from shared memory K-major only, and dV, dK and dQ read dO, Q and K
//   MN-major as stored (a transposed copy of each), and it splits nothing
//   (a lo plane of each tile); mma.sync fragments are loaded by each thread
//   and split in registers from either layout.  S and dP take their A and B
//   fragments by ldmatrix (a tf32 m16n8k8 fragment sits at the bytes of a
//   bf16 m16n8k16 one); dV, dK and dQ take P^T, dS^T or dS from the
//   accumulators as the A operand by a permutation of the k-columns (as the
//   forward's P V) and their B rows by 16-byte loads, which permute the
//   gradient's columns.  Accuracy where dq is a small difference of
//   near-equal terms: dP's sums start from -Delta (so dP - Delta is summed by
//   the tensor cores, not rounded at dP's scale first), S's and dP's small
//   terms sum in an accumulator of their own, and each gradient's tile sum
//   starts from zero and is added in f32 (the tensor cores' running sums span
//   a tile, not a walk).
// 2. 64-row tiles (BWD_TILE) fed by a two-stage cp.async ring, the next tile
//   in flight behind the current one's products, one __syncthreads a tile;
//   staged rows D + 4 floats apart (the padding makes the eight rows of an
//   ldmatrix phase, and the four rows of a quarter warp's 16-byte loads,
//   fall on distinct banks).  Eight warps a block, one block an SM at D 96
//   and 128: (b) holds K and V, two stages of Q, dO and their pairs, and
//   the P^T exchange, 220 KB at D 128 (a 64 x 128 f32 tile is 33.8 KB with
//   its padding), and its threads take up to 251 registers.  (b): warp
//   w < 4 recomputes S^T for keys 16 w .. 16 w + 15 over the tile's 64
//   queries, forms P^T, hands it to warp w + 4 through shared memory (a
//   named barrier of the two) and sums dV; warp w + 4 recomputes dP^T,
//   forms dS^T and sums dK: one gradient a warp.  (c): warp w takes rows
//   16 (w % 4) .. + 15 and keys 32 (w / 4) .. + 31 of each key tile, and
//   the two warps of a row group add their dQ at the end.
// 3. The GQA group split over blocks by the same plan as bf16 (kernel.py::
//   bwd_plan); a split group's slices write f32 partials that (d) sums in a
//   fixed order into f32 dK and dV.
// 4. The same (lse log2 e, Delta) pairs as bf16, padded to 64-row tiles.
//
// (a) flash_attention_bwd_delta: (lse log2 e, Delta) a row, both dtypes.
// (b) flash_attention_bwd_dkdv_{bf16,f32}<D>: grid (B Hkv slices, 1, 64-key
//   tiles), the first key tiles (the longest walks) first.
// (c) flash_attention_bwd_dq_{bf16,f32}<D>: grid (B Hq, 1, 64-row tiles), the
//   longest rows first; K and V tiles stream up to the diagonal.
// (d) flash_attention_bwd_sum<Out4>: dK, dV of the slices summed (slices > 1).
// All are launched on one stream, (a) then (b), (d), (c); no atomics: two
// launches on the same inputs give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---- (a) Delta ---------------------------------------------------------------

// Lanes a row of (a): its packs rounded up to a power of two (4 to 32).
__host__ __device__ __forceinline__ int delta_lanes(int packs) {
  return packs <= 4 ? 4 : packs <= 8 ? 8 : packs <= 16 ? 16 : 32;
}

// The dot product of two 16-byte packs: 8 bf16 or 4 f32 values each.
__device__ __forceinline__ float dot16(uint4 x, uint4 y, float s, uint16_t) {
  const unsigned a[4] = {x.x, x.y, x.z, x.w}, b[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s = fmaf(__uint_as_float(a[i] << 16), __uint_as_float(b[i] << 16), s);
    s = fmaf(__uint_as_float(a[i] & 0xFFFF0000u), __uint_as_float(b[i] & 0xFFFF0000u), s);
  }
  return s;
}

__device__ __forceinline__ float dot16(uint4 x, uint4 y, float s, float) {
  s = fmaf(__uint_as_float(x.x), __uint_as_float(y.x), s);
  s = fmaf(__uint_as_float(x.y), __uint_as_float(y.y), s);
  s = fmaf(__uint_as_float(x.z), __uint_as_float(y.z), s);
  return fmaf(__uint_as_float(x.w), __uint_as_float(y.w), s);
}

// G lanes a row (the row's 16-byte packs rounded up to a power of two),
// over rows = B Hq S_pad rows: a warp reads whole rows in order.  (lse log2
// e, Delta) into stats as (B, Hq, S_pad, 2), zeros in the rows past S.
template <typename T>
__global__ void __launch_bounds__(256) flash_attention_bwd_delta(
    const T* __restrict__ out, const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ stats, long rows, int S, int S_pad, int D) {
  const int packs = D * (int)sizeof(T) / 16, G = delta_lanes(packs), j = threadIdx.x % G;
  const long row = ((long)blockIdx.x * 256 + threadIdx.x) / G;
  const long bh = row / S_pad;
  const int r = (int)(row % S_pad);
  float s = 0.f;
  if (row < rows && r < S && j < packs)
    s = dot16(reinterpret_cast<const uint4*>(out + (bh * S + r) * D)[j],
              reinterpret_cast<const uint4*>(dout + (bh * S + r) * D)[j], 0.f, T());
  for (int off = G / 2; off; off >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
  const float delta = s;
  if (row >= rows || j != 0) return;
  stats[2 * row] = r < S ? lse[bh * S + r] * kLog2e : 0.f;
  stats[2 * row + 1] = delta;
}

// ---- the bf16 blocks (wgmma) ------------------------------------------------------

// Switches of the copies that chip_smoke.py --ablate times: both true here.
constexpr bool kLoads = true;     // stream the tiles past the first stages
constexpr bool kProducts = true;  // the products and the probabilities

constexpr int kWg = 128;  // threads a block: one warpgroup
constexpr int kT = 64;    // rows a tile: (b)'s keys and query stages, (c)'s rows and key stages

template <int D>
struct Tiles {
  static constexpr int kBytes = kT * D * 2;            // one swizzled 64-row tile
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kSteps = D / 16;                // k-steps over D
  static constexpr int kBoxes = D / 32;                // TMA boxes (32 columns x 64 rows) a tile
  // Shared memory: two resident tiles, the stages' two tiles each, then
  // (b) the stages' 512-byte stats, then the mbarriers (full, empty, the
  // resident tiles'); 1,024 bytes of slack to align the start.
  static constexpr int kStats = (2 + 2 * kStages) * kBytes;
  static constexpr int kBars = kStats + 512 * kStages;
  static constexpr size_t kSmem = kBars + 8 * (2 * kStages + 1) + 1024;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// a, b as the bf16 pairs hi (each rounded to bf16) and lo (each remainder,
// rounded to bf16): hi + lo is each to 2^-16 of itself.
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi, unsigned& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xFFFF0000u));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 64 x 64 accumulator x (element i: row 16 warp + lane / 4 + 8 ((i / 2)
// % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2) as the register A operands
// of four k-steps over its columns, each split into bf16 hi + lo.
__device__ __forceinline__ void split_a(const float (&x)[32], unsigned (&hi)[4][4],
                                        unsigned (&lo)[4][4]) {
#pragma unroll
  for (int kq = 0; kq < 4; ++kq)
#pragma unroll
    for (int r = 0; r < 4; ++r) split_bf16(x[8 * kq + 2 * r], x[8 * kq + 2 * r + 1], hi[kq][r], lo[kq][r]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// The kernels' operands: q, k, v and dout as tensor maps (Maps), the
// scratch and outputs, the shapes.
struct Bf16Args {
  const float* stats;  // (B, Hq, S_pad, 2): (lse log2 e, Delta)
  uint16_t* dq;
  uint16_t* dk;
  uint16_t* dv;
  float* partial;  // (2, B, Hkv, slices, S, D), with slices > 1
  int B, Hq, Hkv, S, S_pad, heads_per_block, slices;
  float scale, scale_log2;
};

// (b) dK and dV of the 64-key tile kt of KV head hk of batch b, over the
// query heads of one slice of its group.
template <int D>
__device__ __forceinline__ void dkdv_block(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                           const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                                           uint8_t* smem, const Bf16Args& a, int hk, int slice,
                                           int b, int kt) {
  using Tl = Tiles<D>;
  constexpr int kStages = Tl::kStages;
  const unsigned base = smem_addr(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tl::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Hq = a.Hq, Hkv = a.Hkv, S = a.S, S_pad = a.S_pad;
  const int heads_per_block = a.heads_per_block, slices = a.slices, group = Hq / Hkv;
  const float scale = a.scale, scale_log2 = a.scale_log2;
  const float* stats = a.stats;
  const int k0 = kt * kT;
  const int h0 = hk * group + slice * heads_per_block;
  const int n_qt = S_pad / kT - kt;  // query tiles from the diagonal down
  const int n_iter = min(heads_per_block, group - slice * heads_per_block) * n_qt;

  auto issue = [&](int it) {  // iteration it's Q, dO and stats into stage it % kStages
    const int s = it % kStages, bh = b * Hq + h0 + it / n_qt, q0 = (kt + it % n_qt) * kT;
    mbar_expect_tx(&full[s], 2 * Tl::kBytes + 512);
#pragma unroll
    for (int c = 0; c < Tl::kBoxes; ++c) {
      tma_load_3d(smem + (2 + s) * Tl::kBytes + c * 4096, &tm_q, &full[s], 32 * c, q0, bh);
      tma_load_3d(smem + (2 + kStages + s) * Tl::kBytes + c * 4096, &tm_do, &full[s], 32 * c, q0,
                  bh);
    }
    bulk_load(smem + Tl::kStats + 512 * s, stats + ((size_t)bh * S_pad + q0) * 2, 512, &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWg);
    }
    mbar_init(kv_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * Tl::kBytes);
#pragma unroll
    for (int c = 0; c < Tl::kBoxes; ++c) {
      tma_load_3d(smem + c * 4096, &tm_k, kv_bar, 32 * c, k0, b * Hkv + hk);
      tma_load_3d(smem + Tl::kBytes + c * 4096, &tm_v, kv_bar, 32 * c, k0, b * Hkv + hk);
    }
    for (int it = 0; it < min(kStages, n_iter); ++it) issue(it);
  }
  __syncwarp();

  float dva[D / 2], dka[D / 2];
  zero(dva);
  zero(dka);
  const int g = lane >> 2, t = lane & 3;
  const int kr = 16 * warp + g;  // this thread's keys k0 + kr and k0 + kr + 8
  const unsigned ks = base, vs = base + Tl::kBytes;
  mbar_wait(kv_bar, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    const unsigned phase = (it / kStages) & 1;
    const unsigned qs = base + (2 + s) * Tl::kBytes, dos = base + (2 + kStages + s) * Tl::kBytes;
    const float* st = reinterpret_cast<const float*>(smem + Tl::kStats + 512 * s);
    if (kLoads || it < kStages) mbar_wait(&full[s], phase);
    if (kProducts) {
      // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 queries, in two groups
      float sT[32], dpT[32];
      zero(sT);
      zero(dpT);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Tl::kSteps; ++kk)
        wgmma_ss_n64(sT, desc_k<kT>(ks, kk), desc_k<kT>(qs, kk));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < Tl::kSteps; ++kk)
        wgmma_ss_n64(dpT, desc_k<kT>(vs, kk), desc_k<kT>(dos, kk));
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(sT);
      // P^T in place: element 4 j + e is key k0 + kr + 8 (e / 2), query
      // q0 + 8 j + 2 t + e % 2; masked on the diagonal tile alone (rows
      // past S read zero Q, dO and stats, so they add nothing).
      const bool diag = it % n_qt == 0;
      float4 qst[8];  // (lse log2 e, Delta) of queries 8 j + 2 t and 8 j + 2 t + 1
#pragma unroll
      for (int j = 0; j < 8; ++j) qst[j] = *reinterpret_cast<const float4*>(st + 2 * (8 * j + 2 * t));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_approx(fmaf(sT[4 * j + e], scale_log2, (e & 1) ? -qst[j].z : -qst[j].x));
          if (diag && kr + 8 * (e >> 1) > 8 * j + 2 * t + (e & 1)) p = 0.f;
          sT[4 * j + e] = p;
        }
      wgmma_wait<0>();
      reg_fence(dpT);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpT[4 * j + e] = sT[4 * j + e] * (dpT[4 * j + e] - ((e & 1) ? qst[j].w : qst[j].y));
      // dV += P^T dO, then dK += dS^T Q: k = the tile's 64 queries, four k-steps
      unsigned ahi[4][4], alo[4][4], bhi[4][4], blo[4][4];
      split_a(sT, ahi, alo);
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        wgmma_rs<D>(dva, ahi[kq], desc_mn<kT>(dos, kq));
        wgmma_rs<D>(dva, alo[kq], desc_mn<kT>(dos, kq));
      }
      wgmma_commit();
      split_a(dpT, bhi, blo);
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        wgmma_rs<D>(dka, bhi[kq], desc_mn<kT>(qs, kq));
        wgmma_rs<D>(dka, blo[kq], desc_mn<kT>(qs, kq));
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dva);
      reg_fence(dka);
      reg_fence(ahi);
      reg_fence(alo);
      reg_fence(bhi);
      reg_fence(blo);
    }
    mbar_arrive(&empty[s]);
    if (kLoads && tid == 0 && it + kStages < n_iter) {
      mbar_wait(&empty[s], phase);  // every thread is done with the stage
      issue(it + kStages);
    }
    __syncwarp();
  }

  // Element 4 j + 2 r + c of dK / dV is key k0 + kr + 8 r, column 8 j + 2 t + c.
  const size_t bkv = (size_t)b * Hkv + hk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + 8 * r;
    if (key >= S) continue;
    if (slices == 1) {
      unsigned* dkr = reinterpret_cast<unsigned*>(a.dk + (bkv * S + key) * D + 2 * t);
      unsigned* dvr = reinterpret_cast<unsigned*>(a.dv + (bkv * S + key) * D + 2 * t);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        dkr[4 * j] = pack_bf16(scale * dka[4 * j + 2 * r], scale * dka[4 * j + 2 * r + 1]);
        dvr[4 * j] = pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    } else {  // partial (2, B, Hkv, slices, S, D): dK unscaled, then dV
      const size_t off = ((bkv * slices + slice) * S + key) * D + 2 * t;
      float2* pk = reinterpret_cast<float2*>(a.partial + off);
      float2* pv = reinterpret_cast<float2*>(a.partial + (size_t)a.B * Hkv * slices * S * D + off);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        pk[4 * j] = make_float2(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
        pv[4 * j] = make_float2(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

// (c) dQ of the 64-row tile qt of query head h of batch b.
template <int D>
__device__ __forceinline__ void dq_block(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                         const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                                         uint8_t* smem, const Bf16Args& a, int h, int b, int qt) {
  using Tl = Tiles<D>;
  constexpr int kStages = Tl::kStages;
  const unsigned base = smem_addr(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tl::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = a.S, S_pad = a.S_pad, q0 = qt * kT;
  const float scale = a.scale, scale_log2 = a.scale_log2;
  const float* stats = a.stats;
  const int bh = b * a.Hq + h, bkv = b * a.Hkv + h / (a.Hq / a.Hkv);
  const int n_tiles = qt + 1;  // key tiles up to the diagonal

  auto issue = [&](int t) {  // key tile t's K and V into stage t % kStages
    const int s = t % kStages;
    mbar_expect_tx(&full[s], 2 * Tl::kBytes);
#pragma unroll
    for (int c = 0; c < Tl::kBoxes; ++c) {
      tma_load_3d(smem + (2 + s) * Tl::kBytes + c * 4096, &tm_k, &full[s], 32 * c, t * kT, bkv);
      tma_load_3d(smem + (2 + kStages + s) * Tl::kBytes + c * 4096, &tm_v, &full[s], 32 * c,
                  t * kT, bkv);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWg);
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, 2 * Tl::kBytes);
#pragma unroll
    for (int c = 0; c < Tl::kBoxes; ++c) {
      tma_load_3d(smem + c * 4096, &tm_q, q_bar, 32 * c, q0, bh);
      tma_load_3d(smem + Tl::kBytes + c * 4096, &tm_do, q_bar, 32 * c, q0, bh);
    }
    for (int t = 0; t < min(kStages, n_tiles); ++t) issue(t);
  }
  __syncwarp();

  const int g = lane >> 2, tq = lane & 3;
  const int rr = 16 * warp + g;  // this thread's rows q0 + rr and q0 + rr + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // past S: zeros (the padded rows of stats)
    const float2 x = *reinterpret_cast<const float2*>(stats + ((size_t)bh * S_pad + q0 + rr + 8 * r) * 2);
    lse2[r] = x.x;
    dl[r] = x.y;
  }
  float dqa[D / 2];
  zero(dqa);
  mbar_wait(q_bar, 0);
  // Q and dO, resident for the block's life, as the register A operands of S
  // and dP: the tensor cores then read only K and V from shared memory.
  unsigned qa[Tl::kSteps][4], oa[Tl::kSteps][4];
#pragma unroll
  for (int kk = 0; kk < Tl::kSteps; ++kk) {
    ldmatrix_a<kT>(qa[kk], base, warp, lane, kk);
    ldmatrix_a<kT>(oa[kk], base + Tl::kBytes, warp, lane, kk);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const unsigned phase = (t / kStages) & 1;
    const unsigned kts = base + (2 + s) * Tl::kBytes, vts = base + (2 + kStages + s) * Tl::kBytes;
    if (kLoads || t < kStages) mbar_wait(&full[s], phase);
    if (kProducts) {
      float sa[32], dp[32];  // S = Q K^T and dP = dO V^T, 64 rows x 64 keys
      zero(sa);
      zero(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Tl::kSteps; ++kk) wgmma_rs<kT, 0>(sa, qa[kk], desc_k<kT>(kts, kk));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < Tl::kSteps; ++kk) wgmma_rs<kT, 0>(dp, oa[kk], desc_k<kT>(vts, kk));
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(sa);
      // P in place: element 4 j + e is row q0 + rr + 8 (e / 2), key
      // t kT + 8 j + 2 tq + e % 2; masked on the diagonal tile alone.
      const bool diag = t == qt;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_approx(fmaf(sa[4 * j + e], scale_log2, -lse2[e >> 1]));
          if (diag && 8 * j + 2 * tq + (e & 1) > rr + 8 * (e >> 1)) p = 0.f;
          sa[4 * j + e] = p;
        }
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = sa[i] * (dp[i] - dl[(i >> 1) & 1]);
      // dQ += dS K: k = the tile's 64 keys, four k-steps
      unsigned ahi[4][4], alo[4][4];
      split_a(dp, ahi, alo);
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        wgmma_rs<D>(dqa, ahi[kq], desc_mn<kT>(kts, kq));
        wgmma_rs<D>(dqa, alo[kq], desc_mn<kT>(kts, kq));
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dqa);
      reg_fence(ahi);
      reg_fence(alo);
      reg_fence(qa);
      reg_fence(oa);
    }
    mbar_arrive(&empty[s]);
    if (kLoads && tid == 0 && t + kStages < n_tiles) {
      mbar_wait(&empty[s], phase);  // every thread is done with the stage
      issue(t + kStages);
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rr + 8 * r;
    if (row >= S) continue;
    unsigned* dst = reinterpret_cast<unsigned*>(a.dq + ((size_t)bh * S + row) * D + 2 * tq);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      dst[4 * j] = pack_bf16(scale * dqa[4 * j + 2 * r], scale * dqa[4 * j + 2 * r + 1]);
  }
}

// (b): grid (B Hkv slices, 1, S_pad / 64), the first key tiles (the longest
// walks) first.
template <int D>
__global__ void __launch_bounds__(kWg, 2) flash_attention_bwd_dkdv_bf16(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ Bf16Args a) {
  extern __shared__ uint8_t smem_raw[];
  const int x = blockIdx.x;
  dkdv_block<D>(tm_q, tm_k, tm_v, tm_do, align1024(smem_raw), a, (x / a.slices) % a.Hkv,
                x % a.slices, x / (a.slices * a.Hkv), blockIdx.z);
}

// (c): grid (B Hq, 1, S_pad / 64), the longest rows first.
template <int D>
__global__ void __launch_bounds__(kWg, 2) flash_attention_bwd_dq_bf16(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ Bf16Args a) {
  extern __shared__ uint8_t smem_raw[];
  dq_block<D>(tm_q, tm_k, tm_v, tm_do, align1024(smem_raw), a, blockIdx.x % a.Hq,
              blockIdx.x / a.Hq, a.S_pad / kT - 1 - blockIdx.z);
}

// Four sums (scaled by s) as four outputs: bf16 (two pairs) or f32.
__device__ __forceinline__ void store4(uint2* dst, float4 x, float s) {
  *dst = make_uint2(pack_bf16(s * x.x, s * x.y), pack_bf16(s * x.z, s * x.w));
}
__device__ __forceinline__ void store4(float4* dst, float4 x, float s) {
  *dst = make_float4(s * x.x, s * x.y, s * x.z, s * x.w);
}

// (d) dK and dV from the slices' partials (2, B Hkv, slices, S D): each
// output four elements a thread, the slices summed in order, dK scaled;
// Out4 is four outputs of the dtype (uint2: bf16, float4: f32).
template <typename Out4>
__global__ void __launch_bounds__(256) flash_attention_bwd_sum(
    const float4* __restrict__ partial, Out4* __restrict__ dk, Out4* __restrict__ dv, long n4,
    long plane4, int slices, float scale) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4* pk = partial + (i / plane4) * slices * plane4 + i % plane4;
  const float4* pv = pk + n4 * slices;
  float4 a = pk[0], c = pv[0];
  for (int sl = 1; sl < slices; ++sl) {
    const float4 x = pk[sl * plane4], y = pv[sl * plane4];
    a = make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
    c = make_float4(c.x + y.x, c.y + y.y, c.z + y.z, c.w + y.w);
  }
  store4(dk + i, a, scale);
  store4(dv + i, c, 1.f);
}

// The sum (d) of a split group into dk and dv of the dtype Out4 stores.
template <typename Out4>
cudaError_t launch_sum(const float* partial, void* dk, void* dv, int B, int Hkv, int S, int D,
                       int slices, float scale, cudaStream_t stream) {
  const long n4 = (long)B * Hkv * S * D / 4;
  flash_attention_bwd_sum<Out4><<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(partial), static_cast<Out4*>(dk), static_cast<Out4*>(dv), n4,
      (long)S * D / 4, slices, scale);
  return cudaGetLastError();
}

// ---- the f32 blocks (split TF32 on mma.sync) ----------------------------------

// Switches of the copies that chip_smoke.py --ablate times: both true here.
constexpr bool kF32Loads = true;     // stream the tiles past the first stages
constexpr bool kF32Products = true;  // the products and the probabilities

constexpr int kF32Warps = 8;
constexpr int kF32Threads = 32 * kF32Warps;

template <int D>
struct F32Tiles {
  static constexpr int kStride = D + 4;        // staged row stride in floats (4 D + 16 bytes)
  static constexpr int kElems = kT * kStride;  // one staged 64-row tile
  static constexpr int kStages = 2;            // one tile in flight behind the products
  static constexpr int kSteps = D / 8;         // k-steps over D
  static constexpr int kGroups = D / 32;       // 32-column groups of a gradient: four n8 fragments
  static constexpr int kPacks = D / 4;         // 16-byte packs of a row
  // (b): K and V resident, each stage's Q, dO and 64 (lse log2 e, Delta)
  // pairs, then the P^T that each key group's S warp hands its dP warp.
  static constexpr int kStageKV = 2 * kElems + 2 * kT;
  static constexpr int kXch = 4 * 32 * 32;
  static constexpr size_t kSmemKV = sizeof(float) * (2 * kElems + kStages * kStageKV + kXch);
  // (c): Q and dO resident, each stage's K and V.
  static constexpr size_t kSmemQ = sizeof(float) * (2 + 2 * kStages) * kElems;
  static_assert(kPacks * kT % kF32Threads == 0, "whole copy rounds");
  static_assert(2 * kElems * kStages >= 4 * 16 * D, "(c)'s pair sums fit in the ring");
};

// The kernels' operands, scratch and outputs (f32), and the shapes.
struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* stats;  // (B, Hq, S_pad, 2): (lse log2 e, Delta)
  float* dq;
  float* dk;
  float* dv;
  float* partial;  // (2, B, Hkv, slices, S, D), with slices > 1
  int B, Hq, Hkv, S, S_pad, heads_per_block, slices;
  float scale, scale_log2;
};

// x (N registers of f32) split in place into tf32 hi (x rounded to nearest,
// ties away from zero: 0x1000 added to the bits, the 13 low ones cleared) and
// lo (x - hi, exact in f32, rounded the same way): hi + lo is x to 2^-22.
template <int N>
__device__ __forceinline__ void split_rna(unsigned (&hi)[N], unsigned (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float x = __uint_as_float(hi[i]);
    hi[i] = (hi[i] + 0x1000u) & kTf32Bits;
    lo[i] = (__float_as_uint(x - __uint_as_float(hi[i])) + 0x1000u) & kTf32Bits;
  }
}

// One k-step of a product a b as split TF32: small += a hi x b lo + a lo x
// b hi, big += a hi x b hi.  The recomputed S and dP keep the small terms
// in an accumulator of their own; the gradients' tile sums pass one
// accumulator as both.
__device__ __forceinline__ void mma_x3(float (&big)[4], float (&small)[4], const unsigned (&ah)[4],
                                       const unsigned (&al)[4], unsigned bh0, unsigned bh1,
                                       unsigned bl0, unsigned bl1) {
  mma_tf32(small, ah, bl0, bl1);  // a hi x b lo
  mma_tf32(small, al, bh0, bh1);  // a lo x b hi
  mma_tf32(big, ah, bh0, bh1);    // a hi x b hi
}

// Rows [r0, r0 + 64) of a head's (S, D) f32 matrix into staged rows of
// F32Tiles<D> by 16-byte cp.async; rows past S are zero-filled and read nothing.
template <int D>
__device__ __forceinline__ void copy_rows_f32(float* dst, const float* __restrict__ src, int r0,
                                              int S) {
  using Tl = F32Tiles<D>;
#pragma unroll
  for (int j = 0; j < Tl::kPacks * kT / kF32Threads; ++j) {
    const int i = j * kF32Threads + threadIdx.x;
    const int r = i / Tl::kPacks, c = 4 * (i % Tl::kPacks);
    const bool ok = r0 + r < S;
    cp_async16(dst + r * Tl::kStride + c, src + (ok ? (size_t)(r0 + r) * D + c : 0), ok ? 16 : 0);
  }
}

// The 16 x (8 NF) product of a warp's 16 staged rows of a (M) and 8 NF
// staged rows of b (N), over D, added to big (the caller's start: 0 for S,
// -Delta for dP, so that dP - Delta, small where it cancels, is summed by
// the tensor cores and not rounded at dP's scale first) and small, from
// zero (mma_x3).  Fragments by ldmatrix (a tf32 m16n8k8 fragment sits at
// the bytes of a bf16 m16n8k16 one), each split once.
template <int D, int NF>
__device__ __forceinline__ void recompute(const float* a, const float* b, int lane,
                                          float (&big)[NF][4], float (&small)[NF][4]) {
  using Tl = F32Tiles<D>;
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) small[j][e] = 0.f;
  // a (rows on M): row lane % 16, column 4 (lane / 16); b (rows on N): row
  // lane % 8 + 8 (lane / 16), column 4 ((lane / 8) % 2).
  const unsigned a_addr = smem_addr(a + (lane & 15) * Tl::kStride + 4 * (lane >> 4));
  const unsigned b_addr =
      smem_addr(b + ((lane & 7) + 8 * (lane >> 4)) * Tl::kStride + 4 * ((lane >> 3) & 1));
#pragma unroll
  for (int kk = 0; kk < Tl::kSteps; ++kk) {
    unsigned ah[4], al[4];
    ldmatrix_x4(ah, a_addr + 4 * 8 * kk);
    split_rna(ah, al);
#pragma unroll
    for (int j = 0; j < NF; j += 2) {
      unsigned bh[4], bl[4];  // b0, b1 of n8 fragments j and j + 1
      ldmatrix_x4(bh, b_addr + 4 * (8 * j * Tl::kStride + 8 * kk));
      split_rna(bh, bl);
#pragma unroll
      for (int u = 0; u < 2; ++u)
        mma_x3(big[j + u], small[j + u], ah, al, bh[2 * u], bh[2 * u + 1], bl[2 * u],
               bl[2 * u + 1]);
    }
  }
}

// acc += x rows, for a warp's 16 rows: x the 16 x (8 NF) accumulator of
// recompute (P^T, dS^T or dS), k = its 8 NF columns, and rows the 8 NF
// staged rows (of dO, Q or K) that they pair with.  x's fragment j becomes
// the A fragment of a k-step by a permutation of its columns (k-column t is
// column 2 t, t + 4 is 2 t + 1: A = {c0, c2, c1, c3}), and b0 and b1 are
// rows 2 t and 2 t + 1 of the step, read by 16-byte loads that also permute
// the gradient's columns: column n (= lane / 4) of fragment 4 c + i is
// column 32 c + 4 n + i.  Each 32-column group's sum over the 8 NF rows
// starts from zero (the tensor cores' own running sums span 3 NF products)
// and is added into acc in f32.
template <int D, int NF>
__device__ __forceinline__ void accumulate(const float (&x)[NF][4], const float* rows, int lane,
                                           float (&acc)[D / 8][4]) {
  using Tl = F32Tiles<D>;
  const float* src = rows + 2 * (lane & 3) * Tl::kStride + 4 * (lane >> 2);
#pragma unroll
  for (int c = 0; c < Tl::kGroups; ++c) {
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) part[i][0] = part[i][1] = part[i][2] = part[i][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      unsigned ah[4] = {__float_as_uint(x[j][0]), __float_as_uint(x[j][2]),
                        __float_as_uint(x[j][1]), __float_as_uint(x[j][3])};
      unsigned al[4];
      split_rna(ah, al);
      const float4 x0 = *reinterpret_cast<const float4*>(src + 8 * j * Tl::kStride + 32 * c);
      const float4 x1 = *reinterpret_cast<const float4*>(src + (8 * j + 1) * Tl::kStride + 32 * c);
      unsigned b0[4] = {__float_as_uint(x0.x), __float_as_uint(x0.y), __float_as_uint(x0.z),
                        __float_as_uint(x0.w)};
      unsigned b1[4] = {__float_as_uint(x1.x), __float_as_uint(x1.y), __float_as_uint(x1.z),
                        __float_as_uint(x1.w)};
      unsigned l0[4], l1[4];
      split_rna(b0, l0);
      split_rna(b1, l1);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_x3(part[i], part[i], ah, al, b0[i], b1[i], l0[i], l1[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * c + i][e] += part[i][e];
  }
}

// Rows row and row + 8 of a warp's gradient acc (scaled by s) into dst, a
// (rows, D) f32 matrix: columns 32 c + 8 t + 4 hh + i (t = lane % 4) are
// element 2 r + hh of fragment 4 c + i.
template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[D / 8][4], int row,
                                           int rows, int lane, float s) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= rows) continue;
    float* out = dst + (size_t)(row + 8 * r) * D + 8 * (lane & 3);
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float4*>(out + 32 * c + 4 * hh) =
            make_float4(s * acc[4 * c][2 * r + hh], s * acc[4 * c + 1][2 * r + hh],
                        s * acc[4 * c + 2][2 * r + hh], s * acc[4 * c + 3][2 * r + hh]);
  }
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// (b) f32: dK and dV of the 64-key tile kt of KV head hk of batch b, over
// the query heads of one slice of its group.  Warp w < 4 (the S warp of key
// group w: keys 16 w .. 16 w + 15) recomputes S^T = K Q^T, forms P^T and
// sums dV += P^T dO; warp w + 4 (its dP warp) recomputes dP^T = V dO^T, takes
// P^T from shared memory, forms dS^T and sums dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kF32Threads, 1) flash_attention_bwd_dkdv_f32(
    const __grid_constant__ F32Args a) {
  using Tl = F32Tiles<D>;
  extern __shared__ __align__(16) float smem_f32[];
  float* ks = smem_f32;
  float* vs = ks + Tl::kElems;
  float* ring = vs + Tl::kElems;  // stage s: Q, dO, then the 64 pairs
  float* xch = ring + Tl::kStages * Tl::kStageKV;
  const int x = blockIdx.x, kt = blockIdx.z;
  const int hk = (x / a.slices) % a.Hkv, slice = x % a.slices, b = x / (a.slices * a.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, kg = warp & 3;
  const bool dp_warp = warp >= 4;
  const int group = a.Hq / a.Hkv, S = a.S, S_pad = a.S_pad, k0 = kt * kT;
  const int h0 = hk * group + slice * a.heads_per_block;
  const int n_qt = S_pad / kT - kt;  // query tiles from the diagonal down
  const int n_iter = min(a.heads_per_block, group - slice * a.heads_per_block) * n_qt;
  const size_t bkv = (size_t)b * a.Hkv + hk;

  auto issue = [&](int it) {  // iteration it's Q, dO and pairs into stage it % kStages
    float* st = ring + (it % Tl::kStages) * Tl::kStageKV;
    const size_t bh = (size_t)b * a.Hq + h0 + it / n_qt;
    const int q0 = (kt + it % n_qt) * kT;
    copy_rows_f32<D>(st, a.q + bh * S * D, q0, S);
    copy_rows_f32<D>(st + Tl::kElems, a.dout + bh * S * D, q0, S);
    if (tid < 2 * kT / 4)
      cp_async16(st + 2 * Tl::kElems + 4 * tid, a.stats + (bh * S_pad + q0) * 2 + 4 * tid, 16);
  };
  copy_rows_f32<D>(ks, a.k + bkv * S * D, k0, S);
  copy_rows_f32<D>(vs, a.v + bkv * S * D, k0, S);
  issue(0);
  cp_async_commit();

  float acc[D / 8][4];  // dV (S warps) or dK unscaled (dP warps)
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int g = lane >> 2, t = lane & 3;
  const int kr = 16 * kg + g;  // this thread's keys k0 + kr and k0 + kr + 8
  float* mine = xch + kg * 32 * 32 + lane;

  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // stage it is in; every warp is done with stage it - 1 and the exchange
    if ((kF32Loads || it + 1 < Tl::kStages) && it + 1 < n_iter) issue(it + 1);
    cp_async_commit();
    if (!kF32Products) continue;
    const float* qs = ring + (it % Tl::kStages) * Tl::kStageKV;
    const float* dos = qs + Tl::kElems;
    const float* st = qs + 2 * Tl::kElems;
    // Element (j, e) is key k0 + kr + 8 (e / 2), query q0 + 8 j + 2 t + e % 2;
    // the float4 at st + 2 (8 j + 2 t) holds (lse log2 e, Delta) of queries
    // 8 j + 2 t and 8 j + 2 t + 1 (read where used: held across the
    // products, they would cost 32 registers).
    float big[8][4], small[8][4];  // S^T, or dP^T - Delta: 16 keys x the tile's 64 queries
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 qst = *reinterpret_cast<const float4*>(st + 2 * (8 * j + 2 * t));
#pragma unroll
      for (int e = 0; e < 4; ++e) big[j][e] = dp_warp ? ((e & 1) ? -qst.w : -qst.y) : 0.f;
    }
    recompute<D, 8>((dp_warp ? vs : ks) + 16 * kg * Tl::kStride, dp_warp ? dos : qs, lane, big,
                    small);
    // Masked on the diagonal tile alone (rows past S read zero Q, dO and
    // pairs, so they add nothing).
    const bool diag = it % n_qt == 0;
    if (!dp_warp) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 qst = *reinterpret_cast<const float4*>(st + 2 * (8 * j + 2 * t));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_approx(fmaf(big[j][e], a.scale_log2,
                                     fmaf(small[j][e], a.scale_log2, (e & 1) ? -qst.z : -qst.x)));
          if (diag && kr + 8 * (e >> 1) > 8 * j + 2 * t + (e & 1)) p = 0.f;
          big[j][e] = p;
          mine[(4 * j + e) * 32] = p;
        }
      }
      named_arrive(1 + kg, 64);  // P^T is in the exchange
      accumulate<D, 8>(big, dos, lane, acc);
    } else {
      named_sync(1 + kg, 64);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[j][e] = mine[(4 * j + e) * 32] * (big[j][e] + small[j][e]);
      accumulate<D, 8>(big, qs, lane, acc);
    }
  }
  cp_async_wait<0>();

  if (a.slices == 1) {
    float* dst = (dp_warp ? a.dk : a.dv) + bkv * S * D;
    store_rows<D>(dst, acc, k0 + kr, S, lane, dp_warp ? a.scale : 1.f);
  } else {  // partial (2, B, Hkv, slices, S, D): dK unscaled, then dV
    const size_t plane = (size_t)a.B * a.Hkv * a.slices * S * D;
    float* dst = a.partial + (dp_warp ? 0 : plane) + (bkv * a.slices + slice) * S * D;
    store_rows<D>(dst, acc, k0 + kr, S, lane, 1.f);
  }
}

// (c) f32: dQ of the 64-row tile qt of query head h of batch b.  Warp w
// takes rows 16 (w % 4) .. + 15 and keys 32 (w / 4) .. + 31 of each key
// tile: S = Q K^T, dP = dO V^T, P, dS and dQ += dS K over its 32 keys; the
// two warps of a row group add their sums at the end (in a fixed order).
template <int D>
__global__ void __launch_bounds__(kF32Threads, 1) flash_attention_bwd_dq_f32(
    const __grid_constant__ F32Args a) {
  using Tl = F32Tiles<D>;
  extern __shared__ __align__(16) float smem_f32[];
  float* qs = smem_f32;
  float* dos = qs + Tl::kElems;
  float* ring = dos + Tl::kElems;  // stage s: K, V
  const int h = blockIdx.x % a.Hq, b = blockIdx.x / a.Hq;
  const int qt = a.S_pad / kT - 1 - blockIdx.z;  // the longest rows first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, rg = warp & 3, kh = warp >> 2;
  const int S = a.S, q0 = qt * kT, n_tiles = qt + 1;  // key tiles up to the diagonal
  const size_t bh = (size_t)b * a.Hq + h, bkv = (size_t)b * a.Hkv + h / (a.Hq / a.Hkv);

  auto issue = [&](int t) {  // key tile t's K and V into stage t % kStages
    float* st = ring + (t % Tl::kStages) * 2 * Tl::kElems;
    copy_rows_f32<D>(st, a.k + bkv * S * D, t * kT, S);
    copy_rows_f32<D>(st + Tl::kElems, a.v + bkv * S * D, t * kT, S);
  };
  copy_rows_f32<D>(qs, a.q + bh * S * D, q0, S);
  copy_rows_f32<D>(dos, a.dout + bh * S * D, q0, S);
  issue(0);
  cp_async_commit();

  const int g = lane >> 2, tq = lane & 3;
  const int rr = 16 * rg + g;  // this thread's rows q0 + rr and q0 + rr + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // past S: zeros (the padded rows of stats)
    const float2 x =
        *reinterpret_cast<const float2*>(a.stats + (bh * a.S_pad + q0 + rr + 8 * r) * 2);
    lse2[r] = x.x;
    dl[r] = x.y;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1's stage
    if ((kF32Loads || t + 1 < Tl::kStages) && t + 1 < n_tiles) issue(t + 1);
    cp_async_commit();
    if (!kF32Products) continue;
    const float* kts = ring + (t % Tl::kStages) * 2 * Tl::kElems + 32 * kh * Tl::kStride;
    const float* vts = kts + Tl::kElems;
    // S and dP - Delta, 16 rows x 32 keys: element (j, e) is row q0 + rr + 8
    // (e / 2), key t kT + 32 kh + 8 j + 2 tq + e % 2.
    float s_big[4][4], s_small[4][4], p_big[4][4], p_small[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_big[j][e] = 0.f, p_big[j][e] = -dl[e >> 1];
    recompute<D, 4>(qs + 16 * rg * Tl::kStride, kts, lane, s_big, s_small);
    recompute<D, 4>(dos + 16 * rg * Tl::kStride, vts, lane, p_big, p_small);
    const bool diag = t == qt;  // masked on the diagonal tile alone
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(
            fmaf(s_big[j][e], a.scale_log2, fmaf(s_small[j][e], a.scale_log2, -lse2[e >> 1])));
        if (diag && 32 * kh + 8 * j + 2 * tq + (e & 1) > rr + 8 * (e >> 1)) p = 0.f;
        s_big[j][e] = p * (p_big[j][e] + p_small[j][e]);
      }
    accumulate<D, 4>(s_big, kts, lane, acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the key halves' sums meet there
  float* red = ring + (rg * (D / 2)) * 32 + lane;
  if (kh == 1) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(4 * j + e) * 32] = acc[j][e];
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += red[(4 * j + e) * 32];
    store_rows<D>(a.dq + bh * S * D, acc, q0 + rr, S, lane, a.scale);
  }
}

// ---- launches ---------------------------------------------------------------------

template <class Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// cuTensorMapEncodeTiled, reached through the runtime (the library links no
// libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The (S, D) bf16 rows of each of ``heads`` heads at base as a rank-3 map
// (D, S, heads): boxes of 32 columns x 64 rows of one head, the 64-byte
// swizzle, zeros for rows past S.
bool rows_map(CUtensorMap* map, const void* base, int D, int S, long heads) {
  const EncodeTiled encode = encode_tiled();
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {32, (cuuint32_t)kT, 1}, unit[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
             CUDA_SUCCESS;
}

// q, k, v and dout as the tensor maps the bf16 kernels read.
struct Maps {
  CUtensorMap q, k, v, dout;
};

bool make_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout, int D,
               int B, int Hq, int Hkv, int S) {
  return rows_map(&m->q, q, D, S, (long)B * Hq) && rows_map(&m->dout, dout, D, S, (long)B * Hq) &&
         rows_map(&m->k, k, D, S, (long)B * Hkv) && rows_map(&m->v, v, D, S, (long)B * Hkv);
}

template <int D>
cudaError_t launch_bf16(const Maps& m, const float* stats, float* partial, void* dq, void* dk,
                        void* dv, int B, int Hq, int Hkv, int S, int heads_per_block, float scale,
                        float scale_log2, cudaStream_t stream) {
  using Tl = Tiles<D>;
  const int S_pad = (S + kT - 1) / kT * kT;
  const int slices = (Hq / Hkv + heads_per_block - 1) / heads_per_block;
  const Bf16Args a{stats, static_cast<uint16_t*>(dq), static_cast<uint16_t*>(dk),
                   static_cast<uint16_t*>(dv), partial, B, Hq, Hkv, S, S_pad, heads_per_block,
                   slices, scale, scale_log2};
  cudaError_t err = set_smem(flash_attention_bwd_dkdv_bf16<D>, Tl::kSmem);
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkdv_bf16<D><<<dim3(Hkv * slices * B, 1, S_pad / kT), kWg, Tl::kSmem,
                                     stream>>>(m.q, m.k, m.v, m.dout, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (slices > 1 && (err = launch_sum<uint2>(partial, dk, dv, B, Hkv, S, D, slices, scale,
                                              stream)) != cudaSuccess)
    return err;
  if ((err = set_smem(flash_attention_bwd_dq_bf16<D>, Tl::kSmem)) != cudaSuccess) return err;
  flash_attention_bwd_dq_bf16<D><<<dim3(Hq * B, 1, S_pad / kT), kWg, Tl::kSmem, stream>>>(
      m.q, m.k, m.v, m.dout, a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       const float* stats, float* partial, void* dq, void* dk, void* dv, int B,
                       int Hq, int Hkv, int S, int heads_per_block, float scale, float scale_log2,
                       cudaStream_t stream) {
  using Tl = F32Tiles<D>;
  const int S_pad = (S + kT - 1) / kT * kT;
  const int slices = (Hq / Hkv + heads_per_block - 1) / heads_per_block;
  const F32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dout), stats,
                  static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                  partial, B, Hq, Hkv, S, S_pad, heads_per_block, slices, scale, scale_log2};
  cudaError_t err = set_smem(flash_attention_bwd_dkdv_f32<D>, Tl::kSmemKV);
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkdv_f32<D><<<dim3(Hkv * slices * B, 1, S_pad / kT), kF32Threads,
                                    Tl::kSmemKV, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (slices > 1 && (err = launch_sum<float4>(partial, dk, dv, B, Hkv, S, D, slices, scale,
                                               stream)) != cudaSuccess)
    return err;
  if ((err = set_smem(flash_attention_bwd_dq_f32<D>, Tl::kSmemQ)) != cudaSuccess) return err;
  flash_attention_bwd_dq_f32<D><<<dim3(Hq * B, 1, S_pad / kT), kF32Threads, Tl::kSmemQ,
                                  stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0: f32, 1: bf16.  Launches (a) into the caller's f32 scratch stats
// (B Hq S_pad 2 floats, S_pad = S rounded up to 64), then (b) dK and dV,
// (d) where a group is split, and (c) dQ, on one stream.  heads_per_block
// (kernel.py::bwd_plan): the query heads a (b) block walks, 1 to Hq / Hkv;
// below Hq / Hkv, partial is the caller's f32 scratch (2, B, Hkv, slices,
// S, D) of the slices' dK and dV.  q, k, v, out, dout, dq, dk and dv must
// start on 16 bytes (the wrapper copies operands that do not); D is 32, 64,
// 96 or 128.
int flash_attention_bwd_launch(int dtype, int D, const void* q, const void* k, const void* v,
                               const void* out, const void* dout, const float* lse,
                               float* stats, float* partial, void* dq, void* dk, void* dv, int B,
                               int Hq, int Hkv, int S, int heads_per_block, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || Hq % Hkv != 0 || B > 65535 ||
      (S + kT - 1) / kT > 65535 || (dtype != 0 && dtype != 1) || lse == nullptr ||
      stats == nullptr || heads_per_block < 1 || heads_per_block > Hq / Hkv ||
      (heads_per_block < Hq / Hkv && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out | (uintptr_t)dout |
       (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) % 16)
    return (int)cudaErrorMisalignedAddress;
  auto st = static_cast<cudaStream_t>(stream);
  const int S_pad = (S + kT - 1) / kT * kT;
  const long rows = (long)B * Hq * S_pad;
  const unsigned blocks = (unsigned)((rows * delta_lanes(D * (dtype == 1 ? 2 : 4) / 16) + 255) / 256);
  if (dtype == 1)
    flash_attention_bwd_delta<uint16_t><<<blocks, 256, 0, st>>>(
        static_cast<const uint16_t*>(out), static_cast<const uint16_t*>(dout), lse, stats, rows, S,
        S_pad, D);
  else
    flash_attention_bwd_delta<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout), lse, stats, rows, S,
        S_pad, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Maps maps;  // built while (a) runs
  if (dtype == 1 && !make_maps(&maps, q, k, v, dout, D, B, Hq, Hkv, S))
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  const int hpb = heads_per_block;
  switch (dtype * 1000 + D) {
    case 32: return (int)launch_f32<32>(q, k, v, dout, stats, partial, dq, dk, dv, B, Hq, Hkv, S, hpb, scale, scale_log2, st);
    case 64: return (int)launch_f32<64>(q, k, v, dout, stats, partial, dq, dk, dv, B, Hq, Hkv, S, hpb, scale, scale_log2, st);
    case 96: return (int)launch_f32<96>(q, k, v, dout, stats, partial, dq, dk, dv, B, Hq, Hkv, S, hpb, scale, scale_log2, st);
    case 128: return (int)launch_f32<128>(q, k, v, dout, stats, partial, dq, dk, dv, B, Hq, Hkv, S, hpb, scale, scale_log2, st);
    case 1032: return (int)launch_bf16<32>(maps, stats, partial, dq, dk, dv, B, Hq, Hkv, S, hpb, scale, scale_log2, st);
    case 1064: return (int)launch_bf16<64>(maps, stats, partial, dq, dk, dv, B, Hq, Hkv, S, hpb, scale, scale_log2, st);
    case 1096: return (int)launch_bf16<96>(maps, stats, partial, dq, dk, dv, B, Hq, Hkv, S, hpb, scale, scale_log2, st);
    case 1128: return (int)launch_bf16<128>(maps, stats, partial, dq, dk, dv, B, Hq, Hkv, S, hpb, scale, scale_log2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
