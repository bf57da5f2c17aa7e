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
// head h reading KV head h / (Hq / Hkv); lse and Delta (B, Hq, S) f32.  Every
// sum is f32 and every output is written once by one block, in a fixed
// order, with no atomics: two launches on the same inputs give the same
// bits.
//
// Bound on an H100 SXM at phi3-mini-3.8b's training layer (B 4, Hq = Hkv =
// 32, D 96, S 1,024, bf16): five products of 2 D operations per unmasked
// (query, key) pair (two recompute S and dP, three make dV, dQ, dK), 2.5x
// the forward's 4 B Hq D S (S + 1) / 2 = 6.45e10 operations, 0.065 ms at
// the bf16 tensor-core rate of wgmma (989 TFLOP/s), above the 0.03 ms of
// its bytes: operations bound it.  The kernels below issue mma.sync, with
// each bf16 operand that comes from an f32 sum (P, dS) split into two bf16
// parts: twice the products of those three, so 1.6e11 mma operations.
//
// (a) flash_attention_bwd_delta: one warp a row, Delta = sum dO o O in f32.
//
// (b) flash_attention_bwd_dkdv_bf16<D>: one block of 4 warps per (KV head,
//   batch, 64-key tile); warp w owns keys 16 w .. 16 w + 15.  The block's
//   K and V tiles are staged once in shared memory (rows D + 8 bf16 apart, as
//   in the forward).  It walks the group's query heads and, for each, the
//   32-row query tiles from the diagonal down to S, Q and dO (with their
//   lse and Delta) through a two-stage cp.async ring, one tile in flight.
//   Per tile, on mma.sync m16n8k16 bf16 -> f32 with keys on M:
//     S^T = K Q^T and dP^T = V dO^T (K, V A fragments by ldmatrix; Q, dO B
//     fragments by ldmatrix, as the forward reads K), then P^T and dS^T in
//     the accumulators (masked only on tiles across the diagonal or past S);
//     dV += P^T dO and dK += dS^T Q with P^T / dS^T as A fragments in place
//     (the forward's P V layout), each split into bf16 hi + lo, and dO / Q
//     B fragments by ldmatrix.trans.  dK and dV stay in f32 registers for the
//     whole group (the GQA sum) and are written once, dK times the scale.
//
// (c) flash_attention_bwd_dq_bf16<D>: one block of 4 warps per (query head,
//   batch, 64-row query tile), warp w owning rows 16 w .. 16 w + 15, the
//   longest rows first.  Q and dO are staged once; 64-key K and V tiles
//   stream through a two-stage cp.async ring up to the diagonal.  Per tile:
//   S = Q K^T, dP = dO V^T (the forward's layout), P and dS in the
//   accumulators, dQ += dS K with dS split into bf16 hi + lo as the A
//   fragment and K by ldmatrix.trans; dQ is written once, times the scale.
//
// f32 (flash_attention_bwd_dkdv_f32<D>, flash_attention_bwd_dq_f32<D>): the
//   same blocks and loops on CUDA-core FMA over 32 x 32 tiles staged in
//   shared memory (rows D + 1 floats apart), 256 threads; the LM trains in
//   bf16, so these carry the gradient of f32 attention only.
//
// Left for a redesign: wgmma with K / V / Q read by the tensor cores from
// shared memory, TMA copies, and one kernel for dK, dV and dQ (dQ summed
// across key tiles, which needs atomics or a second pass).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float bf16_f32(uint16_t x) { return __uint_as_float((unsigned)x << 16); }
__device__ __forceinline__ float elem_f32(uint16_t x) { return bf16_f32(x); }
__device__ __forceinline__ float elem_f32(float x) { return x; }

// ---- (a) Delta ---------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) flash_attention_bwd_delta(const T* __restrict__ out,
                                                                  const T* __restrict__ dout,
                                                                  float* __restrict__ delta,
                                                                  long rows, int D) {
  const long row = (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // a whole warp: one row
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s = fmaf(elem_f32(o[c]), elem_f32(g[c]), s);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) delta[row] = s;
}

// ---- the bf16 blocks ------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 16 * kWarps;  // (b): keys a block
constexpr int kQT = 32;             // (b): query rows a tile of the ring
constexpr int kRows = 16 * kWarps;  // (c): query rows a block
constexpr int kKT = 64;             // (c): keys a tile of the ring

template <int D>
struct Bf16Rows {
  static constexpr int kStride = D + 8;  // staged row stride in bf16 (2 D + 16 bytes)
  static constexpr int kPacks = D / 8;   // 16-byte packs of a row
  static constexpr int kKSteps = D / 16;
  static constexpr int kDFrags = D / 8;  // n8 fragments of a D-wide output
};

// Rows [r0, r0 + ROWS) of a head's (S, D) bf16 matrix into staged rows by
// 16-byte cp.async; rows past S are zero-filled and read nothing.
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(uint16_t* dst, const uint16_t* __restrict__ src, int r0,
                                          int S) {
  using R = Bf16Rows<D>;
  for (int i = threadIdx.x; i < R::kPacks * ROWS; i += kThreads) {
    const int r = i / R::kPacks, c = 8 * (i % R::kPacks);
    const bool ok = r0 + r < S;
    cp_async16(dst + r * R::kStride + c, src + (ok ? (size_t)(r0 + r) * D + c : 0), ok ? 16 : 0);
  }
}

// ROWS floats of a head's (S,) statistics from r0 (past S: zeros), by the
// threads whose tid is in [0, ROWS).
template <int ROWS>
__device__ __forceinline__ void copy_stats(float* dst, const float* __restrict__ src, int r0,
                                           int S, int tid) {
  if (tid >= 0 && tid < ROWS) {
    const bool ok = r0 + tid < S;
    cp_async4(dst + tid, src + (ok ? r0 + tid : 0), ok ? 4 : 0);
  }
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

// acc[j] (j < kDFrags) += A (16 rows x 16 k, the accumulators c of two
// adjacent n8 fragments f0, f1 of an f32 product, split into bf16 hi + lo)
// times B (16 k rows x D, row-major in shared memory at rows_addr, read by
// ldmatrix.trans: k on rows).  rows_addr is this lane's ldmatrix address
// (row lane % 16, column 8 (lane / 16)) of the 16 k rows.
template <int D>
__device__ __forceinline__ void mma_split_rows(float (&acc)[D / 8][4], const float (&f0)[4],
                                               const float (&f1)[4], unsigned rows_addr) {
  unsigned hi[4], lo[4];
  split_bf16(f0[0], f0[1], hi[0], lo[0]);  // row r, k 2t..
  split_bf16(f0[2], f0[3], hi[1], lo[1]);  // row r + 8, k 2t..
  split_bf16(f1[0], f1[1], hi[2], lo[2]);  // row r, k 8 + 2t..
  split_bf16(f1[2], f1[3], hi[3], lo[3]);  // row r + 8, k 8 + 2t..
#pragma unroll
  for (int j = 0; j < D / 8; j += 2) {
    unsigned b[4];  // b0, b1 of output fragments j and j + 1
    ldmatrix_x4_trans(b, rows_addr + 2 * 8 * j);
    const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
    mma_bf16(acc[j], lo, b0);
    mma_bf16(acc[j + 1], lo, b1);
    mma_bf16(acc[j], hi, b0);
    mma_bf16(acc[j + 1], hi, b1);
  }
}

// (b) dK and dV of one 64-key tile of one KV head.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dkdv_bf16(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, uint16_t* __restrict__ dk,
    uint16_t* __restrict__ dv, int Hq, int Hkv, int S, float scale, float scale_log2) {
  using R = Bf16Rows<D>;
  constexpr int kTile = kQT * R::kStride;  // one staged Q or dO tile
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* ks = smem;
  uint16_t* vs = ks + kKeys * R::kStride;
  uint16_t* ring = vs + kKeys * R::kStride;  // stage st: Q, then dO
  float* stats = reinterpret_cast<float*>(ring + 4 * kTile);  // stage st: lse, then Delta
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.z * kKeys;  // the first key tiles have the most query tiles
  const int hk = blockIdx.x, b = blockIdx.y, group = Hq / Hkv;
  const size_t kv_head = ((size_t)b * Hkv + hk) * S * D;
  const int t0 = k0 / kQT;  // the first query tile that sees a key of the block
  const int n_qt = (S + kQT - 1) / kQT - t0;
  const int n_iter = group * n_qt;

  auto issue = [&](int i) {  // iteration i's Q, dO, lse and Delta into stage i % 2
    const int st = i & 1, q0 = (t0 + i % n_qt) * kQT;
    const size_t head = (size_t)b * Hq + hk * group + i / n_qt;
    copy_rows<D, kQT>(ring + 2 * st * kTile, q + head * S * D, q0, S);
    copy_rows<D, kQT>(ring + (2 * st + 1) * kTile, dout + head * S * D, q0, S);
    copy_stats<kQT>(stats + 2 * st * kQT, lse + head * S, q0, S, (int)threadIdx.x);
    copy_stats<kQT>(stats + (2 * st + 1) * kQT, delta + head * S, q0, S,
                    (int)threadIdx.x - kQT);
  };
  copy_rows<D, kKeys>(ks, k + kv_head, k0, S);
  copy_rows<D, kKeys>(vs, v + kv_head, k0, S);
  issue(0);
  cp_async_commit();

  float dka[R::kDFrags][4], dva[R::kDFrags][4];
#pragma unroll
  for (int j = 0; j < R::kDFrags; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  // ldmatrix lane offsets: A (rows on M) row lane % 16, column 8 (lane / 16);
  // B (rows on N) row lane % 8 + 8 (lane / 16), column 8 ((lane / 8) % 2);
  // B transposed (rows on K) row lane % 16, column 8 (lane / 16).
  const int a_lane = (16 * warp + (lane & 15)) * R::kStride + 8 * (lane >> 4);
  const int b_lane = ((lane & 7) + 8 * (lane >> 4)) * R::kStride + 8 * ((lane >> 3) & 1);
  const int t_lane = (lane & 15) * R::kStride + 8 * (lane >> 4);
  const int key0 = k0 + 16 * warp + (lane >> 2);  // keys key0 and key0 + 8

  for (int i = 0; i < n_iter; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // tile i is in; every warp is done with tile i - 1's stage
    if (i + 1 < n_iter) issue(i + 1);
    cp_async_commit();
    const int st = i & 1, q0 = (t0 + i % n_qt) * kQT;
    const uint16_t* qs = ring + 2 * st * kTile;
    const uint16_t* dos = qs + kTile;
    const float* ls = stats + 2 * st * kQT;
    const float* dls = ls + kQT;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries a warp
    float sT[kQT / 8][4], dpT[kQT / 8][4];
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
    for (int kq = 0; kq < R::kKSteps; ++kq) {
      unsigned ka[4], va[4];
      ldmatrix_x4(ka, smem_addr(ks + a_lane + 16 * kq));
      ldmatrix_x4(va, smem_addr(vs + a_lane + 16 * kq));
#pragma unroll
      for (int j = 0; j < kQT / 8; j += 2) {
        unsigned qb[4], ob[4];  // b0, b1 of query fragments j and j + 1
        ldmatrix_x4(qb, smem_addr(qs + b_lane + 8 * j * R::kStride + 16 * kq));
        ldmatrix_x4(ob, smem_addr(dos + b_lane + 8 * j * R::kStride + 16 * kq));
        const unsigned q0b[2] = {qb[0], qb[1]}, q1b[2] = {qb[2], qb[3]};
        const unsigned o0b[2] = {ob[0], ob[1]}, o1b[2] = {ob[2], ob[3]};
        mma_bf16(sT[j], ka, q0b);
        mma_bf16(sT[j + 1], ka, q1b);
        mma_bf16(dpT[j], va, o0b);
        mma_bf16(dpT[j + 1], va, o1b);
      }
    }
    // P^T and dS^T in place: element e of fragment j is key key0 + 8 (e / 2),
    // query q0 + 8 j + 2 (lane % 4) + e % 2.
    const bool edge = q0 < k0 + kKeys || q0 + kQT > S;
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * (lane & 3) + (e & 1);
        float p = exp2_approx(fmaf(sT[j][e], scale_log2, -ls[qi] * kLog2e));
        if (edge && (key0 + 8 * (e >> 1) > q0 + qi || q0 + qi >= S)) p = 0.f;
        sT[j][e] = p;
        dpT[j][e] = p * (dpT[j][e] - dls[qi]);
      }
    // dV += P^T dO, dK += dS^T Q: k = the tile's 32 queries, two k-steps
#pragma unroll
    for (int kk = 0; kk < kQT / 16; ++kk) {
      mma_split_rows<D>(dva, sT[2 * kk], sT[2 * kk + 1],
                        smem_addr(dos + t_lane + 16 * kk * R::kStride));
      mma_split_rows<D>(dka, dpT[2 * kk], dpT[2 * kk + 1],
                        smem_addr(qs + t_lane + 16 * kk * R::kStride));
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= S) continue;
    unsigned* dkr = reinterpret_cast<unsigned*>(dk + kv_head + (size_t)key * D + 2 * (lane & 3));
    unsigned* dvr = reinterpret_cast<unsigned*>(dv + kv_head + (size_t)key * D + 2 * (lane & 3));
#pragma unroll
    for (int j = 0; j < R::kDFrags; ++j) {
      dkr[4 * j] = pack_bf16(scale * dka[j][2 * r], scale * dka[j][2 * r + 1]);
      dvr[4 * j] = pack_bf16(dva[j][2 * r], dva[j][2 * r + 1]);
    }
  }
}

// (c) dQ of one 64-row query tile of one query head.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dq_bf16(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, uint16_t* __restrict__ dq,
    int Hq, int Hkv, int S, float scale, float scale_log2) {
  using R = Bf16Rows<D>;
  constexpr int kTile = kKT * R::kStride;  // one staged K or V tile
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;
  uint16_t* dos = qs + kRows * R::kStride;
  uint16_t* ring = dos + kRows * R::kStride;  // stage st: K, then V
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // the longest rows first
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (Hq / Hkv);
  const size_t head = (size_t)b * Hq + h;
  const uint16_t* kh = k + ((size_t)b * Hkv + hk) * S * D;
  const uint16_t* vh = v + ((size_t)b * Hkv + hk) * S * D;
  const int n_tiles = (min(q0 + kRows, S) - 1) / kKT + 1;  // none wholly above the diagonal
  const int n_unmasked = q0 / kKT;  // tiles whose every key precedes every row

  copy_rows<D, kRows>(qs, q + head * S * D, q0, S);
  copy_rows<D, kRows>(dos, dout + head * S * D, q0, S);
  copy_rows<D, kKT>(ring, kh, 0, S);
  copy_rows<D, kKT>(ring + kTile, vh, 0, S);
  cp_async_commit();

  const int row0 = q0 + 16 * warp + (lane >> 2);  // rows row0 and row0 + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row0 + 8 * r < S;
    lse2[r] = ok ? lse[head * S + row0 + 8 * r] * kLog2e : 0.f;
    dl[r] = ok ? delta[head * S + row0 + 8 * r] : 0.f;
  }
  float dqa[R::kDFrags][4];
#pragma unroll
  for (int j = 0; j < R::kDFrags; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
  const int a_lane = (16 * warp + (lane & 15)) * R::kStride + 8 * (lane >> 4);
  const int b_lane = ((lane & 7) + 8 * (lane >> 4)) * R::kStride + 8 * ((lane >> 3) & 1);
  const int t_lane = (lane & 15) * R::kStride + 8 * (lane >> 4);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1's stage
    if (t + 1 < n_tiles) {
      const int st = (t + 1) & 1;
      copy_rows<D, kKT>(ring + 2 * st * kTile, kh, (t + 1) * kKT, S);
      copy_rows<D, kKT>(ring + (2 * st + 1) * kTile, vh, (t + 1) * kKT, S);
    }
    cp_async_commit();
    const uint16_t* kts = ring + 2 * (t & 1) * kTile;
    const uint16_t* vts = kts + kTile;

    float s[kKT / 8][4], dp[kKT / 8][4];
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kq = 0; kq < R::kKSteps; ++kq) {
      unsigned qa[4], oa[4];
      ldmatrix_x4(qa, smem_addr(qs + a_lane + 16 * kq));
      ldmatrix_x4(oa, smem_addr(dos + a_lane + 16 * kq));
#pragma unroll
      for (int j = 0; j < kKT / 8; j += 2) {
        unsigned kb[4], vb[4];  // b0, b1 of key fragments j and j + 1
        ldmatrix_x4(kb, smem_addr(kts + b_lane + 8 * j * R::kStride + 16 * kq));
        ldmatrix_x4(vb, smem_addr(vts + b_lane + 8 * j * R::kStride + 16 * kq));
        const unsigned k0b[2] = {kb[0], kb[1]}, k1b[2] = {kb[2], kb[3]};
        const unsigned v0b[2] = {vb[0], vb[1]}, v1b[2] = {vb[2], vb[3]};
        mma_bf16(s[j], qa, k0b);
        mma_bf16(s[j + 1], qa, k1b);
        mma_bf16(dp[j], oa, v0b);
        mma_bf16(dp[j + 1], oa, v1b);
      }
    }
    // P and dS in place: element e of fragment j is row row0 + 8 (e / 2),
    // key t kKT + 8 j + 2 (lane % 4) + e % 2.
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(fmaf(s[j][e], scale_log2, -lse2[e >> 1]));
        if (t >= n_unmasked && t * kKT + 8 * j + 2 * (lane & 3) + (e & 1) > row0 + 8 * (e >> 1))
          p = 0.f;
        dp[j][e] = p * (dp[j][e] - dl[e >> 1]);
      }
    // dQ += dS K: k = the tile's 64 keys, four k-steps
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk)
      mma_split_rows<D>(dqa, dp[2 * kk], dp[2 * kk + 1],
                        smem_addr(kts + t_lane + 16 * kk * R::kStride));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    unsigned* dst = reinterpret_cast<unsigned*>(dq + (head * S + row) * D + 2 * (lane & 3));
#pragma unroll
    for (int j = 0; j < R::kDFrags; ++j)
      dst[4 * j] = pack_bf16(scale * dqa[j][2 * r], scale * dqa[j][2 * r + 1]);
  }
}

// ---- the f32 blocks (CUDA-core FMA) -------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32Tile = 32;  // keys a (b) block / rows a (c) block, and the tiles they walk

// Rows [r0, r0 + 32) of a head's (S, D) f32 matrix into rows D + 1 floats
// apart (zeros past S).
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* __restrict__ src, int r0,
                                              int S) {
  for (int i = threadIdx.x; i < kF32Tile * D; i += kF32Threads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r0 + r < S ? src[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

// The 32 x 32 tile of products a . b over D of rows a (this thread's row i)
// and b (its columns j = tid % 8 + 8 u), for both pairs of matrices at once.
template <int D>
__device__ __forceinline__ void tile_dots(const float* a0, const float* b0, const float* a1,
                                          const float* b1, float (&s)[4], float (&t)[4]) {
  const int i = threadIdx.x >> 3, jl = threadIdx.x & 7;
#pragma unroll
  for (int u = 0; u < 4; ++u) s[u] = t[u] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float x = a0[i * (D + 1) + d], y = a1[i * (D + 1) + d];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      s[u] = fmaf(x, b0[(jl + 8 * u) * (D + 1) + d], s[u]);
      t[u] = fmaf(y, b1[(jl + 8 * u) * (D + 1) + d], t[u]);
    }
  }
}

// acc[u] += sum over the 32 columns j of w[i][j] * rows[j][tid % 8 + 8 u].
template <int D>
__device__ __forceinline__ void tile_rows(const float* w, const float* rows, float (&acc)[D / 8]) {
  const int i = threadIdx.x >> 3, cl = threadIdx.x & 7;
  for (int j = 0; j < kF32Tile; ++j) {
    const float x = w[i * (kF32Tile + 1) + j];
#pragma unroll
    for (int u = 0; u < D / 8; ++u) acc[u] = fmaf(x, rows[j * (D + 1) + cl + 8 * u], acc[u]);
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_attention_bwd_dkdv_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int Hq,
    int Hkv, int S, float scale, float scale_log2) {
  constexpr int kTile = kF32Tile * (D + 1);
  extern __shared__ __align__(16) float smem_f32[];
  float* ks = smem_f32;
  float* vs = ks + kTile;
  float* qs = vs + kTile;
  float* dos = qs + kTile;
  float* ps = dos + kTile;                         // P^T (keys x queries)
  float* dss = ps + kF32Tile * (kF32Tile + 1);     // dS^T
  float* ls = dss + kF32Tile * (kF32Tile + 1);     // lse, then Delta
  const int k0 = blockIdx.z * kF32Tile;
  const int hk = blockIdx.x, b = blockIdx.y, group = Hq / Hkv;
  const size_t kv_head = ((size_t)b * Hkv + hk) * S * D;
  const int i = threadIdx.x >> 3, jl = threadIdx.x & 7;
  load_rows_f32<D>(ks, k + kv_head, k0, S);
  load_rows_f32<D>(vs, v + kv_head, k0, S);
  float dka[D / 8], dva[D / 8];
#pragma unroll
  for (int u = 0; u < D / 8; ++u) dka[u] = dva[u] = 0.f;

  for (int g = 0; g < group; ++g) {
    const size_t head = (size_t)b * Hq + hk * group + g;
    for (int q0 = k0; q0 < S; q0 += kF32Tile) {
      __syncthreads();  // the last tile's reads are done
      load_rows_f32<D>(qs, q + head * S * D, q0, S);
      load_rows_f32<D>(dos, dout + head * S * D, q0, S);
      if (threadIdx.x < 2 * kF32Tile) {
        const int r = threadIdx.x % kF32Tile;
        const float* src = threadIdx.x < kF32Tile ? lse : delta;
        ls[threadIdx.x] = q0 + r < S ? src[head * S + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[4], dp[4];
      tile_dots<D>(ks, qs, vs, dos, s, dp);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int qi = jl + 8 * u;
        float p = exp2f(fmaf(s[u], scale_log2, -ls[qi] * kLog2e));
        if (k0 + i > q0 + qi || q0 + qi >= S) p = 0.f;
        ps[i * (kF32Tile + 1) + qi] = p;
        dss[i * (kF32Tile + 1) + qi] = p * (dp[u] - ls[kF32Tile + qi]);
      }
      __syncthreads();
      tile_rows<D>(ps, dos, dva);
      tile_rows<D>(dss, qs, dka);
    }
  }
  if (k0 + i < S) {
#pragma unroll
    for (int u = 0; u < D / 8; ++u) {
      dk[kv_head + (size_t)(k0 + i) * D + jl + 8 * u] = scale * dka[u];
      dv[kv_head + (size_t)(k0 + i) * D + jl + 8 * u] = dva[u];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_attention_bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int Hq, int Hkv, int S,
    float scale, float scale_log2) {
  constexpr int kTile = kF32Tile * (D + 1);
  extern __shared__ __align__(16) float smem_f32[];
  float* qs = smem_f32;
  float* dos = qs + kTile;
  float* ks = dos + kTile;
  float* vs = ks + kTile;
  float* dss = vs + kTile;  // dS (rows x keys)
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kF32Tile;  // the longest rows first
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (Hq / Hkv);
  const size_t head = (size_t)b * Hq + h;
  const size_t kv_head = ((size_t)b * Hkv + hk) * S * D;
  const int i = threadIdx.x >> 3, jl = threadIdx.x & 7;
  load_rows_f32<D>(qs, q + head * S * D, q0, S);
  load_rows_f32<D>(dos, dout + head * S * D, q0, S);
  const bool row_ok = q0 + i < S;
  const float lse2 = row_ok ? lse[head * S + q0 + i] * kLog2e : 0.f;
  const float dl = row_ok ? delta[head * S + q0 + i] : 0.f;
  float dqa[D / 8];
#pragma unroll
  for (int u = 0; u < D / 8; ++u) dqa[u] = 0.f;

  for (int k0 = 0; k0 <= q0 && k0 < S; k0 += kF32Tile) {
    __syncthreads();  // the last tile's reads are done
    load_rows_f32<D>(ks, k + kv_head, k0, S);
    load_rows_f32<D>(vs, v + kv_head, k0, S);
    __syncthreads();
    float s[4], dp[4];
    tile_dots<D>(qs, ks, dos, vs, s, dp);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kj = jl + 8 * u;
      float p = exp2f(fmaf(s[u], scale_log2, -lse2));
      if (k0 + kj > q0 + i) p = 0.f;
      dss[i * (kF32Tile + 1) + kj] = p * (dp[u] - dl);
    }
    __syncthreads();
    tile_rows<D>(dss, ks, dqa);
  }
  if (row_ok) {
#pragma unroll
    for (int u = 0; u < D / 8; ++u) dq[(head * S + q0 + i) * D + jl + 8 * u] = scale * dqa[u];
  }
}

// ---- launches ---------------------------------------------------------------------

template <class Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, void* dk, void* dv,
                        int B, int Hq, int Hkv, int S, float scale, float scale_log2,
                        cudaStream_t stream) {
  using R = Bf16Rows<D>;
  const auto* q16 = static_cast<const uint16_t*>(q);
  const auto* k16 = static_cast<const uint16_t*>(k);
  const auto* v16 = static_cast<const uint16_t*>(v);
  const auto* o16 = static_cast<const uint16_t*>(dout);
  constexpr size_t kv_smem =
      sizeof(uint16_t) * (2 * kKeys + 4 * kQT) * R::kStride + sizeof(float) * 4 * kQT;
  cudaError_t err = set_smem(flash_attention_bwd_dkdv_bf16<D>, kv_smem);
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkdv_bf16<D><<<dim3(Hkv, B, (S + kKeys - 1) / kKeys), kThreads, kv_smem,
                                     stream>>>(q16, k16, v16, o16, lse, delta,
                                               static_cast<uint16_t*>(dk),
                                               static_cast<uint16_t*>(dv), Hq, Hkv, S, scale,
                                               scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t q_smem = sizeof(uint16_t) * (2 * kRows + 4 * kKT) * R::kStride;
  if ((err = set_smem(flash_attention_bwd_dq_bf16<D>, q_smem)) != cudaSuccess) return err;
  flash_attention_bwd_dq_bf16<D><<<dim3(Hq, B, (S + kRows - 1) / kRows), kThreads, q_smem,
                                   stream>>>(q16, k16, v16, o16, lse, delta,
                                             static_cast<uint16_t*>(dq), Hq, Hkv, S, scale,
                                             scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                       int Hq, int Hkv, int S, float scale, float scale_log2,
                       cudaStream_t stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(dout);
  const dim3 grid_kv(Hkv, B, (S + kF32Tile - 1) / kF32Tile);
  const dim3 grid_q(Hq, B, (S + kF32Tile - 1) / kF32Tile);
  constexpr size_t kv_smem =
      sizeof(float) * (4 * kF32Tile * (D + 1) + 2 * kF32Tile * (kF32Tile + 1) + 2 * kF32Tile);
  cudaError_t err = set_smem(flash_attention_bwd_dkdv_f32<D>, kv_smem);
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkdv_f32<D><<<grid_kv, kF32Threads, kv_smem, stream>>>(
      qf, kf, vf, of, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), Hq, Hkv, S,
      scale, scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t q_smem = sizeof(float) * (4 * kF32Tile * (D + 1) + kF32Tile * (kF32Tile + 1));
  if ((err = set_smem(flash_attention_bwd_dq_f32<D>, q_smem)) != cudaSuccess) return err;
  flash_attention_bwd_dq_f32<D><<<grid_q, kF32Threads, q_smem, stream>>>(
      qf, kf, vf, of, lse, delta, static_cast<float*>(dq), Hq, Hkv, S, scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0: f32, 1: bf16.  Launches (a) Delta into the caller's (B, Hq, S)
// f32 scratch, then (b) dK and dV, then (c) dQ, on one stream.  q, k, v,
// out, dout, dq, dk and dv must start on 16 bytes (the wrapper copies
// operands that do not); D is 32, 64, 96 or 128.
int flash_attention_bwd_launch(int dtype, int D, const void* q, const void* k, const void* v,
                               const void* out, const void* dout, const float* lse,
                               float* delta, void* dq, void* dk, void* dv, int B, int Hq,
                               int Hkv, int S, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || Hq % Hkv != 0 || B > 65535 ||
      (S + kF32Tile - 1) / kF32Tile > 65535 || (dtype != 0 && dtype != 1) || lse == nullptr ||
      delta == nullptr)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out | (uintptr_t)dout |
       (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) % 16)
    return (int)cudaErrorMisalignedAddress;
  auto st = static_cast<cudaStream_t>(stream);
  const long rows = (long)B * Hq * S;
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  if (dtype == 1)
    flash_attention_bwd_delta<uint16_t><<<blocks, 256, 0, st>>>(
        static_cast<const uint16_t*>(out), static_cast<const uint16_t*>(dout), delta, rows, D);
  else
    flash_attention_bwd_delta<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout), delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)D));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  switch (dtype * 1000 + D) {
    case 32: return (int)launch_f32<32>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, scale, scale_log2, st);
    case 64: return (int)launch_f32<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, scale, scale_log2, st);
    case 96: return (int)launch_f32<96>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, scale, scale_log2, st);
    case 128: return (int)launch_f32<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, scale, scale_log2, st);
    case 1032: return (int)launch_bf16<32>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, scale, scale_log2, st);
    case 1064: return (int)launch_bf16<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, scale, scale_log2, st);
    case 1096: return (int)launch_bf16<96>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, scale, scale_log2, st);
    case 1128: return (int)launch_bf16<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, scale, scale_log2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
