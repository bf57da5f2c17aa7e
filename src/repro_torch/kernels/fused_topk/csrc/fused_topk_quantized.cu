// Fused streaming score -> top-k over packed int8 / int4 postings, for Hopper
// (sm_90a), CUDA C++ with a plain C interface (bound with ctypes by
// ../kernel.py).
//
// K4 (fused_topk_quantized_bf16_partial for a bf16 query,
// fused_topk_quantized_tf32_partial for an f32 one, + the shared merge pass)
// replaces the TPU kernel repro/kernels/fused_topk/kernel.py::fused_topk_quantized (def 632,
// pallas_call 689): the top-`depth` of q @ dequant(docs, scale).T, with the
// dequantization fused into the score stage, so only the packed store and
// its scales are read and the dequantized matrix never exists in device
// memory.  K5 (fused_topk_gathered_quantized_partial + the same merge)
// replaces fused_topk_gathered_quantized (def 765, pallas_call 818): the same
// over the rows each query kept in blockmax stage 1, read by id.
//
// The dequant order is the reference's, element by element (but for an
// f32 query over int4 rows, below):
//   * int8 (docs (N, T) int8, scale (N, 1) f32): the stored value widened to
//     the query dtype (exact: |v| <= 127), the products summed in f32 over
//     the whole row, and the sum multiplied by scale[n] ONCE.
//   * int4 (docs (N, Tg/2) uint8, Tg = round_up(T, group), scale (N, Tg /
//     group) f32): column 2c is the low nibble of byte c, column 2c + 1 the
//     high one; value = (float)(nibble - 8) * scale[n, col / group] in f32,
//     rounded once to bf16 for a bf16 query, then multiplied with the query
//     in f32.  With an f32 query the scale multiplies each 32-column chunk's
//     sum of q * (nibble - 8) instead of each (nibble - 8).
// A bf16 x bf16 product is exact in f32, so with a bf16 query only the order
// of the f32 sum differs from the reference.  The query has T columns: it is
// never read past T, and the pad columns [T, Tg) count as query 0.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16; data sheet) at the
// ann-word2vec cell (N = 2,999,808, classic T = 600, depth 100): the bytes
// are N * (600 + 4) = 1.81 GB for int8 (0.541 ms) and N * (304 + 76) =
// 1.14 GB for int4 at group 32 (0.340 ms); at B = 256 the 2 * B * N * T =
// 9.2e11 operations take 0.932 ms on bf16 tensor cores, so operations bound
// both widths there and bytes bound them at B = 1.
//
// K4 with a bf16 query (the classic and dot fake-words paths over packed
// postings): fused_topk_quantized_bf16_partial, the tensor-core pass 1 of
// mma_topk.cuh that K1 classic runs (fused_topk.cu), over packed rows
// (Int8Rows, Int4Rows).  A row's 64-column chunk is 8-column units: int8
// units of 8 bytes (rows of 600 bytes start only 8-byte aligned), int4
// units of 4 bytes and their group's scale.  Each thread widens its units
// to bf16 as it stores them into the bf16 stage, with the reference's
// expressions: an int8 byte exactly, an int4 nibble as bf16(f32(nibble - 8)
// * group scale).  ldmatrix, mma.sync m16n8k16 and the running top-k are
// K1's; the int8 per-row scale multiplies each finished sum before the
// threshold test.  So the products run on tensor cores, each packed row is
// read once per query tile, and the dequantized chunk exists only in shared
// memory.  The units arrive one of two ways: a cp.async ring of raw units in
// per-thread slots, three stages (two chunks in flight; 218,880 bytes of
// shared memory at 64 queries and depth 100, 118,240 at 8), widened by the
// thread that copied them between two barriers; or through registers one
// chunk ahead (two bf16 stages, 203,520 / 104,800 bytes), for rows the ring
// cannot copy and for int8 at 64-query tiles, where it measured faster.
// The loads, not the products, set the pace (PERF.md: `chip_smoke.py --ablate`).
//
// K4 with an f32 query (brute force over int8 or int4 postings):
// fused_topk_quantized_tf32_partial, the same tensor-core pass 1 with the
// split-TF32 product type (mma_topk.cuh, MmaTf32) over Int8RowsF32: a row's
// 32-column chunk is 4-byte units (4 int8 columns, one 16-byte f32 pack
// once widened; rows of 300 bytes start 4-byte aligned), widened exactly to
// f32 by the thread that loaded them, and the query split into two tf32
// parts as its fragments leave ldmatrix, so two m16n8k8 tf32 mma a k-step
// give the f32 dot product up to the order of the sums.  The units come
// through a cp.async ring of 4-byte copies into 4-byte slots where the rows
// allow it (faster than registers at every B on an H100: PERF.md §6),
// else through registers one chunk ahead.  Bound at the
// ann-word2vec brute-force shapes (N = 2,999,808, T = 300, depth 100): the
// bytes N * (300 + 4) = 0.912 GB take 0.272 ms at 3.35 TB/s; at B = 256 the
// 2 x 2 * B * N * T = 9.2e11 tf32 operations (two passes) take 1.86 ms at
// 495 TFLOP/s (the f32 FMAs of the plain product, 4.6e11 at 67 TFLOP/s,
// 6.877 ms), so operations bound it there and bytes at B <= 8.
//
// Over packed int4 rows (Int4RowsF32) a nibble times its group scale is not
// exact in tf32, but nibble - 8 (4 bits) is: each nibble widens to that
// exact f32, and the scale comes out of the product.  A 32-column chunk
// lies in one group (groups are multiples of 32), so the chunk's products,
// summed from zero (MmaTf32's fold), are multiplied by the row's scale for
// that group as they fold into the row's sum (kChunkScale): sum over g of
// s_g * sum over the group of q (n - 8), where the reference sums q *
// f32((n - 8) s_g).  The units (2 bytes, 4 nibbles) and each row's chunk
// scale come through registers one chunk ahead: a raw ring of 16-byte
// copies a row's chunk measured level with it on an H100 (PERF.md §6), and
// the register loader takes every row.  Bound at the brute-force shapes
// (group 32): the bytes N * (160 + 40) = 0.600 GB take 0.179 ms, and at
// B = 256 the same 1.86 ms of tf32 operations bound it.
//
// K5 (fused_topk_gathered_quantized_partial + the same merge) is K3's pass
// 1 over packed rows: grid (B, row splits), one query a block, K3's
// row-split plan (gathered_row_plan, topk_merge.cuh: two blocks a SM, so at
// B = 1 each of 261 blocks walks ~1,150 rows), one running list a block fed
// by a candidate buffer that the whole block merges by counting
// (merge_buffer of mma_topk.cuh; kDup: an id that comes twice ranks twice),
// the full comparator since ids arrive in any order, ids outside [0,
// n_docs) never read.  A quarter-warp reads a row in 8-byte units (16 int4
// columns or 8 int8 ones), so at T = 600 95% of the lanes work; a lane
// scores two rows against one read of the query (f32 in shared memory: a
// quarter's 8 lanes read 8 consecutive 16-byte words, the 4 quarters the
// same ones), and the next chunk's loads are in flight in registers while
// this one's units are dequantized (a cp.async ring of three chunks a lane
// measured slower at B = 8 and 256: PERF.md §6).  The loads are 8-, 4-
// or 1-byte ones as the rows are aligned, chosen at compile time (ALIGN; a
// choice at run time was 1.4x slower at B = 256: PERF.md §6).  The
// dequant gives the reference's values: an int8 byte by one PRMT into a
// magic float and one subtract (the sign bits flipped once a word); an int4
// nibble by one PRMT, a subtract and the multiply by its group's scale,
// two of them rounded to bf16 by one conversion for a bf16 query.
//
// Bound (chip_smoke.gathered_quantized_bound_ms): each distinct kept row and
// its scales once, the query and the ids; at the quantized blockmax cell
// (int4 g32, T = 600, n_keep 1171: R = 299,776) 0.034 ms at B = 1, 0.154 at
// B = 8 and 0.415 at B = 256 (3.35 TB/s).  This design shares no row
// between the queries that keep it, so its own floor is the no-reuse bytes
// B R (304 + 76 + 4) (chip_smoke.no_reuse_ms): 0.034 ms at B = 1, 0.275 at
// B = 8, 8.80 at B = 256.  No tensor cores: each query reads its own rows,
// so no product is reused.  At B = 256 the queries do share kept blocks
// (each kept by ~26 queries on average); scoring every query that kept a
// block from one read of it, on tensor cores, needs (block -> queries)
// lists built on the card and a per-query merge across blocks: another
// algorithm (PERF.md §7).

#include <cuda_bf16.h>

#include <type_traits>

#include "mma_topk.cuh"  // the tensor-core pass 1; includes topk_merge.cuh

namespace {

constexpr uint8_t kInt4Pad = 0x88;  // nibble 8 in both halves: value 0

enum QueryDtype { kQF32 = 0, kQBF16 = 1 };

template <int QT> struct Query;
template <> struct Query<kQF32> { using Raw = float; };
template <> struct Query<kQBF16> { using Raw = uint16_t; };

template <int QT> __device__ __forceinline__ float widen(typename Query<QT>::Raw x) {
  if constexpr (QT == kQBF16) return __uint_as_float(static_cast<uint32_t>(x) << 16);  // exact
  else return x;
}

// ---------------------------------------------------------------------------
// K4 with a bf16 query: the tensor-core pass 1 of mma_topk.cuh over packed
// rows (fused_topk_quantized_bf16_partial).
// ---------------------------------------------------------------------------

// Two f32 values whose low 16 bits are 0 (exact bf16 values) as a bf16 pair:
// lo in the low half (the lower column), hi in the high half.
__device__ __forceinline__ uint32_t bf16x2_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Two f32 values rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Byte b of w as 2^23 + byte, an f32 whose low byte is the byte.
__device__ __forceinline__ float magic_byte(uint32_t w, int b) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | b));
}

// int8 rows (N, T): a unit is 8 bytes, one 8-byte load where the row is at
// least 8-byte aligned and holds all 8 (int8 rows of 600 bytes), else byte
// loads; bytes past T, and rows that do not exist, are 0.  Each byte widens
// exactly to bf16 (|v| <= 128), and the sum is multiplied by scale[id] once.
struct Int8Rows {
  using Op = MmaBf16;
  using Unit = uint2;
  static constexpr bool kAsync = true;  // through a ring of raw units
  static constexpr bool kRaw = true;
  static constexpr int kSlot = 8;
  static constexpr bool kRowScale = true;
  static constexpr bool kChunkScale = false;
  const uint8_t* __restrict__ docs;
  const float* __restrict__ scale;  // (N, 1)
  int T, align;

  __device__ __forceinline__ Unit load(int di, bool ok, int e) const {
    const uint8_t* row = docs + (size_t)di * T;
    if (ok && e + 8 <= T && align >= 8) return *reinterpret_cast<const uint2*>(row + e);
    union { uint2 u; uint8_t b[8]; } p;
#pragma unroll
    for (int s = 0; s < 8; ++s) p.b[s] = (ok && e + s < T) ? row[e + s] : 0;
    return p.u;
  }
  // The unit's bytes into an 8-byte slot by cp.async (rows 8-byte aligned):
  // bytes past T, and rows that do not exist, zero-filled and not read.
  __device__ __forceinline__ void copy_raw(uint32_t* slot, int di, bool ok, int e) const {
    const int n = ok ? min(max(T - e, 0), 8) : 0;
    cp_async8(slot, n ? docs + (size_t)di * T + e : docs, n);
  }
  __device__ __forceinline__ Unit read_raw(const uint32_t* slot) const {
    return *reinterpret_cast<const uint2*>(slot);
  }
  // int8 byte c as an exact f32: 2^23 + (c ^ 0x80) - (2^23 + 128).
  __device__ __forceinline__ uint4 widen(Unit u) const {
    const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
    uint32_t out[4];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        out[2 * k + c] = bf16x2_exact(magic_byte(w[k], 2 * c) - 8388736.0f,
                                      magic_byte(w[k], 2 * c + 1) - 8388736.0f);
    return make_uint4(out[0], out[1], out[2], out[3]);
  }
  __device__ __forceinline__ float row_scale(int id) const { return scale[id]; }
};

// Packed int4 rows (N, row_bytes = Tg / 2): a unit is 4 bytes (8 nibbles:
// column 2c the low nibble of byte c, 2c + 1 the high one) and its group's
// scale.  A unit lies in one group (group is a multiple of 32); a group
// index >= n_groups (the last chunk's columns past Tg) reads scale 0 and is
// never loaded, bytes past the row read 0x88 (nibbles 8: value 0), and rows
// that do not exist are never read.  Each nibble widens as the reference
// dequantizes it: bf16(f32(nibble - 8) * scale).
struct Int4Rows {
  using Op = MmaBf16;
  struct Unit {
    uint32_t bits;
    float gscale;
  };
  static constexpr bool kAsync = true;  // through a ring of raw units
  static constexpr bool kRaw = true;
  static constexpr int kSlot = 8;       // the 4 bytes and the scale
  static constexpr bool kRowScale = false;
  static constexpr bool kChunkScale = false;
  const uint8_t* __restrict__ docs;
  const float* __restrict__ scale;  // (N, n_groups)
  int row_bytes, group, n_groups, align;

  __device__ __forceinline__ Unit load(int di, bool ok, int e) const {
    const uint8_t* row = docs + (size_t)di * row_bytes;
    const int b0 = e / 2, g = e / group;
    Unit u;
    u.gscale = (ok && g < n_groups) ? scale[(size_t)di * n_groups + g] : 0.f;
    if (ok && b0 + 4 <= row_bytes && align >= 8) {
      u.bits = *reinterpret_cast<const uint32_t*>(row + b0);
    } else {
      u.bits = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        u.bits |= (uint32_t)((ok && b0 + s < row_bytes) ? row[b0 + s] : kInt4Pad) << (8 * s);
    }
    return u;
  }
  // The unit's 4 bytes and its group's scale into an 8-byte slot by
  // cp.async (rows at least 4-byte aligned).  Bytes past the row are
  // zero-filled instead of 0x88: their group is past n_groups, so the scale
  // (zero-filled, not read) makes every value 0 all the same.
  __device__ __forceinline__ void copy_raw(uint32_t* slot, int di, bool ok, int e) const {
    const int b0 = e / 2, g = e / group;
    const bool ok_b = ok && b0 < row_bytes, ok_s = ok && g < n_groups;
    cp_async4(slot, ok_b ? docs + (size_t)di * row_bytes + b0 : docs, ok_b ? 4 : 0);
    cp_async4(slot + 1, ok_s ? scale + (size_t)di * n_groups + g : scale, ok_s ? 4 : 0);
  }
  __device__ __forceinline__ Unit read_raw(const uint32_t* slot) const {
    return Unit{slot[0], __uint_as_float(slot[1])};
  }
  // nibble n as (2^23 + n) - (2^23 + 8), times the group scale in f32, then
  // rounded once to bf16.
  __device__ __forceinline__ uint4 widen(Unit u) const {
    const uint32_t lo = u.bits & 0x0F0F0F0Fu, hi = (u.bits >> 4) & 0x0F0F0F0Fu;
    uint32_t out[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[c] = bf16x2_rn((magic_byte(lo, c) - 8388616.0f) * u.gscale,
                         (magic_byte(hi, c) - 8388616.0f) * u.gscale);
    return make_uint4(out[0], out[1], out[2], out[3]);
  }
  __device__ __forceinline__ float row_scale(int) const { return 1.f; }
};

template <int BITS, int BQ, int BN, int NS, bool RING>
__global__ void __launch_bounds__(kThreads, 1) fused_topk_quantized_bf16_partial(
    const uint16_t* __restrict__ q,     // (B, T) bf16 bits
    const uint8_t* __restrict__ docs,   // (N, row_bytes) int8 or packed int4
    const float* __restrict__ scale,    // (N, n_groups); int8: n_groups = 1
    const uint8_t* __restrict__ filt,   // nullptr | (N,) | (B, N)
    long long filt_stride,              // 0 for (N,), N for (B, N)
    int B, int n_docs, int T, int row_bytes, int group, int n_groups, int depth, int K,
    int tiles_per_split, bool q_aligned, int d_align,
    float* __restrict__ part_s, int* __restrict__ part_i) {  // (splits, B, K)
  if constexpr (BITS == 8) {
    const Int8Rows rows{docs, scale, T, d_align};
    mma_topk_pass1<Int8Rows, BQ, BN, NS, RING>(q, rows, filt, filt_stride, B, n_docs, T, depth,
                                              K, tiles_per_split, q_aligned ? 16 : 1, part_s,
                                              part_i);
  } else {
    const Int4Rows rows{docs, scale, row_bytes, group, n_groups, d_align};
    mma_topk_pass1<Int4Rows, BQ, BN, NS, RING>(q, rows, filt, filt_stride, B, n_docs, T, depth,
                                              K, tiles_per_split, q_aligned ? 16 : 1, part_s,
                                              part_i);
  }
}

template <int BITS, int BQ, int BN, int NS, bool RING>
cudaError_t launch_mma_instance(const void* q, const void* docs, const float* scale,
                                const uint8_t* filt, long long filt_stride, int B, int n_docs,
                                int T, int row_bytes, int group, int n_groups, int depth, int K,
                                int splits, int tiles_per_split, bool q_aligned, int d_align,
                                float* part_s, int* part_i, cudaStream_t stream) {
  const size_t smem = mma_smem(BQ, BN, NS, K, RING ? Int8Rows::kSlot : 0);
  auto kernel = fused_topk_quantized_bf16_partial<BITS, BQ, BN, NS, RING>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((B + BQ - 1) / BQ, splits), kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint8_t*>(docs), scale, filt,
      filt_stride, B, n_docs, T, row_bytes, group, n_groups, depth, K, tiles_per_split,
      q_aligned, d_align, part_s, part_i);
  return cudaGetLastError();
}

// The tensor-core pass 1 for the plan's bq; the tile and stages follow from
// (bq, K) as in mma_plan with the register-staged loader's two stages.
template <int BITS>
cudaError_t launch_mma(int bq, const void* q, const void* docs, const float* scale,
                       const uint8_t* filt, long long filt_stride, int B, int n_docs, int T,
                       int row_bytes, int group, int n_groups, int depth, int K, int splits,
                       int tiles_per_split, bool q_aligned, int d_align, float* part_s,
                       int* part_i, cudaStream_t stream) {
  int bn = 0, stages = 0;
  if (!mma_shape(bq, K, kStages, &bn, &stages, Int8Rows::kSlot)) return cudaErrorInvalidValue;
#define FUSED_TOPK_QUANTIZED_MMA(BQ, BN, NS, RING)                                              \
  return launch_mma_instance<BITS, BQ, BN, NS, RING>(q, docs, scale, filt, filt_stride, B,      \
                                                     n_docs, T, row_bytes, group, n_groups,     \
                                                     depth, K, splits, tiles_per_split,         \
                                                     q_aligned, d_align, part_s, part_i, stream)
  // The raw ring copies 8-byte int8 units, 4-byte int4 words and their
  // scales, and 16-byte query packs, so it takes aligned rows.  It is the
  // faster loader on an H100 except for int8 at 64-query tiles, where the
  // widening is cheap and its second barrier a step costs more than it
  // saves (PERF.md: the loader copies of `chip_smoke.py --ablate`).
  const bool ring = d_align >= 8 && q_aligned;
  if (stages == 1) FUSED_TOPK_QUANTIZED_MMA(8, 128, 1, false);
  if (bq == 64) {
    if constexpr (BITS == 4) {
      if (ring) FUSED_TOPK_QUANTIZED_MMA(64, 128, kStages, true);
    }
    FUSED_TOPK_QUANTIZED_MMA(64, 128, kRegStages, false);
  }
  if (ring) FUSED_TOPK_QUANTIZED_MMA(8, 256, kStages, true);
  FUSED_TOPK_QUANTIZED_MMA(8, 256, kRegStages, false);
#undef FUSED_TOPK_QUANTIZED_MMA
}

// ---------------------------------------------------------------------------
// K4 with an f32 query over int8 or int4 rows: the tensor-core pass 1 of
// mma_topk.cuh with the split-TF32 product type
// (fused_topk_quantized_tf32_partial).
// ---------------------------------------------------------------------------

// int8 rows (N, T) under an f32 query: a unit is 4 bytes, the 4 columns of a
// 16-byte f32 pack once widened; one 4-byte load where the row is at least
// 4-byte aligned and holds all 4 (int8 rows of 300 bytes), else byte loads;
// bytes past T, and rows that do not exist, are 0.  Each byte widens exactly
// to f32 (2^23 + (byte ^ 0x80) - (2^23 + 128)), so it is exact in tf32 too,
// and the sum is multiplied by scale[id] once, after the whole row.
struct Int8RowsF32 {
  using Op = MmaTf32;
  using Unit = uint32_t;
  static constexpr bool kAsync = true;  // through a ring of raw units
  static constexpr bool kRaw = true;
  static constexpr int kSlot = 4;
  static constexpr bool kRowScale = true;
  static constexpr bool kChunkScale = false;
  const uint8_t* __restrict__ docs;
  const float* __restrict__ scale;  // (N, 1)
  int T, group, n_groups, align;    // T: the row's bytes (group, n_groups unused)

  __device__ __forceinline__ Unit load(int di, bool ok, int e) const {
    const uint8_t* row = docs + (size_t)di * T;
    if (ok && e + 4 <= T && align >= 4) return *reinterpret_cast<const uint32_t*>(row + e);
    uint32_t u = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) u |= (uint32_t)((ok && e + s < T) ? row[e + s] : 0) << (8 * s);
    return u;
  }
  // The unit's bytes into a 4-byte slot by cp.async (rows 4-byte aligned):
  // bytes past T, and rows that do not exist, zero-filled and not read.
  __device__ __forceinline__ void copy_raw(uint32_t* slot, int di, bool ok, int e) const {
    const int n = ok ? min(max(T - e, 0), 4) : 0;
    cp_async4(slot, n ? docs + (size_t)di * T + e : docs, n);
  }
  __device__ __forceinline__ Unit read_raw(const uint32_t* slot) const { return *slot; }
  // int8 byte c as an exact f32: 2^23 + (c ^ 0x80) - (2^23 + 128).
  __device__ __forceinline__ uint4 widen(Unit u) const {
    const uint32_t w = u ^ 0x80808080u;
    return make_uint4(__float_as_uint(magic_byte(w, 0) - 8388736.0f),
                      __float_as_uint(magic_byte(w, 1) - 8388736.0f),
                      __float_as_uint(magic_byte(w, 2) - 8388736.0f),
                      __float_as_uint(magic_byte(w, 3) - 8388736.0f));
  }
  __device__ __forceinline__ float row_scale(int id) const { return scale[id]; }
};

// Packed int4 rows (N, row_bytes = Tg / 2) under an f32 query: a unit is 2
// bytes (4 nibbles, the 4 columns of a 16-byte f32 pack once widened:
// column 2c the low nibble of byte c, 2c + 1 the high one), and a row's
// 32-column chunk is 8 units and one scale, its group's, all loaded through
// registers (no raw ring: kAsync is false).  No byte past the row is ever
// read: the last chunk ends by round_up(T, 32) <= Tg.  Rows that do not
// exist are never read (their units read nibble 8 and their scale 0).
// Each nibble widens exactly to the f32 nibble - 8, and the chunk's sum is
// multiplied by the scale as it folds (kChunkScale).
struct Int4RowsF32 {
  using Op = MmaTf32;
  using Unit = uint32_t;                 // the 2 bytes in the low half
  static constexpr bool kAsync = false;  // through registers only
  static constexpr bool kRaw = false;
  static constexpr bool kRowScale = false;
  static constexpr bool kChunkScale = true;
  const uint8_t* __restrict__ docs;
  const float* __restrict__ scale;  // (N, n_groups)
  int row_bytes, group, n_groups, align;

  __device__ __forceinline__ Unit load(int di, bool ok, int e) const {
    if (!ok) return 0x8888u;
    const uint8_t* p = docs + (size_t)di * row_bytes + e / 2;
    if (align >= 4) return *reinterpret_cast<const uint16_t*>(p);
    return (uint32_t)p[0] | (uint32_t)p[1] << 8;
  }
  // Row di's scale for the chunk at column e0 (a multiple of 32).
  __device__ __forceinline__ float chunk_scale(int di, bool ok, int e0) const {
    return ok ? scale[(size_t)di * n_groups + e0 / group] : 0.f;
  }
  // nibble n as (2^23 + n) - (2^23 + 8), exact.
  __device__ __forceinline__ uint4 widen(Unit u) const {
    return make_uint4(__float_as_uint(__uint_as_float(0x4B000000u | (u & 0xFu)) - 8388616.0f),
                      __float_as_uint(__uint_as_float(0x4B000000u | (u >> 4 & 0xFu)) - 8388616.0f),
                      __float_as_uint(__uint_as_float(0x4B000000u | (u >> 8 & 0xFu)) - 8388616.0f),
                      __float_as_uint(__uint_as_float(0x4B000000u | (u >> 12 & 0xFu)) - 8388616.0f));
  }
};

template <int BITS>
using F32Rows = std::conditional_t<BITS == 8, Int8RowsF32, Int4RowsF32>;

// The most stages the loader of Rows holds: the raw ring's where it has
// one, else the register loader's.
template <class Rows>
constexpr int f32_stages() {
  return Rows::kAsync ? kStages : kRegStages;
}

template <int BITS, int BQ, int BN, int NS, bool RING>
__global__ void __launch_bounds__(kThreads, 1) fused_topk_quantized_tf32_partial(
    const float* __restrict__ q,        // (B, T)
    const uint8_t* __restrict__ docs,   // (N, row_bytes) int8 or packed int4
    const float* __restrict__ scale,    // (N, n_groups); int8: n_groups = 1
    const uint8_t* __restrict__ filt,   // nullptr | (N,) | (B, N)
    long long filt_stride,              // 0 for (N,), N for (B, N)
    int B, int n_docs, int T, int row_bytes, int group, int n_groups, int depth, int K,
    int tiles_per_split, bool q_aligned, int d_align,
    float* __restrict__ part_s, int* __restrict__ part_i) {  // (splits, B, K)
  const F32Rows<BITS> rows{docs, scale, row_bytes, group, n_groups, d_align};
  mma_topk_pass1<F32Rows<BITS>, BQ, BN, NS, RING>(q, rows, filt, filt_stride, B, n_docs, T,
                                                 depth, K, tiles_per_split, q_aligned ? 16 : 1,
                                                 part_s, part_i);
}

template <int BITS, int BQ, int BN, int NS, bool RING>
cudaError_t launch_tf32_instance(const void* q, const void* docs, const float* scale,
                                 const uint8_t* filt, long long filt_stride, int B, int n_docs,
                                 int T, int row_bytes, int group, int n_groups, int depth, int K,
                                 int splits, int tiles_per_split, bool q_aligned, int d_align,
                                 float* part_s, int* part_i, cudaStream_t stream) {
  using Rows = F32Rows<BITS>;
  const size_t smem =
      mma_smem(BQ, BN, NS, K, RING ? raw_slot<Rows>() : 0, chunk_scale_bytes<Rows>());
  auto kernel = fused_topk_quantized_tf32_partial<BITS, BQ, BN, NS, RING>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((B + BQ - 1) / BQ, splits), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(docs), scale, filt, filt_stride,
      B, n_docs, T, row_bytes, group, n_groups, depth, K, tiles_per_split, q_aligned, d_align,
      part_s, part_i);
  return cudaGetLastError();
}

// The split-TF32 pass 1 for the plan's bq; the tile and stages follow from
// (bq, K) as in mma_plan.  Over int8 rows the raw ring takes rows 4-byte
// aligned (4-byte copies) and query rows 16-byte aligned, and is the faster
// loader there at every instance; other int8 rows, and every int4 row, go
// through registers.
template <int BITS>
cudaError_t launch_tf32(int bq, const void* q, const void* docs, const float* scale,
                        const uint8_t* filt, long long filt_stride, int B, int n_docs, int T,
                        int row_bytes, int group, int n_groups, int depth, int K, int splits,
                        int tiles_per_split, bool q_aligned, int d_align, float* part_s,
                        int* part_i, cudaStream_t stream) {
  using Rows = F32Rows<BITS>;
  int bn = 0, stages = 0;
  if (!mma_shape(bq, K, f32_stages<Rows>(), &bn, &stages, raw_slot<Rows>(),
                 chunk_scale_bytes<Rows>()))
    return cudaErrorInvalidValue;
#define FUSED_TOPK_QUANTIZED_TF32(BQ, BN, NS, RING)                                             \
  return launch_tf32_instance<BITS, BQ, BN, NS, RING>(q, docs, scale, filt, filt_stride, B,     \
                                                      n_docs, T, row_bytes, group, n_groups,    \
                                                      depth, K, splits, tiles_per_split,        \
                                                      q_aligned, d_align, part_s, part_i, stream)
  if (stages == 1) FUSED_TOPK_QUANTIZED_TF32(8, 128, 1, false);
  if constexpr (Rows::kAsync) {  // int8 rows
    const bool ring = d_align >= 4 && q_aligned;
    if (ring && bq == 64) FUSED_TOPK_QUANTIZED_TF32(64, 128, kStages, true);
    if (ring) FUSED_TOPK_QUANTIZED_TF32(8, 256, kStages, true);
  }
  if (bq == 64) FUSED_TOPK_QUANTIZED_TF32(64, 128, kRegStages, false);
  FUSED_TOPK_QUANTIZED_TF32(8, 256, kRegStages, false);
#undef FUSED_TOPK_QUANTIZED_TF32
}

// ---------------------------------------------------------------------------
// K5: pass 1 over gathered packed rows (fused_topk_gathered_quantized_partial).
// ---------------------------------------------------------------------------

// A K5 unit is 8 bytes of a packed row: 16 int4 columns (inside one group,
// as groups are multiples of 32 columns) or 8 int8 columns.  A quarter-warp
// reads a row's units in turn (lane l of the quarter units l, l + 8, ...),
// so a unit round is 8 units; a lane scores kRowsPerLane rows of its
// quarter at once, and holds a chunk of kUnitRounds rounds of their units
// in registers, the next chunk's loads in flight.
__host__ __device__ constexpr int unit_cols(int bits) { return bits == 8 ? 8 : 16; }
template <int BITS> constexpr int kUnitCols = unit_cols(BITS);
constexpr int kRowsPerLane = 2;
constexpr int kUnitRounds = 5;  // int4 rows up to T = 640, int8 up to 320: one chunk

// Units that hold the query's T columns (an int4 row's last units past T,
// which only padding fills, are never read), and the f32 query of a K5
// block in shared memory, padded to whole chunks with 0: column e of unit u
// sits at float4 ((u / 8) * kUnitCols / 4 + e / 4) * 8 + u % 8, component
// e % 4, so the 8 lanes of a quarter read 8 consecutive float4s and the 4
// quarters read the same ones.
__host__ __device__ constexpr int k5_units(int t, int bits) {
  return (t + unit_cols(bits) - 1) / unit_cols(bits);
}
__host__ __device__ constexpr int k5_chunks(int t, int bits) {
  return (k5_units(t, bits) + 8 * kUnitRounds - 1) / (8 * kUnitRounds);
}
__host__ __device__ constexpr size_t k5_query_bytes(int t, int bits) {
  return (size_t)k5_chunks(t, bits) * kUnitRounds * 8 * unit_cols(bits) * sizeof(float);
}

// Bytes [b0, b0 + 8) of a row of `len` bytes that starts ALIGN-byte aligned
// (8, 4 or 1): one 8-byte load, two 4-byte loads (an int8 row's last unit
// may hold 4 bytes), or byte loads; bytes past `len` are 0.
template <int ALIGN>
__device__ __forceinline__ uint2 load_unit(const uint8_t* row, int b0, int len) {
  if constexpr (ALIGN >= 8) {
    return *reinterpret_cast<const uint2*>(row + b0);
  } else if constexpr (ALIGN >= 4) {
    return make_uint2(*reinterpret_cast<const uint32_t*>(row + b0),
                      b0 + 4 < len ? *reinterpret_cast<const uint32_t*>(row + b0 + 4) : 0u);
  } else {
    union { uint2 u; uint8_t b[8]; } p;
#pragma unroll
    for (int s = 0; s < 8; ++s) p.b[s] = b0 + s < len ? row[b0 + s] : 0;
    return p.u;
  }
}

// A lane's units of a chunk: for each of its rows and unit rounds, the
// unit and (int4) its group's scale.  Units past the row's last, and rows
// whose id is outside [0, n_docs), are never read: they hold 0, which
// scores 0 against the query's zero padding.
struct K5Chunk {
  uint2 unit[kRowsPerLane][kUnitRounds];
  float gs[kRowsPerLane][kUnitRounds];
};

// Where a lane's units of chunk `chunk` lie in every row: for each unit
// round, the unit and (int4) its group's scale column.
struct K5Cols {
  int unit[kUnitRounds];
  int group[kUnitRounds];
};

template <int BITS>
__device__ __forceinline__ K5Cols k5_cols(int chunk, int lane8, int group) {
  K5Cols c;
#pragma unroll
  for (int j = 0; j < kUnitRounds; ++j) {
    c.unit[j] = (chunk * kUnitRounds + j) * 8 + lane8;
    c.group[j] = BITS == 4 ? kUnitCols<4> * c.unit[j] / group : 0;
  }
  return c;
}

template <int BITS, int ALIGN>
__device__ __forceinline__ void k5_load(K5Chunk& ch, const uint8_t* __restrict__ store,
                                        const float* __restrict__ scale,
                                        const int (&id)[kRowsPerLane], const K5Cols& cols,
                                        int n_units, int n_docs, int row_bytes, int n_groups) {
#pragma unroll
  for (int h = 0; h < kRowsPerLane; ++h) {
    const bool ok = static_cast<unsigned>(id[h]) < static_cast<unsigned>(n_docs);
    const uint8_t* row = store + (size_t)(ok ? id[h] : 0) * row_bytes;
    const float* srow = scale + (size_t)(ok ? id[h] : 0) * n_groups;
#pragma unroll
    for (int j = 0; j < kUnitRounds; ++j) {
      const bool live = ok && cols.unit[j] < n_units;
      ch.unit[h][j] = live ? load_unit<ALIGN>(row, 8 * cols.unit[j], row_bytes) : make_uint2(0, 0);
      ch.gs[h][j] = BITS == 4 && live ? srow[cols.group[j]] : 0.f;
    }
  }
}

__device__ __forceinline__ void round_bf16_pair(float& a, float& b) {
  const uint32_t p = bf16x2_rn(a, b);
  a = __uint_as_float(p << 16);
  b = __uint_as_float(p & 0xFFFF0000u);
}

// acc + the products of the query's columns of a unit (qv) with the unit's
// values, in the reference's dequant: an int8 byte widened exactly (the sign
// bits flipped once a word, then 2^23 + byte - (2^23 + 128)); an int4 nibble
// as f32(nibble - 8) * gs, two of them rounded to bf16 at once for a bf16
// query (round_bf16_pair).
template <int QT, int BITS>
__device__ __forceinline__ float k5_dot(float acc, const float (&qv)[kUnitCols<BITS>], uint2 unit,
                                        float gs) {
  const uint32_t w[2] = {unit.x, unit.y};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if constexpr (BITS == 8) {
      const uint32_t x = w[k] ^ 0x80808080u;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc = fmaf(qv[4 * k + c], magic_byte(x, c) - 8388736.0f, acc);
    } else {
      const uint32_t lo = w[k] & 0x0F0F0F0Fu, hi = (w[k] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a = (magic_byte(lo, c) - 8388616.0f) * gs;
        float b = (magic_byte(hi, c) - 8388616.0f) * gs;
        if constexpr (QT == kQBF16) round_bf16_pair(a, b);
        acc = fmaf(qv[8 * k + 2 * c], a, acc);
        acc = fmaf(qv[8 * k + 2 * c + 1], b, acc);
      }
    }
  }
  return acc;
}

// The products of a chunk: each unit round's query columns read once from
// shared memory (kUnitCols / 4 float4s) for both rows.
template <int QT, int BITS>
__device__ __forceinline__ void k5_chunk(float (&acc)[kRowsPerLane], const K5Chunk& ch,
                                         const float4* qs, int chunk, int n_rounds, int lane8) {
  constexpr int kQuads = kUnitCols<BITS> / 4;
#pragma unroll
  for (int j = 0; j < kUnitRounds; ++j) {
    const int jr = chunk * kUnitRounds + j;
    if (jr >= n_rounds) break;
    float qv[kUnitCols<BITS>];
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      const float4 v = qs[(jr * kQuads + k) * 8 + lane8];
      qv[4 * k] = v.x;
      qv[4 * k + 1] = v.y;
      qv[4 * k + 2] = v.z;
      qv[4 * k + 3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < kRowsPerLane; ++h)
      acc[h] = k5_dot<QT, BITS>(acc[h], qv, ch.unit[h][j], ch.gs[h][j]);
  }
}

// Grid (B, splits): block (b, split) owns rows [split * rows_per_split, ...)
// of query b's R kept rows and keeps one running list of K for them, as K3
// does.  The block scores kRowRound rows a round, a row a thread (lane l of
// warp w: the warp's row l), each warp its 32 in 4 steps of 8: quarter q of
// the warp reads rows 2q and 2q + 1 of the step, its lanes a unit of each at
// a time, loaded a chunk ahead (ALIGN-byte loads: rows start 8-, 4- or
// 1-byte aligned).  The quarter's sums meet in 3 shuffles, and the lane
// that owns a row takes its score.  A score that precedes the list's
// depth-th entry (the full comparator: ids arrive in any order) goes to the
// block's candidate buffer; once the buffer holds more than kRowFlushAt, or
// after the last round, the whole block merges it into the list by counting
// (merge_buffer) and refreshes the threshold.  A row whose id is outside [0,
// n_docs) is never read and never ranks; an id that comes twice is scored
// and ranked twice, as the reference ranks it.
template <int QT, int BITS, int ALIGN>
__global__ void __launch_bounds__(kThreads, kRowBlocksPerSm) fused_topk_gathered_quantized_partial(
    const typename Query<QT>::Raw* __restrict__ q,  // (B, T)
    const uint8_t* __restrict__ store,              // (N, row_bytes)
    const float* __restrict__ scale,                // (N, n_groups)
    const int* __restrict__ row_ids,                // (B, R)
    int B, int R, int n_docs, int T, int row_bytes, int group, int n_groups, int depth, int K,
    int rows_per_split, float* __restrict__ part_s, int* __restrict__ part_i) {  // (splits, B, K)
  constexpr int kCols = kUnitCols<BITS>;
  constexpr int kQuads = kCols / 4;

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t q_bytes = k5_query_bytes(T, BITS);
  const float4* qs = reinterpret_cast<const float4*>(smem);
  float* qf = reinterpret_cast<float*>(smem);
  float* ls = reinterpret_cast<float*>(smem + q_bytes);  // K running scores
  int* li = reinterpret_cast<int*>(ls + K);               // K running ids
  float* cs = reinterpret_cast<float*>(li + K);           // kRowCap candidates
  int* ci = reinterpret_cast<int*>(cs + kRowCap);
  float* ts = reinterpret_cast<float*>(ci + kRowCap);      // the list's depth-th entry
  int* ti = reinterpret_cast<int*>(ts + 1);
  int* cnt = ti + 1;                                       // candidates in the buffer

  const int tid = threadIdx.x, lane = tid & 31, lane8 = lane & 7, quarter = lane >> 3;
  const int b = blockIdx.x, split = blockIdx.y;
  const int row0 = split * rows_per_split;
  const int row1 = min(R, row0 + rows_per_split);
  const int n_rounds = (max(0, row1 - row0) + kRowRound - 1) / kRowRound;
  const int n_units = k5_units(T, BITS);
  const int n_unit_rounds = (n_units + 7) / 8;
  const int n_chunks = k5_chunks(T, BITS);

  for (int col = tid; col < (int)(q_bytes / 4); col += kThreads) {
    const int u = col / kCols, e = col % kCols;
    qf[(((u / 8) * kQuads + e / 4) * 8 + u % 8) * 4 + e % 4] =
        col < T ? widen<QT>(q[(size_t)b * T + col]) : 0.f;
  }
  for (int c = tid; c < K; c += kThreads) { ls[c] = -INFINITY; li[c] = kBigId; }
  if (tid == 0) { *ts = -INFINITY; *ti = kBigId; *cnt = 0; }
  __syncthreads();

  // Thread t holds the id of row t of each round: this round's, the next
  // one's (for the loads issued ahead) and the one after, loaded a round
  // ahead.
  const int* ids = row_ids + (size_t)b * R;
  const auto round_id = [&](int round) {
    const int r = row0 + round * kRowRound + tid;
    return round < n_rounds && r < row1 ? ids[r] : kBigId;
  };
  int my_id = round_id(0), next_id = round_id(1), after_id = round_id(2);
  // The chunk the next fetch loads, (fround, fstep, fchunk): this round's or
  // the next one's; this lane's rows of a step are the warp's rows 8 step +
  // 2 quarter + h.  cols holds where chunk cols_chunk lies in every row.
  int fround = 0, fstep = 0, fchunk = 0, cols_chunk = 0;
  K5Cols cols = k5_cols<BITS>(0, lane8, group);
  K5Chunk cur, nxt;
  const auto fetch = [&](int round) {
    if (fround < n_rounds) {
      const int src = fround == round ? my_id : next_id;
      int id[kRowsPerLane];
#pragma unroll
      for (int h = 0; h < kRowsPerLane; ++h)
        id[h] = __shfl_sync(kFull, src, 8 * fstep + kRowsPerLane * quarter + h);
      if (fchunk != cols_chunk) {
        cols = k5_cols<BITS>(fchunk, lane8, group);
        cols_chunk = fchunk;
      }
      k5_load<BITS, ALIGN>(nxt, store, scale, id, cols, n_units, n_docs, row_bytes, n_groups);
    }
    if (++fchunk == n_chunks) {
      fchunk = 0;
      if (++fstep == 4) { fstep = 0; ++fround; }
    }
  };
  fetch(0);
  cur = nxt;
  for (int round = 0; round < n_rounds; ++round) {
    const bool my_ok = static_cast<unsigned>(my_id) < static_cast<unsigned>(n_docs);
    const float my_scale = BITS == 8 && my_ok ? scale[my_id] : 1.f;
    float my_s = -INFINITY;
    for (int step = 0; step < 4; ++step) {
      float acc[kRowsPerLane] = {0.f, 0.f};
      for (int chunk = 0; chunk < n_chunks; ++chunk) {
        fetch(round);  // the next chunk's loads go out before this chunk's products
        k5_chunk<QT, BITS>(acc, cur, qs, chunk, n_unit_rounds, lane8);
        cur = nxt;
      }
      // The quarter's sums of its two rows, transposed: lanes 0-3 of the
      // quarter end with row 2 quarter's, lanes 4-7 with row 2 quarter + 1's.
      const bool upper = (lane & 4) != 0;
      float s = upper ? acc[1] : acc[0];
      s += __shfl_xor_sync(kFull, upper ? acc[0] : acc[1], 4);
      s += __shfl_xor_sync(kFull, s, 2);
      s += __shfl_xor_sync(kFull, s, 1);
      const float v = __shfl_sync(kFull, s, (lane & 6) << 2 | (lane & 1) << 2);
      if (quarter == step) my_s = v;  // lane 8 step + i owns the step's row i
    }
    if (BITS == 8) my_s *= my_scale;  // the per-doc scale, once after the sum
    // Ids arrive in any order, so the test against the depth-th entry uses
    // the full comparator: a tied score with a lower id still enters.  A
    // stale threshold only lets more in.
    const bool pass = my_ok && precedes(my_s, my_id, *ts, *ti);
    const unsigned m = __ballot_sync(kFull, pass);
    bool full = false;
    if (m != 0) {
      int base = 0;
      if (lane == 0) base = atomicAdd(cnt, __popc(m));
      base = __shfl_sync(kFull, base, 0);
      if (pass) {
        const int c = base + __popc(m & ((1u << lane) - 1u));
        cs[c] = my_s;
        ci[c] = my_id;
      }
      full = base + __popc(m) > kRowFlushAt;
    }
    // The block's buffer merges once it holds more than kRowFlushAt (or
    // after the last round); until then it has room for the next round.
    if (__syncthreads_or(full) || round + 1 == n_rounds) {
      const int n = *cnt;
      if (n > 0) {  // block-uniform
        merge_buffer<kRowCap, kThreads, true>(ls, li, K, depth, cs, ci, n, tid);
        __syncthreads();
        if (tid == 0) { *ts = ls[depth - 1]; *ti = li[depth - 1]; *cnt = 0; }
      }
      __syncthreads();
    }
    my_id = next_id;
    next_id = after_id;
    after_id = round_id(round + 3);
  }

  const size_t out = ((size_t)split * B + b) * K;
  for (int c = tid; c < K; c += kThreads) {
    part_s[out + c] = ls[c];
    part_i[out + c] = li[c];
  }
}

template <int QT, int BITS, int ALIGN>
cudaError_t launch_gathered_instance(const void* q, const void* store, const float* scale,
                                     const int* row_ids, int B, int R, int n_docs, int T,
                                     int row_bytes, int group, int n_groups, int depth, int K,
                                     int splits, int rows_per_split, float* part_s, int* part_i,
                                     cudaStream_t stream) {
  const size_t smem = row_block_smem(k5_query_bytes(T, BITS), K);
  auto kernel = fused_topk_gathered_quantized_partial<QT, BITS, ALIGN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, splits), kThreads, smem, stream>>>(
      static_cast<const typename Query<QT>::Raw*>(q), static_cast<const uint8_t*>(store), scale,
      row_ids, B, R, n_docs, T, row_bytes, group, n_groups, depth, K, rows_per_split, part_s,
      part_i);
  return cudaGetLastError();
}

// K5's pass 1 for rows that start `align`-byte aligned (16, 8, 4 or 1).
template <int QT, int BITS>
cudaError_t launch_gathered(const void* q, const void* store, const float* scale,
                            const int* row_ids, int B, int R, int n_docs, int T, int row_bytes,
                            int group, int n_groups, int depth, int K, int splits,
                            int rows_per_split, int align, float* part_s, int* part_i,
                            cudaStream_t stream) {
#define FUSED_TOPK_GATHERED_QUANTIZED(ALIGN)                                                    \
  return launch_gathered_instance<QT, BITS, ALIGN>(q, store, scale, row_ids, B, R, n_docs, T,   \
                                                   row_bytes, group, n_groups, depth, K, splits, \
                                                   rows_per_split, part_s, part_i, stream)
  if (align >= 8) FUSED_TOPK_GATHERED_QUANTIZED(8);
  if (align >= 4) FUSED_TOPK_GATHERED_QUANTIZED(4);
  FUSED_TOPK_GATHERED_QUANTIZED(1);
#undef FUSED_TOPK_GATHERED_QUANTIZED
}

// The operands every entry checks: a query dtype, a width, and for int4 a
// group that is a multiple of the 32-column chunk (so a chunk or a pack never
// straddles two groups) with its packed row and scale widths.
bool operands_ok(int qdtype, int bits, int T, int row_bytes, int group, int n_groups) {
  if ((qdtype != kQF32 && qdtype != kQBF16) || T <= 0) return false;
  if (bits == 8) return row_bytes == T && n_groups == 1;
  if (bits != 4 || group <= 0 || group % 32 != 0) return false;
  const int tg = (T + group - 1) / group * group;
  return row_bytes * 2 == tg && n_groups * group == tg;
}

}  // namespace

extern "C" {

// K4's launch plan for a query of `qdtype` (0 f32, 1 bf16) over packed rows
// of `bits` (8 or 4): mma_plan (mma_topk.cuh) with the loader of the
// policy the launch takes.
int fused_topk_quantized_plan(int qdtype, int bits, int B, int n_docs, int depth, int sm_count,
                              int* plan) {
  if ((qdtype != kQF32 && qdtype != kQBF16) || (bits != 8 && bits != 4))
    return (int)cudaErrorInvalidValue;
  if (qdtype == kQBF16) return mma_plan(B, n_docs, depth, sm_count, kStages, plan, Int8Rows::kSlot);
  if (bits == 8) return mma_plan(B, n_docs, depth, sm_count, kStages, plan, Int8RowsF32::kSlot);
  return mma_plan(B, n_docs, depth, sm_count, f32_stages<Int4RowsF32>(), plan, 0,
                  chunk_scale_bytes<Int4RowsF32>());
}

// Both passes of K4 on `stream`, with the plan of fused_topk_quantized_plan;
// returns the first cudaError_t (0 = launched).  qdtype: 0 f32 (tensor cores
// in two tf32 passes), 1 bf16 (tensor cores).  bits 8: docs (N, T) int8,
// scale (N, 1); bits 4:
// docs (N, row_bytes) packed, row_bytes = Tg / 2, scale (N, n_groups),
// n_groups = Tg / group.  d_align, q_align: the byte alignment every doc /
// query row starts at (16, 8, 4, or less).
int fused_topk_quantized_launch(int qdtype, int bits, int bq, const void* q, const void* docs,
                                const void* scale, const void* filt, long long filt_stride,
                                int B, int n_docs, int T, int row_bytes, int group,
                                int n_groups, int depth, int K, int splits, int tiles_per_split,
                                int d_align, int q_align, void* part_s, void* part_i,
                                void* out_s, void* out_i, void* stream) {
  if (!operands_ok(qdtype, bits, T, row_bytes, group, n_groups) || K % 32 != 0 || depth > K ||
      B <= 0 || n_docs <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const uint8_t* f = static_cast<const uint8_t*>(filt);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  const bool q_aligned = q_align == 16;
  cudaError_t err;
  if (qdtype == kQBF16 && bits == 8)
    err = launch_mma<8>(bq, q, docs, sc, f, filt_stride, B, n_docs, T, row_bytes, group,
                        n_groups, depth, K, splits, tiles_per_split, q_aligned, d_align, ps, pi,
                        st);
  else if (qdtype == kQBF16)
    err = launch_mma<4>(bq, q, docs, sc, f, filt_stride, B, n_docs, T, row_bytes, group,
                        n_groups, depth, K, splits, tiles_per_split, q_aligned, d_align, ps, pi,
                        st);
  else if (bits == 8)
    err = launch_tf32<8>(bq, q, docs, sc, f, filt_stride, B, n_docs, T, row_bytes, group,
                         n_groups, depth, K, splits, tiles_per_split, q_aligned, d_align, ps, pi,
                         st);
  else
    err = launch_tf32<4>(bq, q, docs, sc, f, filt_stride, B, n_docs, T, row_bytes, group,
                         n_groups, depth, K, splits, tiles_per_split, q_aligned, d_align, ps, pi,
                         st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(ps, pi, splits, B, K, depth, out_s, out_i, st);
}

// K5's launch plan for R kept rows of T columns: gathered_row_plan
// (topk_merge.cuh, K3's) with the f32 query's shared memory.
int fused_topk_gathered_quantized_plan(int bits, int B, int R, int T, int depth, int sm_count,
                                       int* plan) {
  if ((bits != 8 && bits != 4) || T <= 0) return (int)cudaErrorInvalidValue;
  return gathered_row_plan(B, R, depth, k5_query_bytes(T, bits), sm_count, plan);
}

// Both passes of K5 on `stream`, with the plan of
// fused_topk_gathered_quantized_plan; returns the first cudaError_t (0 =
// launched).  Operands as for fused_topk_quantized_launch, with the (B, R)
// int32 row ids; align: the byte alignment every stored row starts at.
int fused_topk_gathered_quantized_launch(int qdtype, int bits, const void* q, const void* store,
                                         const void* scale, const void* row_ids, int B, int R,
                                         int n_docs, int T, int row_bytes, int group,
                                         int n_groups, int depth, int K, int splits,
                                         int rows_per_split, int align, void* part_s,
                                         void* part_i, void* out_s, void* out_i, void* stream) {
  if (!operands_ok(qdtype, bits, T, row_bytes, group, n_groups) || K % 32 != 0 || depth > K ||
      depth > R || B <= 0 || R <= 0 || n_docs <= 0 || splits <= 0 || rows_per_split % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const int* rid = static_cast<const int*>(row_ids);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  cudaError_t err;
  if (qdtype == kQBF16 && bits == 8)
    err = launch_gathered<kQBF16, 8>(q, store, sc, rid, B, R, n_docs, T, row_bytes, group,
                                     n_groups, depth, K, splits, rows_per_split, align, ps, pi, st);
  else if (qdtype == kQBF16)
    err = launch_gathered<kQBF16, 4>(q, store, sc, rid, B, R, n_docs, T, row_bytes, group,
                                     n_groups, depth, K, splits, rows_per_split, align, ps, pi, st);
  else if (bits == 8)
    err = launch_gathered<kQF32, 8>(q, store, sc, rid, B, R, n_docs, T, row_bytes, group,
                                    n_groups, depth, K, splits, rows_per_split, align, ps, pi, st);
  else
    err = launch_gathered<kQF32, 4>(q, store, sc, rid, B, R, n_docs, T, row_bytes, group,
                                    n_groups, depth, K, splits, rows_per_split, align, ps, pi, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(ps, pi, splits, B, K, depth, out_s, out_i, st);
}

const char* fused_topk_quantized_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
