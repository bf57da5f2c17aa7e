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
// K5 is K3's pass 1 (one query per block, a row-split plan that fills
// the SMs at B = 1, a warp reading whole rows by id with 8 rows' loads in
// flight, ids outside [0, n_docs) never read, the full comparator since ids
// arrive in any order) over packed rows: each lane dequantizes its 16-byte
// packs in registers against the query, held in shared memory as f32 in a
// lane-interleaved layout (one conflict-free 16-byte read per 4 columns).
// The sorted insert, the list merge and pass 2 are topk_merge.cuh's.

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

// An int4 value in the query dtype, as an f32: (nibble - 8) * group scale in
// f32, rounded once to bf16 for a bf16 query.  nibble - 8 comes exactly from
// the float 2^23 + nibble.
template <int QT> __device__ __forceinline__ float int4_value(uint32_t nib, float gscale) {
  const float v = (__uint_as_float(0x4B000000u | nib) - 8388616.0f) * gscale;
  if constexpr (QT == kQBF16) return __bfloat162float(__float2bfloat16_rn(v));
  else return v;
}

// A stored int8 byte as an exact f32 (2^23 + the byte with its sign bit
// flipped, minus 2^23 + 128).
__device__ __forceinline__ float int8_value(uint32_t byte) {
  return __uint_as_float(0x4B000000u | (byte ^ 0x80u)) - 8388736.0f;
}

union Pack16 { uint4 u; uint8_t b[16]; };

// Bytes [b0, b0 + 16 * NV) of a row of `len` bytes: 16-byte loads where the
// row is 16-byte aligned, 8-byte loads where it is 8-byte aligned (int8 rows
// of 600 bytes), byte loads at the row's end or otherwise; bytes past `len`
// are `pad`.  b0 is a multiple of 16.
template <int NV>
__device__ __forceinline__ void load_bytes(const uint8_t* row, int b0, int len, int align,
                                           uint8_t pad, Pack16 (&out)[NV]) {
  if (b0 + 16 * NV <= len && align >= 8) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (align >= 16) {
        out[v].u = *reinterpret_cast<const uint4*>(row + b0 + 16 * v);
      } else {
        const uint2 lo = *reinterpret_cast<const uint2*>(row + b0 + 16 * v);
        const uint2 hi = *reinterpret_cast<const uint2*>(row + b0 + 16 * v + 8);
        out[v].u = make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
    }
    return;
  }
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int e = b0 + 16 * v + s;
      out[v].b[s] = e < len ? row[e] : pad;
    }
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
// that do not exist are never read.  Each nibble widens as the reference's
// int4_value<kQBF16>: bf16(f32(nibble - 8) * scale).
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
// to f32 (as int8_value), so it is exact in tf32 too, and the sum is
// multiplied by scale[id] once, after the whole row.
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

// Columns one lane's 16-byte pack covers: 16 int8 values or 32 nibbles.
template <int BITS> constexpr int kPackCols = BITS == 8 ? 16 : 32;

// The f32 query of a K5 block in shared memory, padded to whole rounds of 32
// packs: pack p = lane + 32 * j, columns [p * kPackCols, ...).  Column
// 4 * k4 + e of pack p sits at float4 (j * kPackCols / 4 + k4) * 32 + lane,
// component e, so the 32 lanes read 32 consecutive float4s.
__host__ __device__ constexpr int gathered_rounds(int t, int pack_cols) {
  return (t + 32 * pack_cols - 1) / (32 * pack_cols);
}
constexpr size_t gathered_query_bytes(int t, int pack_cols) {
  return (size_t)gathered_rounds(t, pack_cols) * 32 * pack_cols * sizeof(float);
}

// Grid (B, splits): block (b, split) owns rows [split * rows_per_split, ...)
// of query b's R kept rows.  Each warp takes 32-row groups in turn; its lanes
// read a row together (lane l the 16-byte packs l, l + 32, ...), kGatherRows
// rows at a time, dequantize each pack in registers, reduce each row's sum
// across the warp, and lane r keeps row r's score.  The warp merges its 32
// candidates into its own running list; at the end warp 0 merges the other
// warps' lists and writes the block's sorted list.  A row whose id is outside
// [0, n_docs) is never read and never ranks.
template <int QT, int BITS>
__global__ void __launch_bounds__(kThreads, 2) fused_topk_gathered_quantized_partial(
    const typename Query<QT>::Raw* __restrict__ q,  // (B, T)
    const uint8_t* __restrict__ store,              // (N, row_bytes)
    const float* __restrict__ scale,                // (N, n_groups)
    const int* __restrict__ row_ids,                // (B, R)
    int B, int R, int n_docs, int T, int row_bytes, int group, int n_groups, int K,
    int rows_per_split, int align,
    float* __restrict__ part_s, int* __restrict__ part_i) {  // (splits, B, K)
  constexpr int kCols = kPackCols<BITS>;
  constexpr int kQuads = kCols / 4;  // float4s of query per pack

  extern __shared__ __align__(16) unsigned char smem[];
  const int n_rounds = gathered_rounds(T, kCols);
  float4* qs = reinterpret_cast<float4*>(smem);  // n_rounds x kQuads x 32
  float* ls = reinterpret_cast<float*>(qs + n_rounds * kQuads * 32);  // kWarps x K scores
  int* li = reinterpret_cast<int*>(ls + kWarps * K);                  // kWarps x K ids

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, split = blockIdx.y;
  const int row0 = split * rows_per_split;
  const int row1 = min(R, row0 + rows_per_split);
  const int n_groups_rows = (max(0, row1 - row0) + 31) / 32;

  float* qf = reinterpret_cast<float*>(qs);
  for (int col = tid; col < n_rounds * 32 * kCols; col += kThreads) {
    const int p = col / kCols, within = col % kCols;
    const int slot = ((p / 32) * kQuads + within / 4) * 32 + p % 32;
    qf[slot * 4 + within % 4] = col < T ? widen<QT>(q[(size_t)b * T + col]) : 0.f;
  }
  float* rs = ls + warp * K;
  int* ri = li + warp * K;
  for (int c = lane; c < K; c += 32) { rs[c] = -INFINITY; ri[c] = kBigId; }
  __syncthreads();

  const int* ids = row_ids + (size_t)b * R;
  for (int g = warp; g < n_groups_rows; g += kWarps) {
    const int r = row0 + g * 32 + lane;
    const int my_id = r < row1 ? ids[r] : kBigId;
    const bool my_ok = static_cast<unsigned>(my_id) < static_cast<unsigned>(n_docs);
    float my_s = -INFINITY;
#pragma unroll 1
    for (int u0 = 0; u0 < 32; u0 += kGatherRows) {
      int id[kGatherRows];
      float acc[kGatherRows];
#pragma unroll
      for (int u = 0; u < kGatherRows; ++u) {
        id[u] = __shfl_sync(kFull, my_id, u0 + u);
        acc[u] = 0.f;
      }
      for (int j = 0; j < n_rounds; ++j) {
        const int e0 = (lane + 32 * j) * kCols;
        if (e0 >= T) break;
        Pack16 dv[kGatherRows][1];
        float gs[kGatherRows];
#pragma unroll
        for (int u = 0; u < kGatherRows; ++u) {
          const bool ok = static_cast<unsigned>(id[u]) < static_cast<unsigned>(n_docs);
          gs[u] = 0.f;
          if (!ok) {  // an id out of range is never read
            dv[u][0].u = make_uint4(0, 0, 0, 0);
          } else if constexpr (BITS == 8) {
            load_bytes<1>(store + (size_t)id[u] * row_bytes, e0, row_bytes, align, 0, dv[u]);
          } else {
            load_bytes<1>(store + (size_t)id[u] * row_bytes, e0 / 2, row_bytes, align, kInt4Pad,
                          dv[u]);
            gs[u] = scale[(size_t)id[u] * n_groups + e0 / group];
          }
        }
#pragma unroll
        for (int k4 = 0; k4 < kQuads; ++k4) {
          const float4 qv = qs[(j * kQuads + k4) * 32 + lane];
          const float qe[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
          for (int u = 0; u < kGatherRows; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = 4 * k4 + e;
              float v;
              if constexpr (BITS == 8) {
                v = int8_value(dv[u][0].b[c]);
              } else {
                const uint32_t byte = dv[u][0].b[c / 2];
                v = int4_value<QT>((c & 1) ? byte >> 4 : byte & 0xFu, gs[u]);
              }
              acc[u] = fmaf(qe[e], v, acc[u]);
            }
        }
      }
#pragma unroll
      for (int u = 0; u < kGatherRows; ++u) {
        const float tot = warp_sum(acc[u]);
        if (lane == u0 + u) my_s = tot;
      }
    }
    if (BITS == 8 && my_ok) my_s *= scale[my_id];  // the per-doc scale, once after the sum
    // Ids arrive in any order, so the check against the K-th entry uses the
    // full comparator: a tied score with a lower id still enters.
    unsigned mask = __ballot_sync(kFull, my_ok && precedes(my_s, my_id, rs[K - 1], ri[K - 1]));
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const float cs = __shfl_sync(kFull, my_s, src);
      const int cid = __shfl_sync(kFull, my_id, src);
      if (precedes(cs, cid, rs[K - 1], ri[K - 1])) warp_insert(rs, ri, K, cs, cid, lane);
    }
  }

  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kWarps; ++w) merge_sorted(rs, ri, ls + w * K, li + w * K, K, lane);
  const size_t out = ((size_t)split * B + b) * K;
  for (int c = lane; c < K; c += 32) {
    part_s[out + c] = rs[c];
    part_i[out + c] = ri[c];
  }
}

template <int QT, int BITS>
cudaError_t launch_gathered(const void* q, const void* store, const float* scale,
                            const int* row_ids, int B, int R, int n_docs, int T, int row_bytes,
                            int group, int n_groups, int K, int splits, int rows_per_split,
                            int align, float* part_s, int* part_i, cudaStream_t stream) {
  const size_t smem =
      gathered_query_bytes(T, kPackCols<BITS>) + (size_t)kWarps * K * (sizeof(float) + sizeof(int));
  auto kernel = fused_topk_gathered_quantized_partial<QT, BITS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, splits), kThreads, smem, stream>>>(
      static_cast<const typename Query<QT>::Raw*>(q), static_cast<const uint8_t*>(store), scale,
      row_ids, B, R, n_docs, T, row_bytes, group, n_groups, K, rows_per_split, align, part_s,
      part_i);
  return cudaGetLastError();
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

// K5's launch plan for R kept rows of T columns: gathered_plan
// (topk_merge.cuh) with the f32 query's shared memory.
int fused_topk_gathered_quantized_plan(int bits, int B, int R, int T, int depth, int sm_count,
                                       int* plan) {
  if ((bits != 8 && bits != 4) || T <= 0) return (int)cudaErrorInvalidValue;
  const size_t query_bytes = gathered_query_bytes(T, bits == 8 ? kPackCols<8> : kPackCols<4>);
  return gathered_plan(B, R, depth, query_bytes, sm_count, plan);
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
                                     n_groups, K, splits, rows_per_split, align, ps, pi, st);
  else if (qdtype == kQBF16)
    err = launch_gathered<kQBF16, 4>(q, store, sc, rid, B, R, n_docs, T, row_bytes, group,
                                     n_groups, K, splits, rows_per_split, align, ps, pi, st);
  else if (bits == 8)
    err = launch_gathered<kQF32, 8>(q, store, sc, rid, B, R, n_docs, T, row_bytes, group,
                                    n_groups, K, splits, rows_per_split, align, ps, pi, st);
  else
    err = launch_gathered<kQF32, 4>(q, store, sc, rid, B, R, n_docs, T, row_bytes, group,
                                    n_groups, K, splits, rows_per_split, align, ps, pi, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(ps, pi, splits, B, K, depth, out_s, out_i, st);
}

const char* fused_topk_quantized_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
