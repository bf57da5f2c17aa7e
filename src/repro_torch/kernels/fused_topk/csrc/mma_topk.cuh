// The tensor-core pass 1 of the streaming fused top-k, shared by K1 classic
// (fused_topk_bf16_partial in fused_topk.cu, bf16 rows), K1 dot
// (fused_topk_int8_partial, same file, int8 rows), K1 f32, the exact
// cosine (fused_topk_f32_partial, same file, f32 rows), K4 with a bf16 query
// (fused_topk_quantized_bf16_partial in fused_topk_quantized.cu, int8 or
// packed int4 rows widened to bf16) and K4 with an f32 query over int8 or
// packed int4 rows (fused_topk_quantized_tf32_partial, same file, rows
// widened to f32): the
// 4-byte cp.async helpers (the bf16, s8 and tf32 mma, ldmatrix and 16- and
// 8-byte cp.async are ../../csrc/mma_sync.cuh's, shared with K6, K7 and
// K9), the
// four product types (MmaBf16,
// MmaS8, MmaTf32, MmaTf32x3), the counting merge of a candidate buffer into
// a running list, the block's shared-memory layout and launch plan
// (mma_smem / mma_shape / mma_plan), and the body (mma_topk_pass1),
// templated on a doc-operand policy.
//
// A policy (Rows) names its product type and says where a doc row's pack
// (the columns of 16 staged bytes: 8 bf16, 16 int8 or 4 f32) comes from and
// what a finished sum becomes:
//   using Op;                        // MmaBf16, MmaS8, MmaTf32 or MmaTf32x3: q's
//                                    // element, the mma instruction and its
//                                    // accumulator
//   using Unit;                      // what a thread holds of one pack in registers
//   static constexpr bool kAsync;    // rows may go through a cp.async ring:
//   static constexpr bool kRaw;      //   of raw units (packed rows), or straight
//                                    //   into the stages (bf16, int8 or f32 rows)
//   static constexpr bool kRowScale; // the sum is multiplied by a per-row scale
//   static constexpr bool kChunkScale;  // each chunk's sum (Op::kFold) is multiplied
//                                    // by the row's scale for that chunk as it
//                                    // folds (one int4 group a chunk; the
//                                    // register loader only, not kAsync)
//   Unit load(int di, bool ok, int e) const;  // row di, the pack at column e;
//                                             // !ok: a row >= n_docs, never read
//   uint4 widen(Unit) const;         // the pack as staged, exactly as the
//                                    // reference dequantizes it (kChunkScale:
//                                    // without the scale)
//   float row_scale(int id) const;   // only where kRowScale
//   float chunk_scale(int di, bool ok, int e0) const;  // row di's scale for the chunk
//                                    // at column e0, 0 where !ok (kChunkScale)
//   static constexpr int kSlot;      // bytes of a unit's slot in the raw ring (kRaw)
//   void copy_raw(uint32_t* slot, int di, bool ok, int e) const;  // the unit
//   Unit read_raw(const uint32_t* slot) const;  // into / from its slot (kRaw)
//   const Op::Elem* docs;            // rows as staged (kAsync, not kRaw)
// The query is (B, T) of Op's element type, and every column past T reads
// as 0 on both sides, so a pack that straddles T only needs its doc values
// to be finite.
//
// Design (measured on an H100 in PERF.md; K1's numbers there):
//   * Products: a chunk of every doc and query row, 128 bytes (64 bf16,
//     128 int8 or 32 f32 columns), is staged in shared memory (row stride
//     144 bytes, so the eight rows an ldmatrix phase reads fall on distinct
//     banks) and multiplied in four k-steps of 32 bytes by mma.sync:
//     m16n8k16 bf16 x bf16 -> f32 (HMMA), m16n8k32 s8 x s8 -> s32 (IMMA), or
//     two m16n8k8 tf32 x tf32 -> f32 (HMMA) a k-step for an f32 query (three
//     over raw f32 rows; below).  An
//     m16n8k32 .s8 fragment holds 4 bytes a register, and an m16n8k8 .tf32
//     one a whole f32, at the row and byte offsets where an m16n8k16 .bf16
//     one holds 2 bf16 (PTX ISA, the mma fragment figures; g = lane / 4,
//     t = lane % 4): A's a0 is row g, bytes 4t..4t + 3 of the k-step, a1 row
//     g + 8, a2 and a3 the same rows at bytes 16 + 4t; B's b0 and b1 the
//     same by query row; C is the same f32 16x8 tile in all three.  So
//     ldmatrix loads all three from the same addresses.  Docs are
//     the M side (16-row fragments of doc rows), queries the N side (8-column
//     fragments of query rows), so one kernel serves every B: the plan takes
//     64-query tiles above B = 8 (128 docs a tile, 8 warps as 4 x 2, each
//     32 docs x 32 queries) and 8-query tiles up to it (256 docs a tile,
//     each warp 32 docs x 8 queries).  bf16 products are exact in f32; only
//     the order of the f32 sums differs from the plain version.  int8 sums
//     are exact int32, as the reference's, and become f32 once, at the
//     threshold test.  An f32 query splits, as each fragment leaves
//     ldmatrix, into hi = q cut to tf32 and lo = (q - hi) cut to tf32 (q -
//     hi is exact in f32; hi + lo is q to 2^-20 |q|), and each k-step issues
//     one tf32 mma with lo and one with hi into a fragment of the chunk's
//     own, added to the row's sum in f32 (MmaTf32 says why).  The doc
//     operand must then be exact in tf32: an int8 value (8 significant
//     bits) is, and each product of an 11-bit part with it is exact in f32,
//     so only the order of the f32 sums and q's bits below 2^-20 |q| differ
//     from the plain version (one tf32 pass would keep ~1e-3 of q).  Packed
//     int4 rows widen to the exact f32 nibble - 8 (4 bits), and their group
//     scale multiplies each chunk's sum as it folds (fmaf: one rounding), a
//     32-column chunk lying in one group: the reference rounds each
//     (nibble - 8) * scale to f32 instead, and sums in another order.  Raw
//     f32 rows (K1 f32) are not exact in tf32, so MmaTf32x3 splits the doc
//     fragment too, once per ldmatrix, and a k-step is three tf32 mma:
//     doc lo x q hi, doc hi x q lo, doc hi x q hi (the product lo x lo,
//     below 2^-20 of q_i d_i, and each operand's bits below 2^-20 of it are
//     dropped).  A product is then off by at most 3 2^-20 |q_i d_i|, a
//     score by at most 3 2^-20 |q| |d|: 2.9e-6 for the unit vectors of the
//     exact cosine, inside the near-tie rule's 1e-5; integer values below
//     2^11 are their own hi part, so integer scores stay exact.
//   * Loads: where every row is bf16, int8 or f32 and 16-byte aligned, a ring of
//     stages filled by cp.async (two chunks in flight; a pack past T or a row
//     >= n_docs / >= B is zero-filled and not read); int8 rows that are only
//     8-byte aligned (600 bytes) take the same ring with two 8-byte copies a
//     pack.  Packed rows may take a ring of their raw units instead (two
//     chunks in flight): each thread copies its units into slots of its own
//     and, a barrier after the previous chunk's products, widens them into
//     the one doc stage (bf16, or f32 for an f32 query); a second barrier
//     publishes it.  Other rows go through registers one chunk ahead, and
//     the policy widens each unit as it is stored into one of two stages.
//     Either way a packed row
//     is read once per query tile, and its dequantized chunk exists only in
//     shared memory.
//   * Running top-k: after a tile's last chunk every thread tests its
//     accumulators (times the row's scale where the policy has one, the
//     reference's order) against its query's depth-th entry with the full
//     comparator and appends those that pass to the query's candidate
//     buffer (a shared-memory atomicAdd on the query's count).  A buffer is
//     merged only once it holds more than BN / 4 candidates, or after the
//     block's last tile; until then a stale threshold only lets more in,
//     and the buffer (BN + BN / 4 entries) has room for the next tile.  The
//     merge (one warp per query, merge_counted) does not sort; lists wider
//     than kRegMergeK take one warp_insert per candidate that still ranks.
//     The list's entries past depth may go stale, but its first depth
//     entries are the split's exact top-depth, and pass 2 keeps only those.
//
// The int8 instances (K1 dot) replace a CUDA-core pass 1 that summed 4-byte
// words with __dp4a.  At the ann-word2vec cell (N = 2,999,808, T = 600,
// B = 256, depth 100) they are bound by bytes: 1.8 GB of int8 rows take
// 0.537 ms at 3.35 TB/s, and the 9.2e11 int8 operations 0.47 ms at 1,979
// TOPS.  What sets their pace on an H100 (PERF.md, `chip_smoke.py
// --ablate`) is what sets K1 classic's: at B = 256 the loads (four query
// tiles re-read the store, ~3.3 of ~7.3 ms) and the running top-k (~2.5
// ms), not the products; at B <= 8 the loads, at ~2.3 TB/s.
#pragma once

#include "mma_sync.cuh"  // the ldmatrix / mma_bf16 / mma_s8 / mma_tf32 / cp.async wrappers
#include "topk_merge.cuh"

namespace {

constexpr int kMmaChunk = 128;              // bytes of a row per reduce chunk
constexpr int kKSteps = kMmaChunk / 32;     // mma k-steps of 32 bytes a chunk
constexpr int kMmaStride = (kMmaChunk + 16) / 2;  // staged row stride in 16-bit lanes (144 B)
constexpr int kMmaPacks = kMmaChunk / 16;   // 16-byte packs per staged row and chunk
constexpr int kRegMergeK = 256;             // widest running list merged by counting
constexpr int kStages = 3;                  // cp.async ring: two chunks in flight
constexpr int kRegStages = 2;               // stages of the register-staged loader
constexpr size_t kSmemPerSm = 228 * 1024;   // shared memory of an SM
constexpr size_t kSmemPerBlock = 1024;      // what the card reserves per resident block

// Dynamic shared memory of a pass-1 block of bq queries and bn-doc tiles
// with `stages` staged chunks: the stages (bn doc rows, then bq query rows,
// each 144 bytes; for a ring of raw packed rows, `slot` > 0, one widened doc
// stage, then `stages` query stages and `stages` raw stages of `slot` bytes
// a unit), `cscale` bytes a doc row and stage of chunk scales (4 for the
// register loader of a policy with kChunkScale, else 0), bq running lists
// of K (score, id) pairs, bq candidate buffers of cand_cap(bn) pairs, and
// each query's threshold and count.
constexpr size_t mma_smem(int bq, int bn, int stages, int K, int slot = 0, int cscale = 0) {
  return (slot > 0 && stages > 1
              ? (size_t)bn * kMmaStride * 2 + (size_t)stages * (bq * kMmaStride * 2 + bn * kMmaPacks * slot)
              : (size_t)stages * (bn + bq) * kMmaStride * 2) +
         (size_t)stages * bn * cscale +
         (size_t)bq * K * 8 + (size_t)bq * cand_cap(bn) * 8 + (size_t)bq * 12;
}

// The doc tile and stage count of the instance for bq queries (64 or 8) at
// list width K, where the loader holds up to `ring` stages (kStages for a
// cp.async ring, of rows as staged or, `slot` > 0, of packed units in slots
// of that many bytes): 128 docs at 64 queries, 256 at 8; or, at 8 queries
// where the lists are too wide for that, 128 docs and one register-staged
// stage.  The launch takes the register loader's kRegStages for rows the
// ring cannot take, and a raw ring of 4-byte slots is smaller than those,
// so a tile of several stages must fit with either loader.  False if the
// instance does not fit in shared memory.
inline bool mma_shape(int bq, int K, int ring, int* bn, int* stages, int slot = 0,
                      int cscale = 0) {
  auto fits = [&](int n, int s) {
    return mma_smem(bq, n, s, K, slot, cscale) <= kMaxSmem &&
           (s == 1 || mma_smem(bq, n, kRegStages, K, 0, cscale) <= kMaxSmem);
  };
  if (bq != 64 && bq != 8) return false;
  *bn = bq == 8 ? 256 : 128;
  *stages = ring;
  if (bq == 8 && !fits(256, ring)) {
    *bn = 128;
    *stages = 1;
  }
  return fits(*bn, *stages);
}

// The launch plan for B queries over n_docs rows at `depth` on sm_count SMs
// with a loader of up to `ring` stages: plan[0] queries per block (64 above
// 8 queries, else 8; 8 where the lists do not fit at 64), plan[1] K (depth
// rounded up to 32), plan[2] N-splits, plan[3] doc tiles per split, plan[4]
// docs per tile, so that query tiles x splits cover every SM's resident
// blocks, at B = 256 and at B = 1 alike.  Returns cudaErrorInvalidValue if
// no instance fits.
inline int mma_plan(int B, int n_docs, int depth, int sm_count, int ring, int* plan,
                    int slot = 0, int cscale = 0) {
  if (B <= 0 || n_docs <= 0 || depth <= 0 || sm_count <= 0) return (int)cudaErrorInvalidValue;
  const int K = (depth + 31) / 32 * 32;
  int bq = B > 8 ? 64 : 8, bn = 0, stages = 0;
  if (!mma_shape(bq, K, ring, &bn, &stages, slot, cscale)) bq = 8;
  if (!mma_shape(bq, K, ring, &bn, &stages, slot, cscale)) return (int)cudaErrorInvalidValue;
  const size_t per_block = mma_smem(bq, bn, stages, K, slot, cscale) + kSmemPerBlock;
  const int resident = kSmemPerSm / per_block > 1 ? (int)(kSmemPerSm / per_block) : 1;
  const int n_tiles = (n_docs + bn - 1) / bn;
  const int q_tiles = (B + bq - 1) / bq;
  const int want = (resident * sm_count + q_tiles - 1) / q_tiles;
  const int splits = want < 1 ? 1 : (want < n_tiles ? want : n_tiles);
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  plan[0] = bq;
  plan[1] = K;
  plan[2] = (n_tiles + tiles_per_split - 1) / tiles_per_split;  // no empty split
  plan[3] = tiles_per_split;
  plan[4] = bn;
  return 0;
}

// The product types of the pass 1: the element of q and of the staged rows
// (and its score_operands.cuh mode, for the register loader of q), the
// columns of a 128-byte chunk, the registers of a doc fragment and of a
// query fragment as the mma takes them (kARegs, kBRegs: ldmatrix fills the
// first four and two, split_a and split the rest), the mma instruction and
// its accumulator, and kFold: false where the mma sums onto the row's
// accumulator, true where it sums a chunk's products from zero into a
// fragment of their own that an f32 add then folds into the row's.
struct MmaBf16 {
  using Elem = uint16_t;                 // bf16 bits
  using Acc = float;
  static constexpr int kMode = kBF16;
  static constexpr bool kHalves = false;  // q packs by 16-byte or element loads
  static constexpr int kCols = kMmaChunk / 2;
  static constexpr int kARegs = 4;
  static constexpr int kBRegs = 2;
  static constexpr bool kFold = false;
  static __device__ __forceinline__ void split_a(unsigned (&)[4]) {}
  static __device__ __forceinline__ void split(unsigned (&)[2]) {}
  static __device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                             const unsigned (&b)[2]) {
    mma_bf16(c, a, b);
  }
};
struct MmaS8 {
  using Elem = int8_t;
  using Acc = int;
  static constexpr int kMode = kI8;
  static constexpr bool kHalves = true;   // q rows of 600 bytes: 8-byte loads
  static constexpr int kCols = kMmaChunk;
  static constexpr int kARegs = 4;
  static constexpr int kBRegs = 2;
  static constexpr bool kFold = false;
  static __device__ __forceinline__ void split_a(unsigned (&)[4]) {}
  static __device__ __forceinline__ void split(unsigned (&)[2]) {}
  static __device__ __forceinline__ void mma(int (&c)[4], const unsigned (&a)[4],
                                             const unsigned (&b)[2]) {
    mma_s8(c, a, b);
  }
};
// An f32 query against rows exact in tf32: b[0..1] as loaded become hi = q
// cut to tf32, b[2..3] lo = (q - hi) cut to tf32 by bit masks (hi + lo is
// q to 2^-20 |q|), once per loaded fragment; the k-step is two m16n8k8 tf32
// mma, doc x lo and doc x hi, onto a fragment that sums the chunk's k-steps
// from zero; an f32 add (round to nearest) folds it into the row's sum.
// The tensor cores' own sums lose low bits: run onto the row's whole sum,
// a 600-column row of magnitude up to 10 drifted 6.9e-5 from the plain
// version, outside the near-tie rule (chip_smoke.py's check_quantized;
// PERF.md §6).
struct MmaTf32 {
  using Elem = float;
  using Acc = float;
  static constexpr int kMode = kF32;
  static constexpr bool kHalves = false;  // q packs by 16-byte or element (4-byte) loads
  static constexpr int kCols = kMmaChunk / 4;
  static constexpr int kARegs = 4;
  static constexpr int kBRegs = 4;
  static constexpr bool kFold = true;
  static __device__ __forceinline__ void split_a(unsigned (&)[4]) {}
  static __device__ __forceinline__ void split(unsigned (&b)[4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x = __uint_as_float(b[r]);
      b[r] &= kTf32Bits;
      b[2 + r] = __float_as_uint(x - __uint_as_float(b[r])) & kTf32Bits;
    }
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                             const unsigned (&b)[4]) {
    mma_tf32(c, a, b[2], b[3]);
    mma_tf32(c, a, b[0], b[1]);
  }
};
// An f32 query against raw f32 rows (K1 f32): the query split as MmaTf32
// splits it, and each doc fragment a[0..3] as loaded into hi = a cut to
// tf32 and a[4..7] lo = (a - hi) cut to tf32, once per ldmatrix (a fragment
// serves every query fragment of the warp); the k-step is three m16n8k8
// tf32 mma, the small terms first: doc lo x q hi, doc hi x q lo, doc hi x
// q hi, onto the chunk's own fragment, folded as MmaTf32's.
struct MmaTf32x3 : MmaTf32 {
  static constexpr int kARegs = 8;
  static __device__ __forceinline__ void split_a(unsigned (&a)[8]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = __uint_as_float(a[r]);
      a[r] &= kTf32Bits;
      a[4 + r] = __float_as_uint(x - __uint_as_float(a[r])) & kTf32Bits;
    }
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[8],
                                             const unsigned (&b)[4]) {
    const unsigned hi[4] = {a[0], a[1], a[2], a[3]}, lo[4] = {a[4], a[5], a[6], a[7]};
    mma_tf32(c, lo, b[0], b[1]);  // doc lo x q hi
    mma_tf32(c, hi, b[2], b[3]);
    mma_tf32(c, hi, b[0], b[1]);
  }
};

// Bytes of a unit's slot in the raw ring of policy Rows (0: no raw ring).
template <class Rows>
__host__ __device__ constexpr int raw_slot() {
  if constexpr (Rows::kRaw) return Rows::kSlot;
  else return 0;
}
// Bytes a doc row takes of each stage's chunk scales (mma_smem's cscale).
template <class Rows>
__host__ __device__ constexpr int chunk_scale_bytes() {
  return Rows::kChunkScale ? 4 : 0;
}

// The 16-byte pack at column e of row `row` of the (rows, T) matrix `base`
// into `dst` of a stage, by cp.async: one 16-byte copy (CP = 16: every row
// 16-byte aligned) or two 8-byte ones (CP = 8: 8-byte aligned, each copy
// wholly inside the row or wholly past T).  A copy past T, or of a row that
// does not exist (!row_ok), is zero-filled and reads nothing.
template <int CP, class E>
__device__ __forceinline__ void copy_pack(uint16_t* dst, const E* base, int row, bool row_ok,
                                          int e, int T) {
  if constexpr (CP == 16) {
    const bool ok = row_ok && e < T;
    cp_async16(dst, base + (ok ? (size_t)row * T + e : 0), ok ? 16 : 0);
  } else {
    static_assert(CP == 8, "16- or 8-byte copies");
    constexpr int kHalf = 8 / sizeof(E);  // columns of one copy
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = row_ok && e + h * kHalf < T;
      cp_async8(dst + 4 * h, base + (ok ? (size_t)row * T + e + h * kHalf : 0), ok ? 8 : 0);
    }
  }
}

// A barrier over the kLanes threads of a merge: one warp, or the block.
template <int kLanes>
__device__ __forceinline__ void merge_sync() {
  static_assert(kLanes == 32 || kLanes == kThreads, "a warp or the whole block");
  if constexpr (kLanes == 32) __syncwarp();
  else __syncthreads();
}

// Merge the n unsorted candidates (cs, ci) (n <= kLanes kCandPer) into the
// sorted running list (rs, ri) of K <= kLanes kPer entries in one pass,
// without sorting them: an entry's new slot is the number of entries of
// both lists that come before it.  For a list entry that is its index plus
// the candidates before it, counted in one sweep over the candidates; for
// a candidate, the candidates before it (the same sweep) plus its rank in
// the list (binary search).  Slots >= K drop.  No two entries share a slot:
// no two share an id, or (kDup, where an id may come twice: the gathered
// K3's and K5's row ids) a copy goes after the list's entry and after the
// buffer's earlier copies.  The kLanes threads (one warp, or the block; `lane` is
// the thread's index among them) take part; each holds its entries in
// registers until every slot is known.
template <int kCandPer, int kPer, int kLanes = 32, bool kDup = false>
__device__ __forceinline__ void merge_counted(float* rs, int* ri, int K, const float* cs,
                                              const int* ci, int n, int lane) {
  float ls_[kPer], cs_[kCandPer];
  int li_[kPer], ci_[kCandPer], lslot[kPer], cslot[kCandPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int c = lane + kLanes * u;
    lslot[u] = c < K ? c : K;
    ls_[u] = c < K ? rs[c] : -INFINITY;
    li_[u] = c < K ? ri[c] : kBigId;
  }
#pragma unroll
  for (int u = 0; u < kCandPer; ++u) {
    const int c = lane + kLanes * u;
    cs_[u] = c < n ? cs[c] : -INFINITY;
    ci_[u] = c < n ? ci[c] : kBigId;
    cslot[u] = c < n ? rank_in<kDup>(rs, ri, K, cs_[u], ci_[u]) : K;
  }
  for (int j = 0; j < n; ++j) {
    const float s = cs[j];
    const int id = ci[j];
#pragma unroll
    for (int u = 0; u < kPer; ++u) lslot[u] += precedes(s, id, ls_[u], li_[u]) ? 1 : 0;
#pragma unroll
    for (int u = 0; u < kCandPer; ++u)
      cslot[u] += precedes(s, id, cs_[u], ci_[u]) ||
                          (kDup && j < lane + kLanes * u && s == cs_[u] && id == ci_[u])
                      ? 1 : 0;
  }
  merge_sync<kLanes>();
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (lane + kLanes * u < K && lslot[u] < K) { rs[lslot[u]] = ls_[u]; ri[lslot[u]] = li_[u]; }
#pragma unroll
  for (int u = 0; u < kCandPer; ++u)
    if (lane + kLanes * u < n && cslot[u] < K) { rs[cslot[u]] = cs_[u]; ri[cslot[u]] = ci_[u]; }
  merge_sync<kLanes>();
}

// Merge a query's buffer of n candidates (cs, ci) (n <= kCap) into its
// sorted running list (rs, ri) of K, whose first `depth` entries are then
// its exact top-depth: by counting (merge_counted) where the list fits the
// kLanes threads' registers (kLanes = 32: K <= 128, then K <= kRegMergeK;
// the block: K <= 256, then K <= 1024), else the first warp inserts each
// candidate that still ranks (warp_insert).  kDup as for merge_counted.
template <int kCap, int kLanes = 32, bool kDup = false>
__device__ __forceinline__ void merge_buffer(float* rs, int* ri, int K, int depth,
                                             const float* cs, const int* ci, int n, int lane) {
  constexpr int kCandPer = (kCap + kLanes - 1) / kLanes;
  constexpr int kNarrow = kLanes == 32 ? 4 : 1, kWide = kLanes == 32 ? kRegMergeK / 32 : 4;
  if (K <= kLanes * kNarrow) {
    merge_counted<kCandPer, kNarrow, kLanes, kDup>(rs, ri, K, cs, ci, n, lane);
  } else if (K <= kLanes * kWide) {
    merge_counted<kCandPer, kWide, kLanes, kDup>(rs, ri, K, cs, ci, n, lane);
  } else if (lane < 32) {  // wide lists: one sorted insert per candidate that still ranks
    for (int j = 0; j < n; ++j)
      if (precedes(cs[j], ci[j], rs[depth - 1], ri[depth - 1]))
        warp_insert(rs, ri, K, cs[j], ci[j], lane);
  }
}

// The body of a pass-1 block on a grid of (query tiles of BQ, splits): block
// (x, split) owns queries [x * BQ, x * BQ + BQ) and doc tiles [split *
// tiles_per_split, ...) of BN docs.  8 warps as kWarpsM (docs) x kWarpsN
// (queries); a warp owns WM 16-doc by WN 8-query mma tiles, accumulated in
// registers over the tile's chunks of Op::kCols columns (128 bytes), staged
// in NS shared-memory stages: a cp.async ring (ASYNC: rows as staged, every
// q and doc row CP-byte aligned, so each CP-byte copy lies wholly inside or
// wholly past its row) or, for other rows, packs loaded through registers
// one chunk ahead and widened by the policy as they are stored.  Writes each
// query's sorted list of K to part_s / part_i (splits, B, K).
template <class Rows, int BQ, int BN, int NS, bool ASYNC, int CP = 16>
__device__ __forceinline__ void mma_topk_pass1(
    const typename Rows::Op::Elem* __restrict__ q,  // (B, T)
    const Rows& rows,                   // the doc operand, rows >= n_docs unread
    const uint8_t* __restrict__ filt,   // nullptr | (N,) | (B, N)
    long long filt_stride,              // 0 for (N,), N for (B, N)
    int B, int n_docs, int T, int depth, int K, int tiles_per_split,
    int q_align,                        // the byte alignment every q row starts at
    float* __restrict__ part_s, int* __restrict__ part_i) {
  using Op = typename Rows::Op;
  using Acc = typename Op::Acc;
  constexpr int kPackCols = Op::kCols / kMmaPacks;  // columns of a 16-byte pack
  constexpr int kWarpsN = BQ >= 32 ? BQ / 32 : 1;
  constexpr int kWarpsM = kWarps / kWarpsN;
  constexpr int WN = BQ / (8 * kWarpsN);   // 8-query mma columns per warp
  constexpr int WM = BN / (16 * kWarpsM);  // 16-doc mma rows per warp
  static_assert(kWarpsM * WM * 16 == BN && kWarpsN * WN * 8 == BQ, "warps must tile the block");
  static_assert(WN == 1 || WN % 2 == 0, "query fragments load in pairs");
  static_assert(ASYNC ? NS >= 2 : NS <= kRegStages,
                "a ring of stages, or at most two through registers");
  static_assert(!ASYNC || Rows::kAsync, "these rows have no cp.async ring");
  static_assert(CP == 16 || !(ASYNC && Rows::kRaw), "the raw ring copies its own units");
  // ASYNC over packed rows: a ring of their raw units (each thread copies
  // and later widens its own units, so only the widened stage needs the
  // block's barrier) and of query chunks, and one widened doc stage.
  constexpr bool kRawRing = ASYNC && Rows::kRaw;
  constexpr bool kChunkScale = Rows::kChunkScale;
  static_assert(!(ASYNC && kChunkScale), "chunk scales are staged by the register loader");
  constexpr int kSlotWords = raw_slot<Rows>() / 4;  // 32-bit words of a raw unit's slot
  constexpr int kCap = cand_cap(BN), kFlushAt = flush_at(BN);
  static_assert(kCap % 32 == 0, "candidate buffers fill whole lanes");
  constexpr int kDLoads = BN * kMmaPacks / kThreads;
  constexpr int kQPacks = BQ * kMmaPacks;
  constexpr int kQLoads = (kQPacks + kThreads - 1) / kThreads;
  static_assert(kDLoads * kThreads == BN * kMmaPacks, "doc chunk must split evenly");

  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* stages = reinterpret_cast<uint16_t*>(smem);  // NS x (BN + BQ) rows
  constexpr int kStageElems = kRawRing
      ? BN * kMmaStride + NS * (BQ * kMmaStride + BN * kMmaPacks * kSlotWords * 2)
      : NS * (BN + BQ) * kMmaStride + (kChunkScale ? NS * BN * 2 : 0);
  uint16_t* raw_q = stages + BN * kMmaStride;  // the raw ring's query stages
  uint32_t* raw_d = reinterpret_cast<uint32_t*>(raw_q + NS * BQ * kMmaStride);  // and raw units
  // NS x BN chunk scales (kChunkScale), after the register loader's stages.
  float* cscales = reinterpret_cast<float*>(stages + NS * (BN + BQ) * kMmaStride);
  float* ls = reinterpret_cast<float*>(stages + kStageElems);  // BQ x K
  int* li = reinterpret_cast<int*>(ls + BQ * K);
  float* cs = reinterpret_cast<float*>(li + BQ * K);  // BQ x kCap candidates
  int* ci = reinterpret_cast<int*>(cs + BQ * kCap);
  float* ts = reinterpret_cast<float*>(ci + BQ * kCap);  // each list's depth-th entry
  int* ti = reinterpret_cast<int*>(ts + BQ);
  int* cnt = ti + BQ;                                  // candidates per query

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp % kWarpsM) * WM * 16, wn0 = (warp / kWarpsM) * WN * 8;
  const int q0 = blockIdx.x * BQ, split = blockIdx.y;
  const int n_chunks = (T + Op::kCols - 1) / Op::kCols;
  const int n_tiles = (n_docs + BN - 1) / BN;
  const int tile_begin = split * tiles_per_split;
  const int n_steps = max(0, min(tile_begin + tiles_per_split, n_tiles) - tile_begin) * n_chunks;

  for (int e = tid; e < BQ * K; e += kThreads) { ls[e] = -INFINITY; li[e] = kBigId; }
  for (int r = tid; r < BQ; r += kThreads) { ts[r] = -INFINITY; ti[r] = kBigId; cnt[r] = 0; }

  constexpr int kSLoads = (BN + kThreads - 1) / kThreads;  // chunk scales a thread loads
  typename Rows::Unit dst[kDLoads];
  float sst[kChunkScale ? kSLoads : 1];
  uint4 qst[kQLoads];
  auto load_step = [&](int step) {
    const int d0 = (tile_begin + step / n_chunks) * BN;
    const int e0 = (step % n_chunks) * Op::kCols;
#pragma unroll
    for (int i = 0; i < kDLoads; ++i) {
      const int v = tid + i * kThreads, di = d0 + v / kMmaPacks;
      dst[i] = rows.load(di, di < n_docs, e0 + (v % kMmaPacks) * kPackCols);
    }
    if constexpr (kChunkScale) {
#pragma unroll
      for (int i = 0; i < kSLoads; ++i) {
        const int r = tid + i * kThreads, di = d0 + r;
        if (r < BN) sst[i] = rows.chunk_scale(di, di < n_docs, e0);
      }
    }
#pragma unroll
    for (int i = 0; i < kQLoads; ++i) {
      const int v = tid + i * kThreads, qi = q0 + v / kMmaPacks;
      if (v < kQPacks)
        qst[i] = load_pack<Op::kMode, Op::kHalves>(q + (size_t)qi * T, qi < B,
                                                   e0 + (v % kMmaPacks) * kPackCols, T, q_align,
                                                   true);
    }
  };

  auto copy_step = [&](int step) {  // chunk `step` into its stage of the ring
    if constexpr (kRawRing) {
      const int d0 = (tile_begin + step / n_chunks) * BN;
      const int e0 = (step % n_chunks) * Op::kCols;
      uint32_t* rd = raw_d + (step % NS) * BN * kMmaPacks * kSlotWords;
      uint16_t* qs = raw_q + (step % NS) * BQ * kMmaStride;
#pragma unroll
      for (int i = 0; i < kDLoads; ++i) {
        const int v = tid + i * kThreads, di = d0 + v / kMmaPacks;
        rows.copy_raw(rd + (i * kThreads + tid) * kSlotWords, di, di < n_docs,
                      e0 + (v % kMmaPacks) * kPackCols);
      }
#pragma unroll
      for (int i = 0; i < kQLoads; ++i) {
        const int v = tid + i * kThreads, qi = q0 + v / kMmaPacks;
        if (v < kQPacks)
          copy_pack<16>(qs + (v / kMmaPacks) * kMmaStride + (v % kMmaPacks) * 8, q, qi, qi < B,
                        e0 + (v % kMmaPacks) * kPackCols, T);
      }
    } else if constexpr (ASYNC) {
      uint16_t* ds = stages + (step % NS) * (BN + BQ) * kMmaStride;
      uint16_t* qs = ds + BN * kMmaStride;
      const int d0 = (tile_begin + step / n_chunks) * BN;
      const int e0 = (step % n_chunks) * Op::kCols;
#pragma unroll
      for (int i = 0; i < kDLoads; ++i) {
        const int v = tid + i * kThreads, di = d0 + v / kMmaPacks;
        copy_pack<CP>(ds + (v / kMmaPacks) * kMmaStride + (v % kMmaPacks) * 8, rows.docs, di,
                      di < n_docs, e0 + (v % kMmaPacks) * kPackCols, T);
      }
#pragma unroll
      for (int i = 0; i < kQLoads; ++i) {
        const int v = tid + i * kThreads, qi = q0 + v / kMmaPacks;
        if (v < kQPacks)
          copy_pack<CP>(qs + (v / kMmaPacks) * kMmaStride + (v % kMmaPacks) * 8, q, qi, qi < B,
                        e0 + (v % kMmaPacks) * kPackCols, T);
      }
    }
  };

  constexpr bool kFold = Op::kFold;
  Acc acc[WM][WN][4];
  Acc part[kFold ? WM : 1][kFold ? WN : 1][4];  // a chunk's products, then folded into acc
  float rsc[Rows::kRowScale ? WM : 1][2];  // the scales of this thread's docs in the tile
  if constexpr (ASYNC) {
#pragma unroll
    for (int s0 = 0; s0 < NS - 1; ++s0) {
      if (s0 < n_steps) copy_step(s0);
      cp_async_commit();
    }
  } else {
    if (n_steps > 0) load_step(0);
  }
  for (int step = 0; step < n_steps; ++step) {
    const int chunk = step % n_chunks;
    uint16_t* ds = kRawRing ? stages : stages + (step % NS) * (BN + BQ) * kMmaStride;
    uint16_t* qs = kRawRing ? raw_q + (step % NS) * BQ * kMmaStride : ds + BN * kMmaStride;
    if (chunk == 0) {
#pragma unroll
      for (int mi = 0; mi < WM; ++mi)
#pragma unroll
        for (int ni = 0; ni < WN; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);
    }
    if constexpr (Rows::kRowScale) {
      if (chunk == n_chunks - 1) {  // in flight during the tile's last products
        const int d0 = (tile_begin + step / n_chunks) * BN;
#pragma unroll
        for (int mi = 0; mi < WM; ++mi)
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            const int id = d0 + wm0 + mi * 16 + g * 8 + (lane >> 2);
            rsc[mi][g] = id < n_docs ? rows.row_scale(id) : 0.f;
          }
      }
    }
    if constexpr (kRawRing) {
      // This thread's units of the chunk and its query packs have landed;
      // after the barrier every warp is done with the doc stage and with the
      // query stage of the previous step, which the chunk NS - 1 ahead fills
      // (its raw units' slots are this thread's, widened a step ago).
      cp_async_wait<NS - 2>();
      __syncthreads();
      const uint32_t* rd = raw_d + (step % NS) * BN * kMmaPacks * kSlotWords;
#pragma unroll
      for (int i = 0; i < kDLoads; ++i) {
        const int v = tid + i * kThreads;
        *reinterpret_cast<uint4*>(ds + (v / kMmaPacks) * kMmaStride + (v % kMmaPacks) * 8) =
            rows.widen(rows.read_raw(rd + (i * kThreads + tid) * kSlotWords));
      }
      if (step + NS - 1 < n_steps) copy_step(step + NS - 1);
      cp_async_commit();
      __syncthreads();
    } else if constexpr (ASYNC) {
      // This chunk has landed; after the barrier, every warp is done with
      // the stage of the previous step, which the chunk NS - 1 ahead fills.
      cp_async_wait<NS - 2>();
      __syncthreads();
      if (step + NS - 1 < n_steps) copy_step(step + NS - 1);
      cp_async_commit();
    } else {
      // With two stages, the stage written here was last read two steps
      // ago, before the barrier of the previous step.
      if (NS == 1) __syncthreads();
#pragma unroll
      for (int i = 0; i < kDLoads; ++i) {
        const int v = tid + i * kThreads;
        *reinterpret_cast<uint4*>(ds + (v / kMmaPacks) * kMmaStride + (v % kMmaPacks) * 8) =
            rows.widen(dst[i]);
      }
#pragma unroll
      for (int i = 0; i < kQLoads; ++i) {
        const int v = tid + i * kThreads;
        if (v < kQPacks)
          *reinterpret_cast<uint4*>(qs + (v / kMmaPacks) * kMmaStride + (v % kMmaPacks) * 8) =
              qst[i];
      }
      if constexpr (kChunkScale) {
#pragma unroll
        for (int i = 0; i < kSLoads; ++i) {
          const int r = tid + i * kThreads;
          if (r < BN) cscales[(step % NS) * BN + r] = sst[i];
        }
      }
      __syncthreads();
      if (step + 1 < n_steps) load_step(step + 1);  // in flight during the products
    }

    float csc[kChunkScale ? WM : 1][2];  // the chunk scales of this thread's docs
    if constexpr (kChunkScale) {
      const float* sc = cscales + (step % NS) * BN;
#pragma unroll
      for (int mi = 0; mi < WM; ++mi)
#pragma unroll
        for (int g = 0; g < 2; ++g) csc[mi][g] = sc[wm0 + mi * 16 + g * 8 + (lane >> 2)];
    }
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      unsigned a[WM][Op::kARegs], b[WN][Op::kBRegs];
#pragma unroll
      for (int mi = 0; mi < WM; ++mi) {
        ldmatrix_x4(a[mi], smem_addr(ds + (wm0 + mi * 16 + (lane & 15)) * kMmaStride + ks * 16 +
                                     (lane >> 4) * 8));
        Op::split_a(a[mi]);  // once per fragment, not per ni
      }
      if constexpr (WN == 1) {
        unsigned r[2];
        ldmatrix_x2(r, smem_addr(qs + (wn0 + (lane & 7)) * kMmaStride + ks * 16 +
                                 ((lane >> 3) & 1) * 8));
        b[0][0] = r[0];
        b[0][1] = r[1];
      } else {
#pragma unroll
        for (int nj = 0; nj < WN; nj += 2) {
          unsigned r[4];
          ldmatrix_x4(r, smem_addr(qs + (wn0 + nj * 8 + (lane >> 4) * 8 + (lane & 7)) * kMmaStride +
                                   ks * 16 + ((lane >> 3) & 1) * 8));
          b[nj][0] = r[0];
          b[nj][1] = r[1];
          b[nj + 1][0] = r[2];
          b[nj + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int ni = 0; ni < WN; ++ni) Op::split(b[ni]);  // once per fragment, not per mi
      if constexpr (!kFold) {
#pragma unroll
        for (int mi = 0; mi < WM; ++mi)
#pragma unroll
          for (int ni = 0; ni < WN; ++ni) Op::mma(acc[mi][ni], a[mi], b[ni]);
      } else {
#pragma unroll
        for (int mi = 0; mi < WM; ++mi)
#pragma unroll
          for (int ni = 0; ni < WN; ++ni) {
            if (ks == 0)
#pragma unroll
              for (int e = 0; e < 4; ++e) part[mi][ni][e] = Acc(0);
            Op::mma(part[mi][ni], a[mi], b[ni]);
            if (ks == kKSteps - 1)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if constexpr (kChunkScale)  // part * scale + acc, rounded once
                  acc[mi][ni][e] = fmaf(part[mi][ni][e], csc[mi][e >> 1], acc[mi][ni][e]);
                else
                  acc[mi][ni][e] += part[mi][ni][e];
              }
          }
      }
    }

    if (chunk != n_chunks - 1) continue;
    // The tile is done.  acc[mi][ni][2 g + h] is the sum of doc
    // wm0 + 16 mi + 8 g + lane / 4 for query wn0 + 8 ni + 2 (lane % 4) + h.
    // Candidates that precede their query's depth-th entry go to its buffer.
    const int d0 = (tile_begin + step / n_chunks) * BN;
    bool full = false;  // a buffer this thread appended to holds more than kFlushAt
#pragma unroll
    for (int ni = 0; ni < WN; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wn0 + ni * 8 + 2 * (lane & 3) + h, qi = q0 + r;
        if (qi >= B) continue;
        const float t_s = ts[r];
        const int t_i = ti[r];
        const uint8_t* f = filt ? filt + qi * filt_stride : nullptr;
#pragma unroll
        for (int mi = 0; mi < WM; ++mi)
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            const int id = d0 + wm0 + mi * 16 + g * 8 + (lane >> 2);
            float s = static_cast<float>(acc[mi][ni][2 * g + h]);  // an int32 sum: once, here
            if constexpr (Rows::kRowScale) s *= rsc[mi][g];  // once, after the whole sum
            if (id < n_docs && precedes(s, id, t_s, t_i) && (f == nullptr || f[id] != 0)) {
              const int c = atomicAdd(&cnt[r], 1);
              cs[r * kCap + c] = s;
              ci[r * kCap + c] = id;
              full |= c == kFlushAt;
            }
          }
      }
    // Buffers with more than kFlushAt candidates (all of them after the
    // block's last tile) merge into their lists, one warp per query, and
    // refresh the threshold.  The others wait: a buffer of at most kFlushAt
    // has room for the next tile, and a stale threshold only lets more in.
    const bool last = step + 1 == n_steps;
    if (!__syncthreads_or(full) && !last) continue;
    for (int r = warp; r < BQ; r += kWarps) {
      const int n = cnt[r];
      if (n == 0 || (n <= kFlushAt && !last)) continue;  // warp-uniform
      float* rs = ls + r * K;
      int* ri = li + r * K;
      merge_buffer<kCap>(rs, ri, K, depth, cs + r * kCap, ci + r * kCap, n, lane);
      if (lane == 0) { ts[r] = rs[depth - 1]; ti[r] = ri[depth - 1]; cnt[r] = 0; }
      __syncwarp();
    }
    __syncthreads();
  }

  __syncthreads();
  for (int r = warp; r < BQ; r += kWarps) {
    const int qi = q0 + r;
    if (qi >= B) continue;
    const size_t out = ((size_t)split * B + qi) * K;
    for (int c = lane; c < K; c += 32) {
      part_s[out + c] = ls[r * K + c];
      part_i[out + c] = li[r * K + c];
    }
  }
}

}  // namespace
