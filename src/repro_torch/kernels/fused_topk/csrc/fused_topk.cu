// Fused streaming score -> top-k for Hopper (sm_90a), CUDA C++ with a plain C
// interface (bound with ctypes by ../kernel.py).
//
// Replaces the TPU kernel repro/kernels/fused_topk/kernel.py::fused_topk (def
// 288, pallas_call 359; the Pallas body _fused_topk_kernel): top-`depth` of
// q @ docs.T ("gemm": f32, bf16 -> f32 accumulate, int8 -> int32
// accumulate) or of MinHash collision counts ("lsh", uint32, query slots
// equal to 0xFFFFFFFF never count), masked by an optional keep bitmap `filt`
// ((N,) shared or (B, N) per query) and by the logical row count `n_docs`.
// The (B, N) score matrix never exists in device memory.  Output contract:
// f32 scores (B, depth) sorted descending, int32 ids, ties to the LOWEST doc
// id, empty / masked slots (-inf, -1).
//
// Bound on an H100 SXM (3.35 TB/s, data sheet) at the ann-word2vec cell
// (N = 2,999,808, T = 600 fake terms, B = 256, depth 100):
//   * classic (bf16): 3.6 GB of `scored` to read -> 1.075 ms; the product is
//     9.2e11 FLOP, 0.93 ms on bf16 tensor cores (989 TFLOP/s): bytes bound
//     it.  At B = 1 the bytes bound it alone (1.075 ms).
//   * dot (int8): 1.8 GB of tf -> 0.537 ms; the 9.2e11 int8 operations take
//     0.47 ms on int8 tensor cores (1,979 TOPS): bytes bound it, at B = 1 too.
//   * f32 ground truth (T = 300, depth 10): 3.6 GB -> 1.075 ms, and 4.6e11
//     FLOP, which split TF32 takes as three tf32 products each: 1.38e12 at
//     495 TFLOP/s -> 2.79 ms, so operations bound it (on fp32 CUDA cores, 67
//     TFLOP/s, the same FLOP would take 6.877 ms).
//
// Pass 1 runs a grid of (query tiles x N-splits): a block owns a tile of
// queries and a contiguous range of doc tiles, and keeps a sorted running
// top-K list per query (K = depth rounded up to 32) in shared memory under
// (score desc, id asc), so ties keep the lowest id in any arrival order.
// Blocks of one split are adjacent in launch order, so the re-reads of a
// doc tile by the split's query tiles mostly hit L2.  Pass 2
// (fused_topk_merge): one block per query cuts the splits' sorted lists at
// a threshold no later entry can pass, merges them as a tree under the
// same comparator and writes the first `depth` entries, -inf slots as id
// -1.  The sorted insert, the order and pass 2 live in topk_merge.cuh, the
// counting merge in mma_topk.cuh, both shared with fused_topk_quantized.cu.
//
// classic (bf16): fused_topk_bf16_partial, on tensor cores: the pass-1 body
// of mma_topk.cuh (shared with K4's bf16-query instances in
// fused_topk_quantized.cu) over bf16 rows (Bf16Rows): mma.sync m16n8k16 on
// chunks of 64 columns staged as bf16, docs on the M side and queries on the
// N side (64-query tiles above B = 8, 8-query tiles up to it), a three-stage
// cp.async ring where every q and doc row is 16-byte aligned and registers
// one chunk ahead otherwise, and a running top-k that buffers candidates and
// merges them by counting.
//   * Shared memory at the cell (64 queries, K = 128, three stages): 82,944 B
//     of stages, 65,536 of lists, 81,920 of candidate buffers and 768 of
//     thresholds and counts = 231,168 B, one block per SM; the plan
//     (mma_plan) sizes the splits so that query tiles x splits cover the
//     resident blocks of all SMs (132 blocks at B = 256 and at B = 1).
//   * What holds it back (on an H100, `chip_smoke.py --ablate` times
//     copies of this kernel with parts cut out; numbers in PERF.md): at
//     B = 256 the loads from L2 (4 query tiles re-read the store, and each
//     re-stages its 64 query rows with every doc tile) take about half, the
//     running top-k over a third; at B = 1 the loads run at about 2.4 TB/s.
//     mma.sync is the warp-level instruction (wgmma, the warpgroup one,
//     reaches the full tensor-core rate), and the ring is cp.async, not TMA.
//     A later PR would keep the query tile resident, feed wgmma from a TMA
//     ring, and share a doc tile between the query tiles of a cluster (TMA
//     multicast).
//
// dot (int8): fused_topk_int8_partial, the same body over int8 rows
// (I8Rows), which replaces the CUDA-core __dp4a pass 1 that ran this mode at
// 54 ms (PERF.md).  A chunk is 128 int8 columns in the same 128 staged bytes
// a row, multiplied by mma.sync m16n8k32 s8 x s8 -> s32 (IMMA) with the same
// ldmatrix addresses, so T = 600 takes 5 chunks where bf16 takes 10; the sums
// are exact int32, as the reference's, and become f32 once, at the threshold
// test.  Rows are staged as they are, with no widening: a cp.async ring of
// 16-byte copies where every q and doc row is 16-byte aligned, of two 8-byte
// copies a pack where they are 8-byte aligned (the cell's 600-byte rows), and
// registers one chunk ahead otherwise.  The plan and the shared memory are
// K1 classic's (the staged bytes are the same).  What sets its pace is what
// sets K1 classic's (above): the loads, four query tiles re-reading the
// store from L2 (here through L1, cp.async.ca, at 8-byte copies), and the
// running top-k; the products are half of K1 classic's instructions.
//
// f32 (the exact cosine: the ground truth and brute force over fp32
// postings): fused_topk_f32_partial, the same body over raw f32 rows
// (F32Rows) with the product type MmaTf32x3, which replaces a CUDA-core
// f32 FMA pass 1 (25.3 -> 11.2 ms at the cell, B = 256; PERF.md).  A
// chunk is 32 f32 columns in the same 128 staged bytes a row, so T = 300
// takes 10 chunks, the staged bytes and chunk count of K1 classic at
// T = 600.  Doc and query fragments are each split after ldmatrix into a
// high and a low tf32 part by bit masks, and a k-step is three m16n8k8 tf32
// mma (doc lo x q hi, doc hi x q lo, doc hi x q hi) onto the chunk's own
// fragment, which an f32 add folds into the row's sum: a score is off by at
// most 3 2^-20 |q| |d| (mma_topk.cuh), 2.9e-6 for the unit vectors of the
// cosine, inside the near-tie rule.  Rows go straight into the cp.async
// ring where every q and doc row is 16-byte aligned (T a multiple of 4),
// else through registers; the plan and the shared memory are K1 classic's.
// At B = 256 (`chip_smoke.py --ablate`) the loads take ~4.5 ms, the three
// tf32 products ~5.2 and the running top-k ~1.7; at B <= 8 the loads.
//
// lsh (K2): fused_topk_lsh_partial, on CUDA cores.  Bound at the lexical-LSH
// cell (N = 2,999,808, S = 300 slots, B = 256, depth 100): 2.3e11 compares,
// 13.796 ms at one INT32 operation each (64 INT32 lanes an SM, 16.7e12
// op/s); at B = 1 the 3.6 GB of signatures, 1.075 ms.  A count of 32-bit
// equalities is not a product, and only exact equality counts, so tensor
// cores cannot take it: any fingerprint or one-hot encoding would change
// the results.  What the design does about the rest:
//   * The compare (lsh_word): one ISETP a (query, doc, slot), with the
//     query slot's sentinel test done once per query word and ANDed in as
//     its predicate, and a predicated FADD into an f32 count (exact to
//     2^24) on the FP32 pipe, beside the ISETPs on the INT32 one.  A thread
//     counts 4 queries x 8 docs at 64-query tiles, so the sentinel ISETP is
//     an eighth of one a compare: ~1.125 ALU instructions and ~2.2 issued a
//     compare (chip_smoke.k2_compare_ops prints them), an ALU floor of
//     ~15.5 ms at the cell.  Query and doc slots come 4 at a time by LDS.128
//     from rows kLshStride words apart (conflict-free), no register spills.
//   * The loads: a three-stage cp.async ring of 32-slot chunks of the tile's
//     doc rows and the query rows (16-byte copies where every row is
//     16-byte aligned, 4-byte ones otherwise), two chunks in flight.
//   * The running top-k: each query's threshold, its list's depth-th score,
//     lives in a register and is read again only after a merge; a count that
//     beats it goes to the query's candidate buffer, and a buffer past BN / 4
//     merges into the list by counting (merge_buffer of mma_topk.cuh, a warp
//     a query, the whole block at one query).  Ids ascend within a block, so
//     a count that only ties the threshold cannot rank, and the test needs
//     no id.
//   * The plan (lsh_plan): 64-query tiles of 128 docs from B = 9; at B <= 8
//     the tile of 1, 2, 4 or 8 rows that holds B, of 256 docs, so padded
//     rows run no compares; splits so that every SM holds its blocks (two a
//     SM at B = 1).
// PERF.md §6 has its times, the ablation (chip_smoke.py --ablate, ablate_k2)
// and the instructions a compare.

// K3, the gathered variant (fused_topk_gathered_partial + the same merge),
// replaces repro/kernels/fused_topk/kernel.py::fused_topk_gathered (def 433,
// pallas_call 485): per query b, the top-`depth` of score(q[b], store[id])
// over the ids in row_ids[b, :R] (blockmax stage 2: each query scores only
// the rows of the blocks it kept), in the same four score modes.  Ties go to
// the lowest GLOBAL id; ids outside [0, n_docs) never rank and are never
// read.  The TPU kernel takes rows already gathered into a (B, R, T) tensor;
// at the ann-word2vec shapes with 10% of the 256-row blocks kept (R =
// 299,776, T = 600 bf16) that tensor is 360 MB per query, 92 GB at B = 256.
// So this kernel gathers the rows itself, by id, from the stored (N, T)
// matrix, and the (B, R, T) tensor never exists.
//
// Bound: a batched GEMV, bound by bytes.  What the card must read is each
// distinct kept row once (a row that several queries keep is needed once),
// the query and the ids: at the blockmax cell that is 0.108 ms at B = 1 and
// 0.485 ms at B = 8 on an H100 (3.35 TB/s; chip_smoke.gathered_bound_ms).
// This design shares no row between the queries that keep it, so its own
// floor is the no-reuse bytes B * R * (T * elem + 4): 2.88 GB, 0.86 ms at
// B = 8.  Tensor cores would buy nothing: each query has its own rows, so
// no product is reused.
//
// Design: grid (B, row splits), one query per block; B x splits is the
// blocks the SMs hold at once (two each), so at small B each block walks a
// long row range (fused_topk_gathered_plan).  The query row sits in shared
// memory.  A warp scores 32 rows a round, reading each row whole and
// contiguously (lane l loads 16-byte packs l, l + 32, ...; 8-byte or element
// loads where rows are not 16-byte aligned), 4 rows at a time with every
// pack of a 3-round load group in flight before the first product, and
// sums the 4 rows across the warp in one transposed butterfly.  The block
// keeps one running list: a score that precedes the list's depth-th entry
// (the full (score desc, id asc) comparator: ids arrive in any order, so a
// tied score with a lower id must enter) goes to a candidate buffer, which
// the whole block merges into the list by counting (merge_buffer of
// mma_topk.cuh) once it is past a quarter of a round, so a row that cannot
// rank costs one compare.  Pass 2 merges the splits' lists.  No tensor
// cores, no TMA, no sharing of a kept block between the queries that keep
// it (PERF.md: at B = 256 pass 1 reads each query's rows, ~92 GB).

#include "mma_topk.cuh"  // K1 classic's tensor-core pass 1; includes topk_merge.cuh
#include "lsh_count.cuh"  // K2's compare and thread tile, shared with K8

namespace {

// The score modes (Mode, Traits, Vec, load_pack, store_pack, mac) are in
// score_operands.cuh, shared with the register loader of K6 and K7, and used
// here by K3.  K2 has a compare of its own (lsh_word, lsh_count.cuh, shared
// with K8).

// ---------------------------------------------------------------------------
// K2: K1's lsh mode (fused_topk_lsh_partial), on CUDA cores.
// ---------------------------------------------------------------------------

static_assert(kLshThreads == kThreads, "K2's block of one query merges with the whole block");

// Dynamic shared memory of a K2 block of bq queries at list width K: the
// ring's stages (bn doc rows, then bq query rows, kLshStride words each), bq
// running lists of K (score, id) pairs, bq candidate buffers of
// cand_cap(bn) pairs, and each query's threshold and count.
constexpr size_t lsh_smem(int bq, int K) {
  return (size_t)kLshStages * (lsh_bn(bq) + bq) * kLshStride * 4 + (size_t)bq * K * 8 +
         (size_t)bq * cand_cap(lsh_bn(bq)) * 8 + (size_t)bq * 8;
}

// K2's launch plan for B queries over n_docs rows at `depth` on sm_count
// SMs: plan[0] queries a block (64 from B = 9; at B <= 8 the tile of 1, 2,
// 4 or 8 rows that holds them; smaller where the lists do not fit), plan[1]
// K (depth rounded up to 32), plan[2] N-splits, plan[3] doc tiles per
// split, plan[4] docs a tile (lsh_bn), so that query tiles x splits cover
// every SM's resident blocks, at B = 256 and at B = 1 alike.  Returns
// cudaErrorInvalidValue if no block fits in shared memory or pass 2 cannot
// merge lists of depth.
inline int lsh_plan(int B, int n_docs, int depth, int sm_count, int* plan) {
  if (B <= 0 || n_docs <= 0 || depth <= 0 || sm_count <= 0) return (int)cudaErrorInvalidValue;
  const int K = (depth + 31) / 32 * 32;
  int bq = B >= 9 ? 64 : (B >= 5 ? 8 : (B >= 3 ? 4 : B));
  while (bq > 1 && lsh_smem(bq, K) > kMaxSmem) bq = bq == 64 ? 8 : bq / 2;
  if (lsh_smem(bq, K) > kMaxSmem || merge_lists(depth) < 2) return (int)cudaErrorInvalidValue;
  const size_t per_block = lsh_smem(bq, K) + kSmemPerBlock;
  const int resident = kSmemPerSm / per_block > 1 ? (int)(kSmemPerSm / per_block) : 1;
  const int bn = lsh_bn(bq);
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


// Grid (query tiles of BQ, splits): block (x, split) owns queries [x * BQ,
// x * BQ + BQ) and doc tiles [split * tiles_per_split, ...) of BN docs, in
// ascending order.  Each step stages one chunk of kBK slots of the tile's
// doc rows and of the query rows through a cp.async ring of kLshStages
// (CP = 16: 16-byte copies, every row 16-byte aligned; CP = 4: 4-byte
// copies; a copy past S or of a row that does not exist is zero-filled and
// never read), and every thread adds the chunk's equalities to its TQ x TD
// counts (lsh_chunk).  After a tile's last chunk a count that beats its
// query's threshold goes to the query's candidate buffer (a shared-memory
// atomicAdd on the query's count).  The threshold is the depth-th score of
// the query's list, in a register: -inf until the list holds depth entries.
// A count that only ties it cannot rank, since ids ascend within a block,
// and between merges a stale threshold only lets more in.  Once a buffer
// holds more than BN / 4 (and after the block's last tile) every buffer
// that holds a candidate merges into its list by counting (merge_buffer: a
// warp a query, the warps taking the queries in turn, or the whole block at
// one query), and the thresholds are read again.  Writes each query's
// sorted list of K to part_s / part_i (splits, B, K).
template <int BQ, int CP>
__global__ void __launch_bounds__(LshTile<BQ>::NT, 1) fused_topk_lsh_partial(
    const uint32_t* __restrict__ q,     // (B, S)
    const uint32_t* __restrict__ docs,  // (N, S), rows >= n_docs unread
    const uint8_t* __restrict__ filt,   // nullptr | (N,) | (B, N)
    long long filt_stride,              // 0 for (N,), N for (B, N)
    int B, int n_docs, int S, int depth, int K, int tiles_per_split,
    float* __restrict__ part_s, int* __restrict__ part_i) {  // (splits, B, K)
  using L = LshTile<BQ>;
  constexpr int BN = L::BN, TQ = L::TQ, TD = L::TD, DG = L::DG, NT = L::NT, kNWarps = NT / 32;
  constexpr int kCap = cand_cap(BN), kFlushAt = flush_at(BN);
  constexpr int kStage = (BN + BQ) * kLshStride;  // words
  constexpr int kUnits = kBK * 4 / CP;            // copies a staged row and chunk
  static_assert(BN == lsh_bn(BQ), "lsh_bn sizes the plan and the shared memory");
  static_assert(CP == 16 || CP == 4, "16- or 4-byte copies");

  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* stages = reinterpret_cast<uint32_t*>(smem);
  float* ls = reinterpret_cast<float*>(stages + kLshStages * kStage);  // BQ x K
  int* li = reinterpret_cast<int*>(ls + BQ * K);
  float* cs = reinterpret_cast<float*>(li + BQ * K);  // BQ x kCap candidates
  int* ci = reinterpret_cast<int*>(cs + BQ * kCap);
  float* ts = reinterpret_cast<float*>(ci + BQ * kCap);  // each list's depth-th score
  int* cnt = reinterpret_cast<int*>(ts + BQ);            // candidates per query

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dg = tid % DG, qg = tid / DG;
  const int q0 = blockIdx.x * BQ, split = blockIdx.y;
  const int rows = min(TQ, B - (q0 + qg * TQ));  // this thread's queries that exist
  const int n_chunks = (S + kBK - 1) / kBK;
  const int n_tiles = (n_docs + BN - 1) / BN;
  const int tile_begin = split * tiles_per_split;
  const int n_steps = max(0, min(tile_begin + tiles_per_split, n_tiles) - tile_begin) * n_chunks;

  for (int e = tid; e < BQ * K; e += NT) { ls[e] = -INFINITY; li[e] = kBigId; }
  for (int r = tid; r < BQ; r += NT) { ts[r] = -INFINITY; cnt[r] = 0; }

  auto copy_step = [&](int step) {  // chunk `step` of the doc and query rows into its stage
    uint32_t* st = stages + (step % kLshStages) * kStage;
    const int d0 = (tile_begin + step / n_chunks) * BN;
    const int w0 = (step % n_chunks) * kBK;
    for (int v = tid; v < (BN + BQ) * kUnits; v += NT) {
      const int r = v / kUnits, e = w0 + (v % kUnits) * (CP / 4);
      const bool is_doc = r < BN;
      const int row = is_doc ? d0 + r : q0 + r - BN;
      const bool ok = (is_doc ? row < n_docs : row < B) && e < S;
      const uint32_t* src = (is_doc ? docs : q) + (ok ? (size_t)row * S + e : 0);
      uint32_t* dst = st + r * kLshStride + (v % kUnits) * (CP / 4);
      if constexpr (CP == 16) cp_async16(dst, src, ok ? 16 : 0);
      else cp_async4(dst, src, ok ? 4 : 0);
    }
  };

  float acc[TQ][TD];
  float thr[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) thr[i] = -INFINITY;
#pragma unroll
  for (int s0 = 0; s0 < kLshStages - 1; ++s0) {
    if (s0 < n_steps) copy_step(s0);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    const int chunk = step % n_chunks;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
    }
    // This chunk has landed; after the barrier every thread is done with the
    // stage of the previous step, which the chunk kLshStages - 1 ahead fills.
    cp_async_wait<kLshStages - 2>();
    __syncthreads();
    if (step + kLshStages - 1 < n_steps) copy_step(step + kLshStages - 1);
    cp_async_commit();
    const uint32_t* ds = stages + (step % kLshStages) * kStage;
    const int words = min(kBK, S - chunk * kBK);
    if (rows >= TQ) lsh_chunk<BQ, true>(acc, ds, ds + BN * kLshStride, dg, qg, words, TQ);
    else if (rows > 0) lsh_chunk<BQ, false>(acc, ds, ds + BN * kLshStride, dg, qg, words, rows);

    if (chunk != n_chunks - 1) continue;
    // The tile is done: counts that beat their query's threshold go to its buffer.
    const int d0 = (tile_begin + step / n_chunks) * BN;
    bool full = false;  // a buffer this thread appended to holds more than kFlushAt
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      if (i >= rows) break;
      const int r = qg * TQ + i;
      const uint8_t* f = filt ? filt + (q0 + r) * filt_stride : nullptr;
#pragma unroll
      for (int j = 0; j < TD; ++j) {
        const int id = d0 + dg + DG * j;
        if (acc[i][j] > thr[i] && id < n_docs && (f == nullptr || f[id] != 0)) {
          const int c = atomicAdd(&cnt[r], 1);
          cs[r * kCap + c] = acc[i][j];
          ci[r * kCap + c] = id;
          full |= c == kFlushAt;
        }
      }
    }
    // Once a buffer holds more than kFlushAt candidates (and after the
    // block's last tile) every buffer that holds one merges into its list
    // and refreshes its threshold: the flushes stop the block fewer times.
    // Until then a buffer of at most kFlushAt has room for the next tile,
    // and a stale threshold only lets more in.
    const bool last = step + 1 == n_steps;
    if (!__syncthreads_or(full) && !last) continue;
    if constexpr (BQ == 1) {  // the whole block merges the one buffer
      const int n = cnt[0];
      if (n > 0) {  // block-uniform
        merge_buffer<kCap, kThreads>(ls, li, K, depth, cs, ci, n, tid);
        __syncthreads();
        if (tid == 0) { ts[0] = ls[depth - 1]; cnt[0] = 0; }
      }
    } else {
      for (int r = warp; r < BQ; r += kNWarps) {
        const int n = cnt[r];
        if (n == 0) continue;  // warp-uniform
        merge_buffer<kCap>(ls + r * K, li + r * K, K, depth, cs + r * kCap, ci + r * kCap, n,
                           lane);
        if (lane == 0) { ts[r] = ls[r * K + depth - 1]; cnt[r] = 0; }
        __syncwarp();
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TQ; ++i) thr[i] = ts[qg * TQ + i];
  }

  __syncthreads();
  for (int r = warp; r < BQ; r += kNWarps) {
    const int qi = q0 + r;
    if (qi >= B) continue;
    const size_t out = ((size_t)split * B + qi) * K;
    for (int c = lane; c < K; c += 32) {
      part_s[out + c] = ls[r * K + c];
      part_i[out + c] = li[r * K + c];
    }
  }
}

template <int BQ, int CP>
cudaError_t launch_lsh_instance(const void* q, const void* docs, const uint8_t* filt,
                                long long filt_stride, int B, int n_docs, int S, int depth,
                                int K, int splits, int tiles_per_split, float* part_s,
                                int* part_i, cudaStream_t stream) {
  const size_t smem = lsh_smem(BQ, K);
  auto kernel = fused_topk_lsh_partial<BQ, CP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BQ - 1) / BQ, splits);
  constexpr int threads = LshTile<BQ>::NT;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(docs), filt, filt_stride, B,
      n_docs, S, depth, K, tiles_per_split, part_s, part_i);
  return cudaGetLastError();
}

// K2's pass 1 for the plan's bq: 16-byte copies where every q and doc row
// is 16-byte aligned (aligned bits 0 and 1), else 4-byte ones.
cudaError_t launch_lsh(int bq, const void* q, const void* docs, const uint8_t* filt,
                       long long filt_stride, int B, int n_docs, int S, int depth, int K,
                       int splits, int tiles_per_split, int aligned, float* part_s, int* part_i,
                       cudaStream_t stream) {
  if (lsh_smem(bq, K) > kMaxSmem) return cudaErrorInvalidValue;
#define FUSED_TOPK_LSH(BQ, CP)                                                              \
  return launch_lsh_instance<BQ, CP>(q, docs, filt, filt_stride, B, n_docs, S, depth, K,    \
                                     splits, tiles_per_split, part_s, part_i, stream)
  const bool wide = (aligned & 3) == 3;
  switch (bq) {
    case 64: if (wide) FUSED_TOPK_LSH(64, 16); FUSED_TOPK_LSH(64, 4);
    case 8: if (wide) FUSED_TOPK_LSH(8, 16); FUSED_TOPK_LSH(8, 4);
    case 4: if (wide) FUSED_TOPK_LSH(4, 16); FUSED_TOPK_LSH(4, 4);
    case 2: if (wide) FUSED_TOPK_LSH(2, 16); FUSED_TOPK_LSH(2, 4);
    case 1: if (wide) FUSED_TOPK_LSH(1, 16); FUSED_TOPK_LSH(1, 4);
    default: return cudaErrorInvalidValue;
  }
#undef FUSED_TOPK_LSH
}

// ---------------------------------------------------------------------------
// K1 classic (bf16), dot (int8) and f32 pass 1 on tensor cores
// (fused_topk_bf16_partial, fused_topk_int8_partial, fused_topk_f32_partial):
// the shared body of mma_topk.cuh over bf16, int8 or f32 rows.
// ---------------------------------------------------------------------------

// bf16 rows (N, T) as they are stored: an 8-column pack is one 16-byte load
// (load_pack), or elements where rows are not 16-byte aligned.
struct Bf16Rows {
  using Op = MmaBf16;
  using Unit = uint4;
  static constexpr bool kAsync = true;   // straight into the bf16 stages
  static constexpr bool kRaw = false;
  static constexpr bool kRowScale = false;
  static constexpr bool kChunkScale = false;
  const uint16_t* __restrict__ docs;
  int T;
  bool aligned;  // every row 16-byte aligned

  __device__ __forceinline__ Unit load(int di, bool ok, int e) const {
    return load_pack<kBF16, false>(docs + (size_t)di * T, ok, e, T, aligned ? 16 : 1, false);
  }
  __device__ __forceinline__ uint4 widen(Unit u) const { return u; }
  __device__ __forceinline__ float row_scale(int) const { return 1.f; }
};

template <int BQ, int BN, int NS, bool ASYNC>
__global__ void __launch_bounds__(kThreads, 1) fused_topk_bf16_partial(
    const uint16_t* __restrict__ q,     // (B, T) bf16 bits
    const uint16_t* __restrict__ docs,  // (N, T) bf16 bits, rows >= n_docs unread
    const uint8_t* __restrict__ filt,   // nullptr | (N,) | (B, N)
    long long filt_stride,              // 0 for (N,), N for (B, N)
    int B, int n_docs, int T, int depth, int K, int tiles_per_split,
    bool q_aligned, bool d_aligned,     // rows 16-byte aligned
    float* __restrict__ part_s, int* __restrict__ part_i) {  // (splits, B, K)
  const Bf16Rows rows{docs, T, d_aligned};
  mma_topk_pass1<Bf16Rows, BQ, BN, NS, ASYNC>(q, rows, filt, filt_stride, B, n_docs, T, depth,
                                              K, tiles_per_split, q_aligned ? 16 : 1, part_s,
                                              part_i);
}

template <int BQ, int BN, int NS, bool ASYNC>
cudaError_t launch_bf16_instance(const void* q, const void* docs, const uint8_t* filt,
                                 long long filt_stride, int B, int n_docs, int T, int depth,
                                 int K, int splits, int tiles_per_split, int aligned,
                                 float* part_s, int* part_i, cudaStream_t stream) {
  const size_t smem = mma_smem(BQ, BN, NS, K);
  auto kernel = fused_topk_bf16_partial<BQ, BN, NS, ASYNC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BQ - 1) / BQ, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(docs), filt, filt_stride, B,
      n_docs, T, depth, K, tiles_per_split, (aligned & 1) != 0, (aligned & 2) != 0, part_s,
      part_i);
  return cudaGetLastError();
}

// The bf16 pass 1 for the plan's bq; the tile and stages follow from
// (bq, K) as in mma_plan, the loader from the rows' alignment.
cudaError_t launch_bf16(int bq, const void* q, const void* docs, const uint8_t* filt,
                        long long filt_stride, int B, int n_docs, int T, int depth, int K,
                        int splits, int tiles_per_split, int aligned, float* part_s,
                        int* part_i, cudaStream_t stream) {
  int bn = 0, stages = 0;
  if (!mma_shape(bq, K, kStages, &bn, &stages)) return cudaErrorInvalidValue;
#define FUSED_TOPK_BF16(BQ, BN, NS, ASYNC)                                                   \
  return launch_bf16_instance<BQ, BN, NS, ASYNC>(q, docs, filt, filt_stride, B, n_docs, T,    \
                                                 depth, K, splits, tiles_per_split, aligned, \
                                                 part_s, part_i, stream)
  const bool async = (aligned & 3) == 3;
  if (stages == 1) FUSED_TOPK_BF16(8, 128, 1, false);
  if (bq == 64) {
    if (async) FUSED_TOPK_BF16(64, 128, kStages, true);
    FUSED_TOPK_BF16(64, 128, kRegStages, false);
  }
  if (async) FUSED_TOPK_BF16(8, 256, kStages, true);
  FUSED_TOPK_BF16(8, 256, kRegStages, false);
#undef FUSED_TOPK_BF16
}

// int8 rows (N, T) as they are stored (K1 dot: the index's tf), staged
// without widening: a 16-column pack through registers is one 16-byte load,
// two 8-byte loads, or bytes past the last whole pack and where rows are not
// 8-byte aligned (load_pack).
struct I8Rows {
  using Op = MmaS8;
  using Unit = uint4;
  static constexpr bool kAsync = true;   // straight into the int8 stages
  static constexpr bool kRaw = false;
  static constexpr bool kRowScale = false;
  static constexpr bool kChunkScale = false;
  const int8_t* __restrict__ docs;
  int T, align;  // the byte alignment every row starts at: 16, 8 or 1

  __device__ __forceinline__ Unit load(int di, bool ok, int e) const {
    return load_pack<kI8>(docs + (size_t)di * T, ok, e, T, align, false);
  }
  __device__ __forceinline__ uint4 widen(Unit u) const { return u; }
  __device__ __forceinline__ float row_scale(int) const { return 1.f; }
};

// RING: the bytes of one cp.async copy of the ring (16 or 8), or 0 for the
// register-staged loader.
template <int BQ, int BN, int NS, int RING>
__global__ void __launch_bounds__(kThreads, 1) fused_topk_int8_partial(
    const int8_t* __restrict__ q,       // (B, T)
    const int8_t* __restrict__ docs,    // (N, T), rows >= n_docs unread
    const uint8_t* __restrict__ filt,   // nullptr | (N,) | (B, N)
    long long filt_stride,              // 0 for (N,), N for (B, N)
    int B, int n_docs, int T, int depth, int K, int tiles_per_split,
    int q_align, int d_align,           // the byte alignment every row starts at
    float* __restrict__ part_s, int* __restrict__ part_i) {  // (splits, B, K)
  const I8Rows rows{docs, T, d_align};
  mma_topk_pass1<I8Rows, BQ, BN, NS, RING != 0, RING != 0 ? RING : 16>(
      q, rows, filt, filt_stride, B, n_docs, T, depth, K, tiles_per_split, q_align, part_s,
      part_i);
}

template <int BQ, int BN, int NS, int RING>
cudaError_t launch_int8_instance(const void* q, const void* docs, const uint8_t* filt,
                                 long long filt_stride, int B, int n_docs, int T, int depth,
                                 int K, int splits, int tiles_per_split, int q_align,
                                 int d_align, float* part_s, int* part_i, cudaStream_t stream) {
  const size_t smem = mma_smem(BQ, BN, NS, K);
  auto kernel = fused_topk_int8_partial<BQ, BN, NS, RING>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BQ - 1) / BQ, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(docs), filt, filt_stride, B,
      n_docs, T, depth, K, tiles_per_split, q_align, d_align, part_s, part_i);
  return cudaGetLastError();
}

// The int8 pass 1 for the plan's bq, shaped as launch_bf16: the tile and
// stages follow from (bq, K) as in mma_plan, the loader from the rows'
// alignment, the lower of q's and the docs': a ring of 16-byte copies, of
// 8-byte copies, or registers.
cudaError_t launch_int8(int bq, const void* q, const void* docs, const uint8_t* filt,
                        long long filt_stride, int B, int n_docs, int T, int depth, int K,
                        int splits, int tiles_per_split, int q_align, int d_align,
                        float* part_s, int* part_i, cudaStream_t stream) {
  int bn = 0, stages = 0;
  if (!mma_shape(bq, K, kStages, &bn, &stages)) return cudaErrorInvalidValue;
#define FUSED_TOPK_INT8(BQ, BN, NS, RING)                                                     \
  return launch_int8_instance<BQ, BN, NS, RING>(q, docs, filt, filt_stride, B, n_docs, T,      \
                                                depth, K, splits, tiles_per_split, q_align,   \
                                                d_align, part_s, part_i, stream)
  const int ring = q_align < d_align ? q_align : d_align;
  if (stages == 1) FUSED_TOPK_INT8(8, 128, 1, 0);
  if (bq == 64) {
    if (ring == 16) FUSED_TOPK_INT8(64, 128, kStages, 16);
    if (ring == 8) FUSED_TOPK_INT8(64, 128, kStages, 8);
    FUSED_TOPK_INT8(64, 128, kRegStages, 0);
  }
  if (ring == 16) FUSED_TOPK_INT8(8, 256, kStages, 16);
  if (ring == 8) FUSED_TOPK_INT8(8, 256, kStages, 8);
  FUSED_TOPK_INT8(8, 256, kRegStages, 0);
#undef FUSED_TOPK_INT8
}

// f32 rows (N, T) as they are stored: a 4-column pack is one 16-byte load
// (load_pack), or elements where rows are not 16-byte aligned.  Raw f32 is
// not exact in tf32: the product type splits the doc fragments too.
struct F32Rows {
  using Op = MmaTf32x3;
  using Unit = uint4;
  static constexpr bool kAsync = true;   // straight into the f32 stages
  static constexpr bool kRaw = false;
  static constexpr bool kRowScale = false;
  static constexpr bool kChunkScale = false;
  const float* __restrict__ docs;
  int T;
  bool aligned;  // every row 16-byte aligned

  __device__ __forceinline__ Unit load(int di, bool ok, int e) const {
    return load_pack<kF32, false>(docs + (size_t)di * T, ok, e, T, aligned ? 16 : 1, false);
  }
  __device__ __forceinline__ uint4 widen(Unit u) const { return u; }
  __device__ __forceinline__ float row_scale(int) const { return 1.f; }
};

template <int BQ, int BN, int NS, bool ASYNC>
__global__ void __launch_bounds__(kThreads, 1) fused_topk_f32_partial(
    const float* __restrict__ q,        // (B, T)
    const float* __restrict__ docs,     // (N, T), rows >= n_docs unread
    const uint8_t* __restrict__ filt,   // nullptr | (N,) | (B, N)
    long long filt_stride,              // 0 for (N,), N for (B, N)
    int B, int n_docs, int T, int depth, int K, int tiles_per_split,
    bool q_aligned, bool d_aligned,     // rows 16-byte aligned
    float* __restrict__ part_s, int* __restrict__ part_i) {  // (splits, B, K)
  const F32Rows rows{docs, T, d_aligned};
  mma_topk_pass1<F32Rows, BQ, BN, NS, ASYNC>(q, rows, filt, filt_stride, B, n_docs, T, depth, K,
                                             tiles_per_split, q_aligned ? 16 : 1, part_s, part_i);
}

template <int BQ, int BN, int NS, bool ASYNC>
cudaError_t launch_f32_instance(const void* q, const void* docs, const uint8_t* filt,
                                long long filt_stride, int B, int n_docs, int T, int depth,
                                int K, int splits, int tiles_per_split, int aligned,
                                float* part_s, int* part_i, cudaStream_t stream) {
  const size_t smem = mma_smem(BQ, BN, NS, K);
  auto kernel = fused_topk_f32_partial<BQ, BN, NS, ASYNC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BQ - 1) / BQ, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(docs), filt, filt_stride, B,
      n_docs, T, depth, K, tiles_per_split, (aligned & 1) != 0, (aligned & 2) != 0, part_s,
      part_i);
  return cudaGetLastError();
}

// The f32 pass 1 for the plan's bq, shaped as launch_bf16 (the same staged
// bytes, so the same tiles and stages): the ring where every q and doc row
// is 16-byte aligned, registers otherwise.
cudaError_t launch_f32(int bq, const void* q, const void* docs, const uint8_t* filt,
                       long long filt_stride, int B, int n_docs, int T, int depth, int K,
                       int splits, int tiles_per_split, int aligned, float* part_s,
                       int* part_i, cudaStream_t stream) {
  int bn = 0, stages = 0;
  if (!mma_shape(bq, K, kStages, &bn, &stages)) return cudaErrorInvalidValue;
#define FUSED_TOPK_F32(BQ, BN, NS, ASYNC)                                                    \
  return launch_f32_instance<BQ, BN, NS, ASYNC>(q, docs, filt, filt_stride, B, n_docs, T,    \
                                                depth, K, splits, tiles_per_split, aligned, \
                                                part_s, part_i, stream)
  const bool async = (aligned & 3) == 3;
  if (stages == 1) FUSED_TOPK_F32(8, 128, 1, false);
  if (bq == 64) {
    if (async) FUSED_TOPK_F32(64, 128, kStages, true);
    FUSED_TOPK_F32(64, 128, kRegStages, false);
  }
  if (async) FUSED_TOPK_F32(8, 256, kStages, true);
  FUSED_TOPK_F32(8, 256, kRegStages, false);
#undef FUSED_TOPK_F32
}

// ---------------------------------------------------------------------------
// K3: top-`depth` over per-query gathered rows (fused_topk_gathered_partial).
// ---------------------------------------------------------------------------

constexpr int kK3Rows = 4;         // rows a warp scores at once
constexpr int kK3Rounds = 3;       // 32-lane rounds of a row's 16-byte packs loaded at once
constexpr int kK3Bytes = kK3Rounds * 32 * 16;  // row bytes of one load group

// The query row of a K3 pass-1 block in shared memory, padded to whole load
// groups (the list and buffer follow it: row_block_smem, topk_merge.cuh).
__host__ __device__ constexpr size_t gathered_query_bytes(int t, int elem) {
  return (size_t)((t * elem + kK3Bytes - 1) / kK3Bytes) * kK3Bytes;
}

// acc + <query pack, row pack> in the mode's arithmetic: bf16 widened to f32
// (exact products), int8 by __dp4a, lsh as sentinel-aware equality counts.
template <int M>
__device__ __forceinline__ typename Traits<M>::Acc dot_pack(typename Traits<M>::Acc acc,
                                                            uint4 qa, uint4 da) {
  const uint32_t qw[4] = {qa.x, qa.y, qa.z, qa.w};
  const uint32_t dw[4] = {da.x, da.y, da.z, da.w};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    if constexpr (M == kBF16) {
      acc = fmaf(__uint_as_float(qw[w] << 16), __uint_as_float(dw[w] << 16), acc);
      acc = fmaf(__uint_as_float(qw[w] & 0xFFFF0000u), __uint_as_float(dw[w] & 0xFFFF0000u), acc);
    } else {
      acc = mac<M>(acc, from_bits<M>(qw[w]), from_bits<M>(dw[w]));
    }
  }
  return acc;
}

// The warp's sums of four per-lane values at once, transposed: lane l ends
// with the sum over all lanes of a[(l >> 3) & 3].  Six shuffles where four
// separate sums take twenty, each step halving what a lane still carries.
template <class A>
__device__ __forceinline__ A warp_sum4(const A (&a)[4], int lane) {
  const bool hi16 = (lane & 16) != 0, hi8 = (lane & 8) != 0;
  A s0 = hi16 ? a[2] : a[0], s1 = hi16 ? a[3] : a[1];
  s0 += __shfl_xor_sync(kFull, hi16 ? a[0] : a[2], 16);
  s1 += __shfl_xor_sync(kFull, hi16 ? a[1] : a[3], 16);
  A k = hi8 ? s1 : s0;
  k += __shfl_xor_sync(kFull, hi8 ? s0 : s1, 8);
#pragma unroll
  for (int m = 4; m > 0; m >>= 1) k += __shfl_xor_sync(kFull, k, m);
  return k;
}

// Grid (B, splits): block (b, split) owns rows [split * rows_per_split, ...)
// of query b's R gathered rows and keeps one running list of K for them.
// The block scores kRowRound rows a round, each warp 32: its lanes read
// kK3Rows rows together (lane l the 16-byte packs l, l + 32, ... of each),
// every pack of a load group in flight before the first product, reduce the
// rows' sums across the warp at once (warp_sum4), and lane r keeps row r's
// score.  A score that precedes the list's depth-th entry (the full
// comparator: ids arrive in any order) goes to the block's candidate
// buffer; once the buffer holds more than kRowFlushAt, or after the last
// round, the whole block merges it into the list by counting
// (merge_buffer) and refreshes the threshold.  A row whose id is outside
// [0, n_docs) is never read and never ranks; an id that comes twice is
// scored and ranked twice, as the reference ranks it.
template <int M>
__global__ void __launch_bounds__(kThreads, kRowBlocksPerSm) fused_topk_gathered_partial(
    const typename Traits<M>::Raw* __restrict__ q,      // (B, T)
    const typename Traits<M>::Raw* __restrict__ store,  // (N, T)
    const int* __restrict__ row_ids,                     // (B, R)
    int B, int R, int n_docs, int T, int depth, int K, int rows_per_split, int align,
    float* __restrict__ part_s, int* __restrict__ part_i) {  // (splits, B, K)
  using Tr = Traits<M>;
  using V = Vec<M>;
  using Raw = typename Tr::Raw;
  using Acc = typename Tr::Acc;
  static_assert(kK3Rows == 4, "warp_sum4 sums four rows");

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t q_bytes = gathered_query_bytes(T, sizeof(Raw));
  Raw* qs = reinterpret_cast<Raw*>(smem);
  float* ls = reinterpret_cast<float*>(smem + q_bytes);  // K running scores
  int* li = reinterpret_cast<int*>(ls + K);               // K running ids
  float* cs = reinterpret_cast<float*>(li + K);           // kRowCap candidates
  int* ci = reinterpret_cast<int*>(cs + kRowCap);
  float* ts = reinterpret_cast<float*>(ci + kRowCap);      // the list's depth-th entry
  int* ti = reinterpret_cast<int*>(ts + 1);
  int* cnt = ti + 1;                                       // candidates in the buffer

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, split = blockIdx.y;
  const int row0 = split * rows_per_split;
  const int row1 = min(R, row0 + rows_per_split);
  const int n_rounds = (max(0, row1 - row0) + kRowRound - 1) / kRowRound;
  const int n_packs = (T + V::kElems - 1) / V::kElems;  // 16-byte packs a row

  const Raw pad = pad_raw<M>(true);
  for (int e = tid; e < (int)(q_bytes / sizeof(Raw)); e += kThreads)
    qs[e] = e < T ? q[(size_t)b * T + e] : pad;
  for (int c = tid; c < K; c += kThreads) { ls[c] = -INFINITY; li[c] = kBigId; }
  if (tid == 0) { *ts = -INFINITY; *ti = kBigId; *cnt = 0; }
  __syncthreads();

  const int* ids = row_ids + (size_t)b * R;
  for (int round = 0; round < n_rounds; ++round) {
    const int r = row0 + round * kRowRound + warp * 32 + lane;
    const int my_id = r < row1 ? ids[r] : kBigId;
    const bool my_ok = static_cast<unsigned>(my_id) < static_cast<unsigned>(n_docs);
    float my_s = -INFINITY;
#pragma unroll 1
    for (int u0 = 0; u0 < 32; u0 += kK3Rows) {
      const Raw* rows[kK3Rows];
      bool ok[kK3Rows];
      Acc acc[kK3Rows];
#pragma unroll
      for (int u = 0; u < kK3Rows; ++u) {
        const int id = __shfl_sync(kFull, my_id, u0 + u);
        ok[u] = static_cast<unsigned>(id) < static_cast<unsigned>(n_docs);
        rows[u] = store + (size_t)(ok[u] ? id : 0) * T;  // an id out of range is never read
        acc[u] = Acc(0);
      }
      for (int p0 = 0; p0 < n_packs; p0 += 32 * kK3Rounds) {  // one load group
        uint4 dv[kK3Rows][kK3Rounds];
#pragma unroll
        for (int j = 0; j < kK3Rounds; ++j) {
          const int p = p0 + 32 * j + lane;
#pragma unroll
          for (int u = 0; u < kK3Rows; ++u)
            dv[u][j] = ok[u] && p < n_packs
                           ? load_pack<M>(rows[u], true, p * V::kElems, T, align, false)
                           : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int j = 0; j < kK3Rounds; ++j) {
          const uint4 qv = *reinterpret_cast<const uint4*>(qs + (p0 + 32 * j + lane) * V::kElems);
#pragma unroll
          for (int u = 0; u < kK3Rows; ++u) acc[u] = dot_pack<M>(acc[u], qv, dv[u][j]);
        }
      }
      const Acc v = __shfl_sync(kFull, warp_sum4(acc, lane), (lane & 3) << 3);
      if ((lane >> 2) == u0 / kK3Rows) my_s = static_cast<float>(v);
    }
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
    // The block's buffer merges once it holds more than kRowFlushAt (or after
    // the last round); until then it has room for the next round.
    const bool last = round + 1 == n_rounds;
    if (!__syncthreads_or(full) && !last) continue;
    const int n = *cnt;
    if (n > 0) {  // block-uniform
      merge_buffer<kRowCap, kThreads, true>(ls, li, K, depth, cs, ci, n, tid);
      __syncthreads();
      if (tid == 0) { *ts = ls[depth - 1]; *ti = li[depth - 1]; *cnt = 0; }
    }
    __syncthreads();
  }

  const size_t out = ((size_t)split * B + b) * K;
  for (int c = tid; c < K; c += kThreads) {
    part_s[out + c] = ls[c];
    part_i[out + c] = li[c];
  }
}

template <int M>
cudaError_t launch_gathered(const void* q, const void* store, const int* row_ids, int B, int R,
                            int n_docs, int T, int depth, int K, int splits, int rows_per_split,
                            int align, float* part_s, int* part_i, cudaStream_t stream) {
  using Raw = typename Traits<M>::Raw;
  const size_t smem = row_block_smem(gathered_query_bytes(T, sizeof(Raw)), K);
  auto kernel = fused_topk_gathered_partial<M>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, splits), kThreads, smem, stream>>>(
      static_cast<const Raw*>(q), static_cast<const Raw*>(store), row_ids, B, R, n_docs, T,
      depth, K, rows_per_split, align, part_s, part_i);
  return cudaGetLastError();
}

int elem_size(int mode) { return mode == kBF16 ? 2 : (mode == kI8 ? 1 : 4); }

}  // namespace

extern "C" {

// K1's launch plan in `mode` (0 f32, 1 bf16, 2 int8, 3 lsh): mma_plan for
// f32, bf16 and int8 (the tensor-core pass 1), lsh_plan for lsh (K2).
int fused_topk_plan(int mode, int B, int n_docs, int depth, int sm_count, int* plan) {
  if (mode < kF32 || mode > kLSH) return (int)cudaErrorInvalidValue;
  if (mode != kLSH) return mma_plan(B, n_docs, depth, sm_count, kStages, plan);
  return lsh_plan(B, n_docs, depth, sm_count, plan);
}

// Both passes on `stream`, with the plan of fused_topk_plan in the same
// mode; returns the first cudaError_t (0 = launched).  mode: 0 f32, 1 bf16, 2 int8, 3 lsh.
// aligned: bit 0 set if every q row starts 16-byte aligned, bit 1 the same
// for docs; bit 2 if every q row starts 8-byte but not 16-byte aligned, bit
// 3 the same for docs.
int fused_topk_launch(int mode, int bq, const void* q, const void* docs, const void* filt,
                      long long filt_stride, int B, int n_docs, int T, int depth, int K,
                      int splits, int tiles_per_split, int aligned, void* part_s,
                      void* part_i, void* out_s, void* out_i, void* stream) {
  if (K % 32 != 0 || depth > K || B <= 0 || n_docs <= 0 || T <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(filt);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  cudaError_t err;
  switch (mode) {
    case kF32:
      err = launch_f32(bq, q, docs, f, filt_stride, B, n_docs, T, depth, K, splits,
                       tiles_per_split, aligned, ps, pi, st);
      break;
    case kBF16:
      err = launch_bf16(bq, q, docs, f, filt_stride, B, n_docs, T, depth, K, splits,
                        tiles_per_split, aligned, ps, pi, st);
      break;
    case kI8:
      err = launch_int8(bq, q, docs, f, filt_stride, B, n_docs, T, depth, K, splits,
                        tiles_per_split, aligned & 1 ? 16 : (aligned & 4 ? 8 : 1),
                        aligned & 2 ? 16 : (aligned & 8 ? 8 : 1), ps, pi, st);
      break;
    case kLSH:
      err = launch_lsh(bq, q, docs, f, filt_stride, B, n_docs, T, depth, K, splits,
                       tiles_per_split, aligned, ps, pi, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(ps, pi, splits, B, K, depth, out_s, out_i, st);
}

// K3's launch plan for R gathered rows of T elements in `mode`:
// gathered_row_plan (topk_merge.cuh) with the query row's shared memory.
int fused_topk_gathered_plan(int mode, int B, int R, int T, int depth, int sm_count, int* plan) {
  if (mode < kF32 || mode > kLSH || T <= 0) return (int)cudaErrorInvalidValue;
  return gathered_row_plan(B, R, depth, gathered_query_bytes(T, elem_size(mode)), sm_count, plan);
}

// Both passes of fused_topk_gathered on `stream`, with the plan of
// fused_topk_gathered_plan; returns the first cudaError_t (0 = launched).
// mode: 0 f32, 1 bf16, 2 int8, 3 lsh.  align: the byte alignment every
// stored row starts at (16, 8, or less).
int fused_topk_gathered_launch(int mode, const void* q, const void* store, const void* row_ids,
                               int B, int R, int n_docs, int T, int depth, int K, int splits,
                               int rows_per_split, int align, void* part_s, void* part_i,
                               void* out_s, void* out_i, void* stream) {
  if (K % 32 != 0 || depth > K || depth > R || B <= 0 || R <= 0 || n_docs <= 0 || T <= 0 ||
      splits <= 0 || rows_per_split % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* rid = static_cast<const int*>(row_ids);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  cudaError_t err;
  switch (mode) {
    case kF32:
      err = launch_gathered<kF32>(q, store, rid, B, R, n_docs, T, depth, K, splits,
                                  rows_per_split, align, ps, pi, st);
      break;
    case kBF16:
      err = launch_gathered<kBF16>(q, store, rid, B, R, n_docs, T, depth, K, splits,
                                   rows_per_split, align, ps, pi, st);
      break;
    case kI8:
      err = launch_gathered<kI8>(q, store, rid, B, R, n_docs, T, depth, K, splits,
                                 rows_per_split, align, ps, pi, st);
      break;
    case kLSH:
      err = launch_gathered<kLSH>(q, store, rid, B, R, n_docs, T, depth, K, splits,
                                  rows_per_split, align, ps, pi, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(ps, pi, splits, B, K, depth, out_s, out_i, st);
}

const char* fused_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
