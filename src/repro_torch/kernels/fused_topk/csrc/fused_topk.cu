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
// -1.  The tile shape of the CUDA-core pass 1, its launch plan, the sorted
// insert, the list merge and pass 2 live in topk_merge.cuh, shared with
// fused_topk_quantized.cu.
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
// lsh: fused_topk_partial, on CUDA cores.  A block of 256 threads owns BQ
// queries and a contiguous range of 256-doc tiles, walks (tile, 32-word
// reduce chunk) steps with the next step's loads in flight, and keeps the
// score tile in registers (each warp BQ/8 query rows, each lane 8 doc
// columns) as equality counts.  After a tile's last chunk the warp merges
// its rows into the running lists: lanes whose candidate beats the list's
// K-th entry raise a ballot, and the warp inserts them one at a time
// (warp_insert).
//
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

namespace {

// The score modes (Mode, Traits, Vec, load_pack, store_pack, mac) are in
// score_operands.cuh, shared with the dense score kernels K6 and K8.  Pass 1
// reads its rows with 16-byte loads or element by element (load_pack<M,
// false>): with the 8-byte branch compiled in, its instances spilled more
// at the 128-register cap and ran 1-2% slower on an H100.

// Two blocks per SM: ptxas caps a thread at 128 registers.
template <int M, int BQ>
__global__ void __launch_bounds__(kThreads, 2) fused_topk_partial(
    const typename Traits<M>::Raw* __restrict__ q,     // (B, T)
    const typename Traits<M>::Raw* __restrict__ docs,  // (N, T), rows >= n_docs unread
    const uint8_t* __restrict__ filt,                   // nullptr | (N,) | (B, N)
    long long filt_stride,                              // 0 for (N,), N for (B, N)
    int B, int n_docs, int T, int K, int tiles_per_split,
    bool q_aligned, bool d_aligned,                     // rows 16-byte aligned
    float* __restrict__ part_s, int* __restrict__ part_i) {  // (splits, B, K)
  using Tr = Traits<M>;
  using V = Vec<M>;
  using Word = typename Tr::Word;
  using Acc = typename Tr::Acc;
  constexpr int TM = BQ / kWarps;  // query rows per warp
  constexpr int kDLoads = kBN * V::kPerRow / kThreads;
  constexpr int kQPacks = BQ * V::kPerRow;
  constexpr int kQLoads = (kQPacks + kThreads - 1) / kThreads;
  static_assert(kDLoads * kThreads == kBN * V::kPerRow, "doc chunk must split evenly");

  extern __shared__ __align__(16) unsigned char smem[];
  Word* qs = reinterpret_cast<Word*>(smem);                // kBK x BQ, k-major
  Word* ds = qs + kBK * BQ;                                 // kBN x kSkew, row-major
  float* ls = reinterpret_cast<float*>(ds + kBN * kSkew);   // BQ x K running scores
  int* li = reinterpret_cast<int*>(ls + BQ * K);            // BQ x K running ids

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ, split = blockIdx.y;
  const int n_chunks = ((T + Tr::kPerWord - 1) / Tr::kPerWord + kBK - 1) / kBK;
  const int n_tiles = (n_docs + kBN - 1) / kBN;
  const int tile_begin = split * tiles_per_split;
  const int n_steps = max(0, min(tile_begin + tiles_per_split, n_tiles) - tile_begin) * n_chunks;

  for (int e = tid; e < BQ * K; e += kThreads) { ls[e] = -INFINITY; li[e] = kBigId; }

  uint4 dst[kDLoads], qst[kQLoads];
  auto load_step = [&](int step) {
    const int d0 = (tile_begin + step / n_chunks) * kBN;
    const int w0 = (step % n_chunks) * kBK;
#pragma unroll
    for (int i = 0; i < kDLoads; ++i) {
      const int v = tid + i * kThreads, r = v / V::kPerRow, c = v % V::kPerRow;
      const int di = d0 + r;
      dst[i] = load_pack<M, false>(docs + (size_t)di * T, di < n_docs,
                                   (w0 + c * V::kWords) * Tr::kPerWord, T, d_aligned ? 16 : 1,
                                   false);
    }
#pragma unroll
    for (int i = 0; i < kQLoads; ++i) {
      const int v = tid + i * kThreads, r = v % BQ, c = v / BQ;
      const int qi = q0 + r;
      if (v < kQPacks)
        qst[i] = load_pack<M, false>(q + (size_t)qi * T, qi < B,
                                     (w0 + c * V::kWords) * Tr::kPerWord, T, q_aligned ? 16 : 1,
                                     true);
    }
  };

  Acc acc[TM][kTN];
  if (n_steps > 0) load_step(0);
  for (int step = 0; step < n_steps; ++step) {
    const int chunk = step % n_chunks;
    const int d0 = (tile_begin + step / n_chunks) * kBN;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = Acc(0);
    }
    __syncthreads();  // every warp is done with the previous chunk
#pragma unroll
    for (int i = 0; i < kDLoads; ++i) {
      const int v = tid + i * kThreads, r = v / V::kPerRow, c = v % V::kPerRow;
      store_pack<M>(ds + r * kSkew + c * V::kWords, 1, dst[i]);
    }
#pragma unroll
    for (int i = 0; i < kQLoads; ++i) {
      const int v = tid + i * kThreads, r = v % BQ, c = v / BQ;
      if (v < kQPacks) store_pack<M>(qs + c * V::kWords * BQ + r, BQ, qst[i]);
    }
    __syncthreads();
    if (step + 1 < n_steps) load_step(step + 1);  // in flight during the products

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      Word a[TM], b[kTN];
      if constexpr (TM % 4 == 0) {  // one broadcast 16-byte read per 4 rows
#pragma unroll
        for (int g = 0; g < TM / 4; ++g) {
          const uint4 av = *reinterpret_cast<const uint4*>(qs + kk * BQ + warp * TM + 4 * g);
          a[4 * g + 0] = from_bits<M>(av.x);
          a[4 * g + 1] = from_bits<M>(av.y);
          a[4 * g + 2] = from_bits<M>(av.z);
          a[4 * g + 3] = from_bits<M>(av.w);
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = qs[kk * BQ + warp * TM + i];
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ds[(lane + 32 * j) * kSkew + kk];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = mac<M>(acc[i][j], a[i], b[j]);
    }

    if (chunk != n_chunks - 1) continue;
    // Merge this warp's rows of the finished tile into their running lists.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = warp * TM + i, qi = q0 + r;
      if (qi >= B) continue;  // warp-uniform
      float* rs = ls + r * K;
      int* ri = li + r * K;
      const uint8_t* f = filt ? filt + qi * filt_stride : nullptr;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int id = d0 + 32 * j + lane;
        const float s = static_cast<float>(acc[i][j]);
        const bool valid = id < n_docs && (f == nullptr || f[id] != 0);
        unsigned mask = __ballot_sync(kFull, valid && precedes(s, id, rs[K - 1], ri[K - 1]));
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float cs = __shfl_sync(kFull, s, src);
          const int cid = d0 + 32 * j + src;
          if (precedes(cs, cid, rs[K - 1], ri[K - 1])) warp_insert(rs, ri, K, cs, cid, lane);
        }
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = warp * TM + i, qi = q0 + r;
    if (qi >= B) continue;
    const size_t out = ((size_t)split * B + qi) * K;
    for (int c = lane; c < K; c += 32) {
      part_s[out + c] = ls[r * K + c];
      part_i[out + c] = li[r * K + c];
    }
  }
}

template <int M, int BQ>
cudaError_t launch_partial(const void* q, const void* docs, const uint8_t* filt,
                           long long filt_stride, int B, int n_docs, int T, int K,
                           int splits, int tiles_per_split, int aligned, float* part_s,
                           int* part_i, cudaStream_t stream) {
  using Raw = typename Traits<M>::Raw;
  static_assert(sizeof(typename Traits<M>::Word) == 4, "partial_smem counts 4-byte words");
  const size_t smem = partial_smem(BQ, K);
  auto kernel = fused_topk_partial<M, BQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BQ - 1) / BQ, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Raw*>(q), static_cast<const Raw*>(docs), filt, filt_stride, B, n_docs,
      T, K, tiles_per_split, (aligned & 1) != 0, (aligned & 2) != 0, part_s, part_i);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_partial_bq(int bq, const void* q, const void* docs, const uint8_t* filt,
                              long long filt_stride, int B, int n_docs, int T, int K,
                              int splits, int tiles_per_split, int aligned, float* part_s,
                              int* part_i, cudaStream_t stream) {
  if (bq == 32)
    return launch_partial<M, 32>(q, docs, filt, filt_stride, B, n_docs, T, K, splits,
                                 tiles_per_split, aligned, part_s, part_i, stream);
  if (bq == 8)
    return launch_partial<M, 8>(q, docs, filt, filt_stride, B, n_docs, T, K, splits,
                                tiles_per_split, aligned, part_s, part_i, stream);
  return cudaErrorInvalidValue;
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
// f32, bf16 and int8 (the tensor-core pass 1), else streaming_plan
// (topk_merge.cuh) with plan[4] = kBN docs a tile.
int fused_topk_plan(int mode, int B, int n_docs, int depth, int sm_count, int* plan) {
  if (mode < kF32 || mode > kLSH) return (int)cudaErrorInvalidValue;
  if (mode != kLSH) return mma_plan(B, n_docs, depth, sm_count, kStages, plan);
  plan[4] = kBN;
  return streaming_plan(B, n_docs, depth, sm_count, plan);
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
      err = launch_partial_bq<kLSH>(bq, q, docs, f, filt_stride, B, n_docs, T, K, splits,
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
