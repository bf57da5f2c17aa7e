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
//   * dot (int8): 1.8 GB of tf -> ~0.54 ms.
//   * f32 ground truth (T = 300): 3.6 GB, but 4.6e11 FLOP on fp32 CUDA cores
//     (67 TFLOP/s) -> ~6.9 ms: operations bound it.
//
// Pass 1 runs a grid of (query tiles x N-splits): a block owns a tile of
// queries and a contiguous range of doc tiles, and keeps a sorted running
// top-K list per query (K = depth rounded up to 32) in shared memory under
// (score desc, id asc), so ties keep the lowest id in any arrival order.
// Blocks of one split are adjacent in launch order, so the re-reads of a
// doc tile by the split's query tiles mostly hit L2.  Pass 2
// (fused_topk_merge): one warp per query merges the splits' sorted lists
// under the same comparator and writes the first `depth` entries, -inf
// slots as id -1.  The tile shape of the CUDA-core pass 1, both launch
// plans of it, the sorted insert, the list merge and pass 2 live in
// topk_merge.cuh, shared with fused_topk_quantized.cu.
//
// classic (bf16): fused_topk_bf16_partial, on tensor cores.
//   * Products: doc and query chunks of 64 bf16 are staged in shared memory
//     as bf16 (row stride 72 elements = 144 bytes, so the eight rows an
//     ldmatrix phase reads fall on distinct banks) and multiplied by
//     mma.sync m16n8k16 (bf16 x bf16 -> f32).  Docs are the M side (16-row
//     fragments of doc rows), queries the N side (8-column fragments of
//     query rows), so one kernel serves every B: the plan takes 64-query
//     tiles above B = 8 (128 docs a tile, 8 warps as 4 x 2, each 32 docs x
//     32 queries) and 8-query tiles up to it (256 docs a tile, each warp 32
//     docs x 8 queries; at B = 1 7/8 of each mma is idle, and the bytes
//     bound the call anyway).  bf16 products are
//     exact in f32; only the order of the f32 sums differs from the plain
//     version.
//   * Loads: where every q and doc row is 16-byte aligned, a ring of three
//     stages filled by cp.async (two chunks in flight; a pack past T or a
//     row >= n_docs / >= B is zero-filled and not read).  Other rows go
//     through registers one chunk ahead (16-byte or element loads, zero
//     padding), into two stages.
//   * Running top-k: after a tile's last chunk every thread tests its
//     accumulators against its query's depth-th entry with the full
//     comparator and appends those that pass to the query's candidate
//     buffer (a shared-memory atomicAdd on the query's count).  A buffer is
//     merged only once it holds more than BN / 4 candidates, or after the
//     block's last tile; until then a stale threshold only lets more in,
//     and the buffer (BN + BN / 4 entries) has room for the next tile.  Far
//     into a split a query gains a few candidates a tile, so most tiles
//     merge nothing and cost one barrier.  The merge (one warp per query)
//     does not sort: each entry's new slot is the number of entries of both
//     lists that precede it (list entries: index + candidates before it, in
//     one sweep over the candidates; candidates: that sweep + a binary
//     search in the list; ids are unique within a split, so no two entries
//     share a slot); then the warp refreshes the threshold.  Lists wider
//     than kRegMergeK (up to depth 3,136, at 8-query tiles with one
//     register-staged stage) take one warp_insert per candidate that still
//     ranks instead.  Depth 100 never does.  The list's entries past depth
//     may go stale (a candidate below the depth-th entry is dropped), but
//     its first depth entries are the split's exact top-depth, and pass 2
//     keeps only the first depth of the merged lists.
//   * Shared memory at the cell (64 queries, K = 128, three stages): 82,944 B
//     of stages, 65,536 of lists, 81,920 of candidate buffers and 768 of
//     thresholds and counts = 231,168 B, one block per SM; the plan
//     (bf16_plan) sizes the splits so that query tiles x splits cover the
//     resident blocks of all SMs (132 blocks at B = 256 and at B = 1).
//   * What holds it back (on an H100, `chip_smoke.py --ablate-k1` times
//     copies of this kernel with parts cut out; numbers in PERF.md): at
//     B = 256 the loads from L2 (4 query tiles re-read the store, and each
//     re-stages its 64 query rows with every doc tile) take about half, the
//     running top-k over a third; at B = 1 the loads run at about 2.4 TB/s.  mma.sync is the warp-level
//     instruction (wgmma, the warpgroup one, reaches the full tensor-core
//     rate), and the ring is cp.async, not TMA.  A later PR would keep the
//     query tile resident, feed wgmma from a TMA ring, and share a doc tile
//     between the query tiles of a cluster (TMA multicast).
//
// f32, int8 (dot) and lsh: fused_topk_partial, on CUDA cores.  A block of
// 256 threads owns BQ queries and a contiguous range of 256-doc tiles, walks
// (tile, 32-word reduce chunk) steps with the next step's loads in flight,
// and keeps the score tile in registers (each warp BQ/8 query rows, each
// lane 8 doc columns); int8 uses __dp4a, lsh an equality count.  After a
// tile's last chunk the warp merges its rows into the running lists: lanes
// whose candidate beats the list's K-th entry raise a ballot, and the warp
// inserts them one at a time (warp_insert).  So f32 at best reaches its
// operation bound and dot runs at CUDA-core rate.
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
// Bound: a batched GEMV with no reuse across queries (each has its own
// rows), so bytes bound it: B * R * (T * elem + 4).  At B = 8 that is
// 2.88 GB, 0.86 ms at 3.35 TB/s; at B = 1, 0.107 ms.
//
// Design: grid (B, row splits), one query per block, splits chosen so that
// B x splits fills the SMs at B = 1 (fused_topk_gathered_plan).  The query
// row sits in shared memory.  A warp scores 32 rows at a time, reading each
// row whole and contiguously (lane l loads 16-byte packs l, l + 32, ...;
// 8-byte or element loads where rows are not 16-byte aligned), with
// kGatherRows rows' loads in flight, and reduces each row across the warp.
// Ids arrive in any order, so the check against the K-th entry must let a
// tied score with a lower id in (the reference's strict=False): it uses the
// full (score desc, id asc) comparator, as K1's does.  Each warp keeps its
// own sorted list; warp 0 merges the block's eight lists, and the K1 merge
// pass merges the splits.  No tensor cores, no TMA, no sharing of a kept
// block between the queries that keep it.

#include "topk_merge.cuh"

namespace {

// The score modes (Mode, Traits, Vec, load_pack, store_pack, mac) are in
// score_operands.cuh, shared with the dense score kernels K6-K8.  Pass 1
// reads its rows with 16-byte loads or element by element (load_pack<M,
// false>): with the 8-byte branch compiled in, its f32 and lsh instances
// spilled more at the 128-register cap and ran 1-2% slower on an H100.

// Blocks per SM that ptxas budgets registers for: 2 caps a thread at 128
// registers.  The 32-query int8 instance runs faster with one block and no
// register cap (measured on an H100); f32, lsh and the 8-query instances run
// faster with two.
template <int M, int BQ>
constexpr int kMinBlocks = (BQ == 32 && M == kI8) ? 1 : 2;

template <int M, int BQ>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<M, BQ>)) fused_topk_partial(
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
// K1 classic (bf16) pass 1 on tensor cores (fused_topk_bf16_partial).
// ---------------------------------------------------------------------------

constexpr int kMmaBK = 64;                  // bf16 per reduce chunk: 4 mma k-steps
constexpr int kMmaStride = kMmaBK + 8;      // staged row stride in bf16 (144 bytes)
constexpr int kMmaPacks = kMmaBK / 8;       // 16-byte packs per staged row and chunk
constexpr int kRegMergeK = 256;             // widest running list merged by counting
constexpr int kStages = 3;                  // cp.async ring: two chunks in flight
constexpr size_t kSmemPerSm = 228 * 1024;   // shared memory of an SM
constexpr size_t kSmemPerBlock = 1024;      // what the card reserves per resident block

// A query's candidates wait in its buffer until more than bn / 4 have
// gathered (or the block's last tile is done); the buffer holds that many
// plus one tile's worth.
__host__ __device__ constexpr int flush_at(int bn) { return bn / 4; }
__host__ __device__ constexpr int cand_cap(int bn) { return bn + flush_at(bn); }

// Dynamic shared memory of a bf16 pass-1 block of bq queries and bn-doc
// tiles with `stages` staged chunks: the stages (bn doc rows, then bq query
// rows, each kMmaStride bf16), bq running lists of K (score, id) pairs, bq
// candidate buffers of cand_cap(bn) pairs, and each query's threshold and
// count.
constexpr size_t bf16_smem(int bq, int bn, int stages, int K) {
  return (size_t)stages * (bn + bq) * kMmaStride * 2 + (size_t)bq * K * 8 +
         (size_t)bq * cand_cap(bn) * 8 + (size_t)bq * 12;
}

// The doc tile and stage count of the bf16 instance for bq queries (64 or
// 8) at list width K: 128 docs at 64 queries, 256 at 8, with kStages
// stages (the register-staged instance for rows that are not 16-byte
// aligned uses two of them); or, at 8 queries where the lists are too wide
// for that, 128 docs and one register-staged stage.  False if the instance
// does not fit in shared memory.
inline bool bf16_shape(int bq, int K, int* bn, int* stages) {
  if (bq != 64 && bq != 8) return false;
  *bn = bq == 8 ? 256 : 128;
  *stages = kStages;
  if (bq == 8 && bf16_smem(8, 256, kStages, K) > kMaxSmem) {
    *bn = 128;
    *stages = 1;
  }
  return bf16_smem(bq, *bn, *stages, K) <= kMaxSmem;
}

// The bf16 launch plan for B queries over n_docs rows at `depth` on
// sm_count SMs: plan[0] queries per block (64 above 8 queries, else 8; 8
// where the lists do not fit at 64), plan[1] K (depth rounded up to 32),
// plan[2] N-splits, plan[3] doc tiles per split, plan[4] docs per tile, so
// that query tiles x splits cover every SM's resident blocks, at B = 256
// and at B = 1 alike.  Returns cudaErrorInvalidValue if no instance fits.
inline int bf16_plan(int B, int n_docs, int depth, int sm_count, int* plan) {
  if (B <= 0 || n_docs <= 0 || depth <= 0 || sm_count <= 0) return (int)cudaErrorInvalidValue;
  const int K = (depth + 31) / 32 * 32;
  int bq = B > 8 ? 64 : 8, bn = 0, stages = 0;
  if (!bf16_shape(bq, K, &bn, &stages)) bq = 8;
  if (!bf16_shape(bq, K, &bn, &stages)) return (int)cudaErrorInvalidValue;
  const size_t per_block = bf16_smem(bq, bn, stages, K) + kSmemPerBlock;
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Two 8x8 bf16 matrices; lanes 0-15 give the addresses.
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from device to shared memory, asynchronously; src_bytes = 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's newest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// How many of the sorted entries (ls, li)[0, n) come before (s, id).
__device__ __forceinline__ int rank_in(const float* ls, const int* li, int n, float s, int id) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (precedes(ls[mid], li[mid], s, id)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Merge the n unsorted candidates (cs, ci) (n <= 32 kCandPer) into the
// sorted running list (rs, ri) of K <= 32 kPer entries in one pass,
// without sorting them: an entry's new slot is the number of entries of
// both lists that come before it.  For a list entry that is its index plus
// the candidates before it, counted in one sweep over the candidates; for
// a candidate, the candidates before it (the same sweep) plus its rank in
// the list (binary search).  Slots >= K drop.  No two entries share a slot,
// as no two share an id.  All 32 lanes take part; each holds its entries
// in registers until every slot is known.
template <int kCandPer, int kPer>
__device__ __forceinline__ void merge_counted(float* rs, int* ri, int K, const float* cs,
                                              const int* ci, int n, int lane) {
  float ls_[kPer], cs_[kCandPer];
  int li_[kPer], ci_[kCandPer], lslot[kPer], cslot[kCandPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int c = lane + 32 * u;
    lslot[u] = c < K ? c : K;
    ls_[u] = c < K ? rs[c] : -INFINITY;
    li_[u] = c < K ? ri[c] : kBigId;
  }
#pragma unroll
  for (int u = 0; u < kCandPer; ++u) {
    const int c = lane + 32 * u;
    cs_[u] = c < n ? cs[c] : -INFINITY;
    ci_[u] = c < n ? ci[c] : kBigId;
    cslot[u] = c < n ? rank_in(rs, ri, K, cs_[u], ci_[u]) : K;
  }
  for (int j = 0; j < n; ++j) {
    const float s = cs[j];
    const int id = ci[j];
#pragma unroll
    for (int u = 0; u < kPer; ++u) lslot[u] += precedes(s, id, ls_[u], li_[u]) ? 1 : 0;
#pragma unroll
    for (int u = 0; u < kCandPer; ++u) cslot[u] += precedes(s, id, cs_[u], ci_[u]) ? 1 : 0;
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (lane + 32 * u < K && lslot[u] < K) { rs[lslot[u]] = ls_[u]; ri[lslot[u]] = li_[u]; }
#pragma unroll
  for (int u = 0; u < kCandPer; ++u)
    if (lane + 32 * u < n && cslot[u] < K) { rs[cslot[u]] = cs_[u]; ri[cslot[u]] = ci_[u]; }
  __syncwarp();
}

// Grid (query tiles of BQ, splits): block (x, split) owns queries
// [x * BQ, x * BQ + BQ) and doc tiles [split * tiles_per_split, ...) of BN
// docs.  8 warps as kWarpsM (docs) x kWarpsN (queries); a warp owns WM
// 16-doc by WN 8-query mma tiles, accumulated in registers over the tile's
// chunks of kMmaBK columns, staged in NS shared-memory stages: a cp.async
// ring (ASYNC, every row 16-byte aligned, so a 16-byte pack lies wholly
// inside or wholly past its row) or, for other rows, loads through
// registers one chunk ahead.
template <int BQ, int BN, int NS, bool ASYNC>
__global__ void __launch_bounds__(kThreads, 1) fused_topk_bf16_partial(
    const uint16_t* __restrict__ q,     // (B, T) bf16 bits
    const uint16_t* __restrict__ docs,  // (N, T) bf16 bits, rows >= n_docs unread
    const uint8_t* __restrict__ filt,   // nullptr | (N,) | (B, N)
    long long filt_stride,              // 0 for (N,), N for (B, N)
    int B, int n_docs, int T, int depth, int K, int tiles_per_split,
    bool q_aligned, bool d_aligned,     // rows 16-byte aligned
    float* __restrict__ part_s, int* __restrict__ part_i) {  // (splits, B, K)
  constexpr int kWarpsN = BQ >= 32 ? BQ / 32 : 1;
  constexpr int kWarpsM = kWarps / kWarpsN;
  constexpr int WN = BQ / (8 * kWarpsN);   // 8-query mma columns per warp
  constexpr int WM = BN / (16 * kWarpsM);  // 16-doc mma rows per warp
  static_assert(kWarpsM * WM * 16 == BN && kWarpsN * WN * 8 == BQ, "warps must tile the block");
  static_assert(WN == 1 || WN % 2 == 0, "query fragments load in pairs");
  static_assert(ASYNC ? NS >= 2 : NS <= 2, "a ring of stages, or at most two through registers");
  constexpr int kCap = cand_cap(BN), kFlushAt = flush_at(BN);
  static_assert(kCap % 32 == 0, "candidate buffers fill whole lanes");
  constexpr int kDLoads = BN * kMmaPacks / kThreads;
  constexpr int kQPacks = BQ * kMmaPacks;
  constexpr int kQLoads = (kQPacks + kThreads - 1) / kThreads;
  static_assert(kDLoads * kThreads == BN * kMmaPacks, "doc chunk must split evenly");

  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* stages = reinterpret_cast<uint16_t*>(smem);  // NS x (BN + BQ) rows
  float* ls = reinterpret_cast<float*>(stages + NS * (BN + BQ) * kMmaStride);  // BQ x K
  int* li = reinterpret_cast<int*>(ls + BQ * K);
  float* cs = reinterpret_cast<float*>(li + BQ * K);  // BQ x kCap candidates
  int* ci = reinterpret_cast<int*>(cs + BQ * kCap);
  float* ts = reinterpret_cast<float*>(ci + BQ * kCap);  // each list's depth-th entry
  int* ti = reinterpret_cast<int*>(ts + BQ);
  int* cnt = ti + BQ;                                  // candidates per query

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp % kWarpsM) * WM * 16, wn0 = (warp / kWarpsM) * WN * 8;
  const int q0 = blockIdx.x * BQ, split = blockIdx.y;
  const int n_chunks = (T + kMmaBK - 1) / kMmaBK;
  const int n_tiles = (n_docs + BN - 1) / BN;
  const int tile_begin = split * tiles_per_split;
  const int n_steps = max(0, min(tile_begin + tiles_per_split, n_tiles) - tile_begin) * n_chunks;

  for (int e = tid; e < BQ * K; e += kThreads) { ls[e] = -INFINITY; li[e] = kBigId; }
  for (int r = tid; r < BQ; r += kThreads) { ts[r] = -INFINITY; ti[r] = kBigId; cnt[r] = 0; }

  uint4 dst[kDLoads], qst[kQLoads];
  auto load_step = [&](int step) {
    const int d0 = (tile_begin + step / n_chunks) * BN;
    const int e0 = (step % n_chunks) * kMmaBK;
#pragma unroll
    for (int i = 0; i < kDLoads; ++i) {
      const int v = tid + i * kThreads, di = d0 + v / kMmaPacks;
      dst[i] = load_pack<kBF16, false>(docs + (size_t)di * T, di < n_docs,
                                        e0 + (v % kMmaPacks) * 8, T, d_aligned ? 16 : 1, false);
    }
#pragma unroll
    for (int i = 0; i < kQLoads; ++i) {
      const int v = tid + i * kThreads, qi = q0 + v / kMmaPacks;
      if (v < kQPacks)
        qst[i] = load_pack<kBF16, false>(q + (size_t)qi * T, qi < B, e0 + (v % kMmaPacks) * 8, T,
                                          q_aligned ? 16 : 1, true);
    }
  };

  auto copy_step = [&](int step) {  // chunk `step` into its stage of the ring
    uint16_t* ds = stages + (step % NS) * (BN + BQ) * kMmaStride;
    uint16_t* qs = ds + BN * kMmaStride;
    const int d0 = (tile_begin + step / n_chunks) * BN;
    const int e0 = (step % n_chunks) * kMmaBK;
#pragma unroll
    for (int i = 0; i < kDLoads; ++i) {
      const int v = tid + i * kThreads, di = d0 + v / kMmaPacks, e = e0 + (v % kMmaPacks) * 8;
      const bool ok = di < n_docs && e < T;
      cp_async16(ds + (v / kMmaPacks) * kMmaStride + (v % kMmaPacks) * 8,
                 docs + (ok ? (size_t)di * T + e : 0), ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < kQLoads; ++i) {
      const int v = tid + i * kThreads, qi = q0 + v / kMmaPacks, e = e0 + (v % kMmaPacks) * 8;
      const bool ok = qi < B && e < T;
      if (v < kQPacks)
        cp_async16(qs + (v / kMmaPacks) * kMmaStride + (v % kMmaPacks) * 8,
                   q + (ok ? (size_t)qi * T + e : 0), ok ? 16 : 0);
    }
  };

  float acc[WM][WN][4];
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
    uint16_t* ds = stages + (step % NS) * (BN + BQ) * kMmaStride;
    uint16_t* qs = ds + BN * kMmaStride;
    if (chunk == 0) {
#pragma unroll
      for (int mi = 0; mi < WM; ++mi)
#pragma unroll
        for (int ni = 0; ni < WN; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
    if constexpr (ASYNC) {
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
            dst[i];
      }
#pragma unroll
      for (int i = 0; i < kQLoads; ++i) {
        const int v = tid + i * kThreads;
        if (v < kQPacks)
          *reinterpret_cast<uint4*>(qs + (v / kMmaPacks) * kMmaStride + (v % kMmaPacks) * 8) =
              qst[i];
      }
      __syncthreads();
      if (step + 1 < n_steps) load_step(step + 1);  // in flight during the products
    }

#pragma unroll
    for (int ks = 0; ks < kMmaBK / 16; ++ks) {
      unsigned a[WM][4], b[WN][2];
#pragma unroll
      for (int mi = 0; mi < WM; ++mi)
        ldmatrix_x4(a[mi], smem_addr(ds + (wm0 + mi * 16 + (lane & 15)) * kMmaStride + ks * 16 +
                                     (lane >> 4) * 8));
      if constexpr (WN == 1) {
        ldmatrix_x2(b[0], smem_addr(qs + (wn0 + (lane & 7)) * kMmaStride + ks * 16 +
                                    ((lane >> 3) & 1) * 8));
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
      for (int mi = 0; mi < WM; ++mi)
#pragma unroll
        for (int ni = 0; ni < WN; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }

    if (chunk != n_chunks - 1) continue;
    // The tile is done.  acc[mi][ni][2 g + h] is the score of doc
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
            const float s = acc[mi][ni][2 * g + h];
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
      const float* rcs = cs + r * kCap;
      const int* rci = ci + r * kCap;
      if (K <= 128) {
        merge_counted<kCap / 32, 4>(rs, ri, K, rcs, rci, n, lane);
      } else if (K <= kRegMergeK) {
        merge_counted<kCap / 32, kRegMergeK / 32>(rs, ri, K, rcs, rci, n, lane);
      } else {  // wide lists: one sorted insert per candidate that still ranks
        for (int j = 0; j < n; ++j)
          if (precedes(rcs[j], rci[j], rs[depth - 1], ri[depth - 1]))
            warp_insert(rs, ri, K, rcs[j], rci[j], lane);
      }
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

template <int BQ, int BN, int NS, bool ASYNC>
cudaError_t launch_bf16_instance(const void* q, const void* docs, const uint8_t* filt,
                                 long long filt_stride, int B, int n_docs, int T, int depth,
                                 int K, int splits, int tiles_per_split, int aligned,
                                 float* part_s, int* part_i, cudaStream_t stream) {
  const size_t smem = bf16_smem(BQ, BN, NS, K);
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
// (bq, K) as in bf16_plan, the loader from the rows' alignment.
cudaError_t launch_bf16(int bq, const void* q, const void* docs, const uint8_t* filt,
                        long long filt_stride, int B, int n_docs, int T, int depth, int K,
                        int splits, int tiles_per_split, int aligned, float* part_s,
                        int* part_i, cudaStream_t stream) {
  int bn = 0, stages = 0;
  if (!bf16_shape(bq, K, &bn, &stages)) return cudaErrorInvalidValue;
#define FUSED_TOPK_BF16(BQ, BN, NS, ASYNC)                                                   \
  return launch_bf16_instance<BQ, BN, NS, ASYNC>(q, docs, filt, filt_stride, B, n_docs, T,    \
                                                 depth, K, splits, tiles_per_split, aligned, \
                                                 part_s, part_i, stream)
  const bool async = aligned == 3;
  if (stages == 1) FUSED_TOPK_BF16(8, 128, 1, false);
  if (bq == 64) {
    if (async) FUSED_TOPK_BF16(64, 128, kStages, true);
    FUSED_TOPK_BF16(64, 128, 2, false);
  }
  if (async) FUSED_TOPK_BF16(8, 256, kStages, true);
  FUSED_TOPK_BF16(8, 256, 2, false);
#undef FUSED_TOPK_BF16
}

// ---------------------------------------------------------------------------
// K3: top-`depth` over per-query gathered rows (fused_topk_gathered_partial).
// ---------------------------------------------------------------------------

// Dynamic shared memory of a gathered pass-1 block: the query row, padded to
// whole 32-lane rounds of 16-byte packs, then one running list of K (score,
// id) pairs per warp.
__host__ __device__ constexpr size_t gathered_query_bytes(int t, int elem) {
  return (size_t)((t * elem + 511) / 512) * 512;
}
constexpr size_t gathered_smem(int t, int elem, int K) {
  return gathered_query_bytes(t, elem) + (size_t)kWarps * K * (sizeof(float) + sizeof(int));
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

// Grid (B, splits): block (b, split) owns rows [split * rows_per_split, ...)
// of query b's R gathered rows.  Each warp takes 32-row groups in turn; its
// lanes read a row together (lane l the packs l, l + 32, ...), kGatherRows
// rows at a time, reduce each row's sum across the warp, and lane r keeps row
// r's score.  The warp then merges its 32 candidates into its own running
// list; at the end warp 0 merges the other warps' lists into its own and
// writes the block's sorted list.  A row whose id is outside [0, n_docs) is
// never read and never ranks.
template <int M>
__global__ void __launch_bounds__(kThreads, 2) fused_topk_gathered_partial(
    const typename Traits<M>::Raw* __restrict__ q,      // (B, T)
    const typename Traits<M>::Raw* __restrict__ store,  // (N, T)
    const int* __restrict__ row_ids,                     // (B, R)
    int B, int R, int n_docs, int T, int K, int rows_per_split, int align,
    float* __restrict__ part_s, int* __restrict__ part_i) {  // (splits, B, K)
  using Tr = Traits<M>;
  using V = Vec<M>;
  using Raw = typename Tr::Raw;
  using Acc = typename Tr::Acc;

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t q_bytes = gathered_query_bytes(T, sizeof(Raw));
  Raw* qs = reinterpret_cast<Raw*>(smem);
  float* ls = reinterpret_cast<float*>(smem + q_bytes);  // kWarps x K running scores
  int* li = reinterpret_cast<int*>(ls + kWarps * K);      // kWarps x K running ids

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, split = blockIdx.y;
  const int row0 = split * rows_per_split;
  const int row1 = min(R, row0 + rows_per_split);
  const int n_groups = (max(0, row1 - row0) + 31) / 32;
  const int n_rounds = (T + 32 * V::kElems - 1) / (32 * V::kElems);

  const Raw pad = pad_raw<M>(true);
  for (int e = tid; e < (int)(q_bytes / sizeof(Raw)); e += kThreads)
    qs[e] = e < T ? q[(size_t)b * T + e] : pad;
  float* rs = ls + warp * K;
  int* ri = li + warp * K;
  for (int c = lane; c < K; c += 32) { rs[c] = -INFINITY; ri[c] = kBigId; }
  __syncthreads();

  const int* ids = row_ids + (size_t)b * R;
  for (int g = warp; g < n_groups; g += kWarps) {
    const int r = row0 + g * 32 + lane;
    const int my_id = r < row1 ? ids[r] : kBigId;
    const bool my_ok = static_cast<unsigned>(my_id) < static_cast<unsigned>(n_docs);
    float my_s = -INFINITY;
#pragma unroll 1
    for (int u0 = 0; u0 < 32; u0 += kGatherRows) {
      const Raw* rows[kGatherRows];
      bool ok[kGatherRows];
      Acc acc[kGatherRows];
#pragma unroll
      for (int u = 0; u < kGatherRows; ++u) {
        const int id = __shfl_sync(kFull, my_id, u0 + u);
        ok[u] = static_cast<unsigned>(id) < static_cast<unsigned>(n_docs);
        rows[u] = store + (size_t)(ok[u] ? id : 0) * T;  // an id out of range is never read
        acc[u] = Acc(0);
      }
      for (int j = 0; j < n_rounds; ++j) {
        const int e0 = (lane + 32 * j) * V::kElems;
        if (e0 >= T) break;
        const uint4 qv = *reinterpret_cast<const uint4*>(qs + e0);
        uint4 dv[kGatherRows];
#pragma unroll
        for (int u = 0; u < kGatherRows; ++u)
          dv[u] = ok[u] ? load_pack<M>(rows[u], true, e0, T, align, false)
                        : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int u = 0; u < kGatherRows; ++u) acc[u] = dot_pack<M>(acc[u], qv, dv[u]);
      }
#pragma unroll
      for (int u = 0; u < kGatherRows; ++u) {
        const Acc tot = warp_sum(acc[u]);
        if (lane == u0 + u) my_s = static_cast<float>(tot);
      }
    }
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

template <int M>
cudaError_t launch_gathered(const void* q, const void* store, const int* row_ids, int B, int R,
                            int n_docs, int T, int K, int splits, int rows_per_split, int align,
                            float* part_s, int* part_i, cudaStream_t stream) {
  using Raw = typename Traits<M>::Raw;
  const size_t smem = gathered_smem(T, sizeof(Raw), K);
  auto kernel = fused_topk_gathered_partial<M>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, splits), kThreads, smem, stream>>>(
      static_cast<const Raw*>(q), static_cast<const Raw*>(store), row_ids, B, R, n_docs, T, K,
      rows_per_split, align, part_s, part_i);
  return cudaGetLastError();
}

int elem_size(int mode) { return mode == kBF16 ? 2 : (mode == kI8 ? 1 : 4); }

}  // namespace

extern "C" {

// K1's launch plan in `mode` (0 f32, 1 bf16, 2 int8, 3 lsh): bf16_plan for
// bf16, else streaming_plan (topk_merge.cuh) with plan[4] = kBN docs a tile.
int fused_topk_plan(int mode, int B, int n_docs, int depth, int sm_count, int* plan) {
  if (mode < kF32 || mode > kLSH) return (int)cudaErrorInvalidValue;
  if (mode == kBF16) return bf16_plan(B, n_docs, depth, sm_count, plan);
  plan[4] = kBN;
  return streaming_plan(B, n_docs, depth, sm_count, plan);
}

// Both passes on `stream`, with the plan of fused_topk_plan in the same
// mode; returns the first cudaError_t (0 = launched).  mode: 0 f32, 1 bf16, 2 int8, 3 lsh.
// aligned: bit 0 set if every q row starts 16-byte aligned, bit 1 the same
// for docs.
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
      err = launch_partial_bq<kF32>(bq, q, docs, f, filt_stride, B, n_docs, T, K, splits,
                                    tiles_per_split, aligned, ps, pi, st);
      break;
    case kBF16:
      err = launch_bf16(bq, q, docs, f, filt_stride, B, n_docs, T, depth, K, splits,
                        tiles_per_split, aligned, ps, pi, st);
      break;
    case kI8:
      err = launch_partial_bq<kI8>(bq, q, docs, f, filt_stride, B, n_docs, T, K, splits,
                                   tiles_per_split, aligned, ps, pi, st);
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
// gathered_plan (topk_merge.cuh) with the query row's shared memory.
int fused_topk_gathered_plan(int mode, int B, int R, int T, int depth, int sm_count, int* plan) {
  if (mode < kF32 || mode > kLSH || T <= 0) return (int)cudaErrorInvalidValue;
  return gathered_plan(B, R, depth, gathered_query_bytes(T, elem_size(mode)), sm_count, plan);
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
      err = launch_gathered<kF32>(q, store, rid, B, R, n_docs, T, K, splits, rows_per_split,
                                  align, ps, pi, st);
      break;
    case kBF16:
      err = launch_gathered<kBF16>(q, store, rid, B, R, n_docs, T, K, splits, rows_per_split,
                                   align, ps, pi, st);
      break;
    case kI8:
      err = launch_gathered<kI8>(q, store, rid, B, R, n_docs, T, K, splits, rows_per_split,
                                 align, ps, pi, st);
      break;
    case kLSH:
      err = launch_gathered<kLSH>(q, store, rid, B, R, n_docs, T, K, splits, rows_per_split,
                                  align, ps, pi, st);
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
