// Dense MinHash collision counts for Hopper (sm_90a), CUDA C++ with a plain C
// interface (bound with ctypes by ../kernel.py).
//
// Replaces the TPU kernel repro/kernels/lsh_match/kernel.py::
// lsh_match_scores (def 41, pallas_call 64): scores[b, n] = #{s : sig_q[b, s]
// == sig_d[n, s] != 0xFFFFFFFF}, (B, N) int32.  The TPU kernel pads the
// signature axis with the sentinel on the query side and sentinel - 1 on the
// document side so that padding never matches; this kernel bounds-checks
// instead: a slot past S is never compared, and rows past B or N are never
// written.  A doc slot of 0xFFFFFFFF never counts (only a sentinel query
// slot equals it); a doc slot of 0xFFFFFFFE counts where the query holds it.
//
// Bound on an H100 SXM at the lexical-LSH cell (N = 2,999,808, S = 300):
// at B = 256, 2.3e11 compares at 16.7e12 INT32 op/s (64 INT32 lanes an SM x
// 132 SMs x 1.98 GHz), 13.8 ms, above the 1.99 ms of its bytes (3.60 GB of
// signatures in, 3.07 GB of counts out): operations bound it.  At B = 8 and
// 1 the bytes do (the store read once, the counts written once: 1.10 and
// 1.08 ms at 3.35 TB/s).  No tensor cores: a count of 32-bit equalities is
// no product, only exact equality counts, and a fingerprint or one-hot
// encoding that would make it one would change the results.
//
// The compare is K2's (lsh_word, ../../csrc/lsh_count.cuh): one ISETP a
// compare with the query word's sentinel test as its predicate (that test
// once a query word: 1/8 of an ISETP a compare at 8 docs a thread) and a
// predicated FADD into an f32 count on the FP32 pipe.  At ~1.13 ALU and
// ~2.29 issued instructions a compare (the counts of the SASS are in
// PERF.md), the ALU pipe (two cycles a warp instruction) floors the cell at
// ~15.6 ms and issue (one warp instruction a scheduler a cycle) at ~15.8 ms.
// Counts stay exact in f32 below 2^24 slots, so the launch refuses S >= 2^24.
//
// Design:
//   * Query tiles by batch (lsh_match_plan): 64 queries x 128 docs (a thread
//     4 queries x 8 docs, LshTile) from B = 9; at B <= 8 the tile of 1, 2, 4
//     or 8 rows that holds B, of 256 docs, so that padded rows run no
//     compares.
//   * Persistent blocks, k8_blocks an SM (grid: query tiles x splits):
//     block (x, split) walks doc tiles [split * tiles_per_split, ...) through
//     a three-stage cp.async ring of 32-slot chunks of the tile's doc rows and
//     its query rows (16-byte copies where every row is 16-byte aligned,
//     4-byte ones else; a copy past S or of a row that does not exist is
//     zero-filled and never read), so a block fills the ring once.  The
//     query tiles of a split are adjacent in launch order and re-read its
//     docs from L2.
//   * The epilogue: after a tile's last chunk its counts go out as int32
//     while the ring's next two chunks are in flight, by streaming stores
//     (st.global.cs), each a whole 128-byte line of a row: at 64 queries a
//     thread's docs are 16 apart, so each warp stages its rows through
//     shared memory of its own, kOutRows at a time; below 64 queries a
//     warp's lanes hold 32 consecutive docs of each row already.

#include "lsh_count.cuh"  // LshTile, lsh_chunk, lsh_word; kBK
#include "mma_sync.cuh"   // cp.async

namespace {

constexpr int kK8Unroll = 2;             // a chunk's 4-slot steps unrolled (lsh_chunk)
constexpr int kK8Warps = kLshThreads / 32;
constexpr int kOutRows = 4;              // rows a warp stages at a time (64-query tiles)
constexpr int kOutStride = 128 + 8;      // words a staged row: rows 2 apart 16 banks apart
constexpr size_t kK8SmemPerSm = 228 * 1024;  // shared memory of an SM
constexpr size_t kK8SmemPerBlock = 1024;     // what the card reserves per resident block
constexpr int kMaxSlots = 1 << 24;       // f32 counts are exact below 2^24

// Dynamic shared memory of a block of bq queries: the ring's stages (the
// tile's doc rows, then its query rows, kLshStride words each) and, at 64
// queries, each warp's kOutRows staged output rows.
__host__ __device__ constexpr size_t k8_smem(int bq) {
  return (size_t)kLshStages * (lsh_bn(bq) + bq) * kLshStride * 4 +
         (bq == 64 ? (size_t)kK8Warps * kOutRows * kOutStride * 4 : 0);
}

// Resident blocks an SM of the instance for bq queries (__launch_bounds__
// and the plan): two at 64 queries, where the compares set the pace and a
// second block's warps fill the issue slots that one block's barriers and
// latencies leave; one below, where the loads do and one ran no slower
// (PERF.md, PR 29).
__host__ __device__ constexpr int k8_blocks(int bq) { return bq == 64 ? 2 : 1; }

constexpr bool k8_fits(int bq) {
  return k8_blocks(bq) * (k8_smem(bq) + kK8SmemPerBlock) <= kK8SmemPerSm;
}
static_assert(k8_fits(64) && k8_fits(8) && k8_fits(4) && k8_fits(2) && k8_fits(1),
              "k8_blocks blocks of every tile fit in an SM's shared memory");

// K8's launch plan for B queries over N docs of S slots on sm_count SMs:
// plan[0] queries a block (64 from B = 9; at B <= 8 the tile of 1, 2, 4 or 8
// rows that holds them), plan[1] N-splits, plan[2] doc tiles a split,
// plan[3] docs a tile (lsh_bn), plan[4] blocks an SM, so that query tiles x
// splits fill every SM's resident blocks, at B = 256 and at B = 1 alike.
// Returns cudaErrorInvalidValue for an empty shape or S >= 2^24.
inline int k8_plan(int B, int N, int S, int sm_count, int* plan) {
  if (B <= 0 || N <= 0 || S <= 0 || S >= kMaxSlots || sm_count <= 0)
    return (int)cudaErrorInvalidValue;
  const int bq = B >= 9 ? 64 : (B >= 5 ? 8 : (B >= 3 ? 4 : B));
  const int bn = lsh_bn(bq);
  const int n_tiles = (N + bn - 1) / bn;
  const int q_tiles = (B + bq - 1) / bq;
  const int want = (k8_blocks(bq) * sm_count + q_tiles - 1) / q_tiles;
  const int splits = want < n_tiles ? want : n_tiles;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  plan[0] = bq;
  plan[1] = (n_tiles + tiles_per_split - 1) / tiles_per_split;  // no empty split
  plan[2] = tiles_per_split;
  plan[3] = bn;
  plan[4] = k8_blocks(bq);
  return 0;
}

// The counts of one tile (queries q0.., docs d0..) as int32, by streaming
// stores of whole 128-byte lines; rows >= B and docs >= N are not written.
// At 64 queries (DG = 16: a warp holds two query groups, its lanes' docs 16
// apart) each warp stages 2 queries of each of its groups at a time in
// `buf`, its kOutRows rows of kOutStride words, and stores them row by row.
template <int BQ>
__device__ __forceinline__ void store_counts(
    const float (&acc)[LshTile<BQ>::TQ][LshTile<BQ>::TD], int* __restrict__ out, int* buf,
    int B, int N, int q0, int d0, int qg, int dg, int rows) {
  using L = LshTile<BQ>;
  constexpr int TQ = L::TQ, TD = L::TD, DG = L::DG, BN = L::BN;
  if constexpr (DG >= 32) {  // lanes dg .. dg + 31 of a warp: 32 consecutive docs of a row
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      if (i >= rows) break;
      int* row = out + (size_t)(q0 + qg * TQ + i) * N;
#pragma unroll
      for (int j = 0; j < TD; ++j) {
        const int d = d0 + dg + DG * j;
        if (d < N) __stcs(row + d, static_cast<int>(acc[i][j]));
      }
    }
  } else {
    static_assert(2 * DG == 32 && kOutRows == 4 && TQ == 4,
                  "a warp holds two query groups and stages 2 queries of each at a time");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, half = lane / DG;
#pragma unroll
    for (int r = 0; r < TQ; r += 2) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j)
          buf[(2 * half + i) * kOutStride + dg + DG * j] = static_cast<int>(acc[r + i][j]);
      __syncwarp();
#pragma unroll
      for (int p = 0; p < kOutRows; ++p) {  // query r + p % 2 of the warp's group p / 2
        const int qi = q0 + (2 * warp + p / 2) * TQ + r + p % 2;
        if (qi >= B) continue;  // warp-uniform
        int* row = out + (size_t)qi * N;
#pragma unroll
        for (int k = 0; k < BN / 32; ++k) {
          const int d = d0 + 32 * k + lane;
          if (d < N) __stcs(row + d, buf[p * kOutStride + 32 * k + lane]);
        }
      }
      __syncwarp();
    }
  }
}

// Grid (query tiles of BQ, splits): block (x, split) counts queries [x * BQ,
// x * BQ + BQ) against doc tiles [split * tiles_per_split, ...) of BN docs
// in turn.  Each step stages one chunk of kBK slots of a tile's doc rows and
// of the query rows through the cp.async ring of kLshStages (CP = 16:
// 16-byte copies, every row 16-byte aligned; CP = 4: 4-byte copies), and
// every thread adds the chunk's equalities to its TQ x TD counts
// (lsh_chunk).  After a tile's last chunk its counts go out (store_counts)
// while the next two chunks are in flight.
template <int BQ, int CP>
__global__ void __launch_bounds__(kLshThreads, k8_blocks(BQ)) lsh_match_counts(
    const uint32_t* __restrict__ q,     // (B, S)
    const uint32_t* __restrict__ docs,  // (N, S)
    int* __restrict__ out,              // (B, N)
    int B, int N, int S, int tiles_per_split) {
  using L = LshTile<BQ>;
  constexpr int BN = L::BN, TQ = L::TQ, TD = L::TD, DG = L::DG, NT = L::NT;
  constexpr int kStage = (BN + BQ) * kLshStride;  // words
  constexpr int kUnits = kBK * 4 / CP;            // copies a staged row and chunk
  static_assert(BN == lsh_bn(BQ), "lsh_bn sizes the plan and the shared memory");
  static_assert(CP == 16 || CP == 4, "16- or 4-byte copies");

  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* stages = reinterpret_cast<uint32_t*>(smem);
  int* buf = reinterpret_cast<int*>(stages + kLshStages * kStage) +
             (threadIdx.x >> 5) * kOutRows * kOutStride;  // this warp's staged rows (BQ = 64)

  const int tid = threadIdx.x;
  const int dg = tid % DG, qg = tid / DG;
  const int q0 = blockIdx.x * BQ;
  const int rows = min(TQ, B - (q0 + qg * TQ));  // this thread's queries that exist
  const int n_chunks = (S + kBK - 1) / kBK;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, (N + BN - 1) / BN);

  int copy_tile = tile_begin, copy_chunk = 0, copy_stage = 0;  // the next chunk to stage
  auto copy_next = [&]() {  // that chunk of the doc and query rows into its stage, if any
    if (copy_tile < tile_end) {
      uint32_t* st = stages + copy_stage * kStage;
      const int d0 = copy_tile * BN, w0 = copy_chunk * kBK;
      for (int v = tid; v < (BN + BQ) * kUnits; v += NT) {
        const int r = v / kUnits, e = w0 + (v % kUnits) * (CP / 4);
        const bool is_doc = r < BN;
        const int row = is_doc ? d0 + r : q0 + r - BN;
        const bool ok = (is_doc ? row < N : row < B) && e < S;
        const uint32_t* src = (is_doc ? docs : q) + (ok ? (size_t)row * S + e : 0);
        uint32_t* dst = st + r * kLshStride + (v % kUnits) * (CP / 4);
        if constexpr (CP == 16) cp_async16(dst, src, ok ? 16 : 0);
        else cp_async4(dst, src, ok ? 4 : 0);
      }
      if (++copy_chunk == n_chunks) { copy_chunk = 0; ++copy_tile; }
      copy_stage = copy_stage == kLshStages - 1 ? 0 : copy_stage + 1;
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s0 = 0; s0 < kLshStages - 1; ++s0) copy_next();
  int read_stage = 0;
  for (int tile = tile_begin; tile < tile_end; ++tile) {
    float acc[TQ][TD];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      // This chunk has landed; after the barrier every thread is done with
      // the stage of the previous step, which the chunk kLshStages - 1 ahead
      // fills.
      cp_async_wait<kLshStages - 2>();
      __syncthreads();
      copy_next();
      const uint32_t* ds = stages + read_stage * kStage;
      read_stage = read_stage == kLshStages - 1 ? 0 : read_stage + 1;
      const int words = min(kBK, S - chunk * kBK);  // slots of this chunk
      if (rows >= TQ)
        lsh_chunk<BQ, true, kK8Unroll>(acc, ds, ds + BN * kLshStride, dg, qg, words, TQ);
      else if (rows > 0)
        lsh_chunk<BQ, false, kK8Unroll>(acc, ds, ds + BN * kLshStride, dg, qg, words, rows);
    }
    store_counts<BQ>(acc, out, buf, B, N, q0, tile * BN, qg, dg, rows);
  }
}

template <int BQ, int CP>
cudaError_t launch_instance(const void* q, const void* docs, void* out, int B, int N, int S,
                            int splits, int tiles_per_split, cudaStream_t stream) {
  const int smem = (int)k8_smem(BQ);
  auto kernel = lsh_match_counts<BQ, CP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BQ - 1) / BQ, splits);
  kernel<<<grid, kLshThreads, smem, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(docs),
      static_cast<int*>(out), B, N, S, tiles_per_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K8's launch plan (k8_plan): plan[0..4] = queries a block, N-splits, doc
// tiles a split, docs a tile, blocks an SM; 0, or cudaErrorInvalidValue.
int lsh_match_plan(int B, int N, int S, int sm_count, int* plan) {
  return k8_plan(B, N, S, sm_count, plan);
}

// The (B, N) int32 counts into `out` on `stream`, on the current device's
// plan; returns the launch's cudaError_t (0 = launched; a refused launch
// never runs, and a later synchronize does not report it).  q_align /
// d_align: the byte alignment every q / doc row starts at (16, 8, 4 or 1):
// 16-byte copies where both are 16, else 4-byte ones.
int lsh_match_scores_launch(const void* sig_q, const void* sig_d, void* out, int B, int N, int S,
                            int q_align, int d_align, void* stream) {
  int dev = 0, sm_count = 0, plan[5];
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int bad = k8_plan(B, N, S, sm_count, plan);
  if (bad != 0) return bad;
  if (q_align < 4 || d_align < 4) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = q_align >= 16 && d_align >= 16;
#define LSH_MATCH(BQ)                                                                          \
  return (int)(wide ? launch_instance<BQ, 16>(sig_q, sig_d, out, B, N, S, plan[1], plan[2], st) \
                    : launch_instance<BQ, 4>(sig_q, sig_d, out, B, N, S, plan[1], plan[2], st))
  switch (plan[0]) {
    case 64: LSH_MATCH(64);
    case 8: LSH_MATCH(8);
    case 4: LSH_MATCH(4);
    case 2: LSH_MATCH(2);
    case 1: LSH_MATCH(1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LSH_MATCH
}

const char* lsh_match_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
