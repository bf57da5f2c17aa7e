// What the fused top-k kernels share (fused_topk.cu: K1-K3;
// fused_topk_quantized.cu: K4-K5): the gathered pass 1's row-split plan (K3
// and K5: how R is split so that B = 1 fills the SMs, each block keeping one
// running list; the tensor-core pass 1 of K1 and K4 has its own plan, in
// mma_topk.cuh, and K2's CUDA-core pass 1 its own, in fused_topk.cu), the
// candidate buffers' sizes, the (score desc, id asc) order, the warp-wide
// sorted insert, and pass 2 (fused_topk_merge), which merges the splits'
// sorted partial lists of every query and writes the first `depth` entries.
// Each source is its own shared library, so the definitions live in an
// anonymous namespace and each library carries its own copy.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score_operands.cuh"  // kBK; the score modes of K1-K3

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBigId = 1 << 30;                 // id of an empty list slot
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr size_t kMaxSmem = 227 * 1024;         // opt-in dynamic shared memory per block

// A query's candidates wait in its buffer until more than bn / 4 have
// gathered (or the block's last tile or round is done); the buffer holds
// that many plus one tile's or round's worth.
__host__ __device__ constexpr int flush_at(int bn) { return bn / 4; }
__host__ __device__ constexpr int cand_cap(int bn) { return bn + flush_at(bn); }

// The gathered pass 1 (K3, K5): one query a block, whose kThreads threads
// score a round of kRowRound rows (a row a thread) between two threshold
// tests of the block's one running list; kRowBlocksPerSm blocks resident
// per SM (2 x 8 warps).
constexpr int kRowRound = kThreads;
constexpr int kRowCap = cand_cap(kRowRound), kRowFlushAt = flush_at(kRowRound);
constexpr int kRowBlocksPerSm = 2;

// Dynamic shared memory of a gathered pass-1 block whose query takes
// query_bytes: then the running list of K (score, id) pairs, the candidate
// buffer, and the threshold and count.
__host__ __device__ constexpr size_t row_block_smem(size_t query_bytes, int K) {
  return query_bytes + (size_t)(K + kRowCap) * 8 + 16;
}

// (as, ai) comes before (bs, bi) in the output order: score desc, id asc.
__device__ __forceinline__ bool precedes(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// Insert (cs, cid) into the sorted list (rs, ri) of K entries (K a multiple
// of 32), dropping the last entry.  The caller has checked that the
// candidate precedes the last entry.  All 32 lanes of the warp take part.
__device__ __forceinline__ void warp_insert(float* rs, int* ri, int K, float cs, int cid,
                                            int lane) {
  int cnt = 0;
  for (int c = lane; c < K; c += 32) cnt += precedes(rs[c], ri[c], cs, cid) ? 1 : 0;
  const int pos = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(cnt)));
  // Shift [pos, K-2] up by one, the top chunk first, so a chunk is read
  // before the chunk below it writes into its first slot.
  for (int base = ((K - 2) / 32) * 32; base >= (pos / 32) * 32; base -= 32) {
    const int c = base + lane;
    const bool mv = c >= pos && c <= K - 2;
    float v = 0.f;
    int vi = 0;
    if (mv) { v = rs[c]; vi = ri[c]; }
    __syncwarp();
    if (mv) { rs[c + 1] = v; ri[c + 1] = vi; }
    __syncwarp();
  }
  if (lane == 0) { rs[pos] = cs; ri[pos] = cid; }
  __syncwarp();
}

// How many of the sorted entries (ls, li)[0, n) come before (s, id) (kDup:
// before it or equal to it, so that a copy of an entry goes after it).
template <bool kDup = false>
__device__ __forceinline__ int rank_in(const float* ls, const int* li, int n, float s, int id) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kDup ? !precedes(s, id, ls[mid], li[mid]) : precedes(ls[mid], li[mid], s, id)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Pass 2 keeps two buffers of lists of `depth` (score, id) pairs and their
// lengths in shared memory, besides kMergeFixed bytes; merge_lists(depth)
// is how many lists a buffer holds within kMaxSmem.  Its block is
// kMergeThreads wide: every step of a merge is a chain of dependent
// shared-memory reads, and 32 warps hide four times the latency of 8.  One
// block per SM is all it asks for: aimed at two, ptxas held it to 32
// registers and it spilled.
constexpr int kMergeThreads = 1024;
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr size_t kMergeFixed = kMergeWarps * 8;
__host__ __device__ constexpr int merge_lists(int depth) {
  return (int)((kMaxSmem - kMergeFixed) / ((size_t)depth * 16 + 8));
}

// The gathered pass 1's launch plan (K3, K5) for B queries of R rows at
// `depth`, a block's query taking query_bytes of shared memory: plan[0] K
// (depth rounded up to 32), plan[1] row splits per query, plan[2] rows per
// split (a multiple of 32, and at least a round of kRowRound where R
// allows), so that B x splits is the blocks the SMs hold at once
// (kRowBlocksPerSm each): at B = 1 each block walks its rows to the end and
// pass 2 merges that many lists, not more; from B >= kRowBlocksPerSm x
// sm_count, one split.  Returns cudaErrorInvalidValue if the query and the
// list do not fit in shared memory (row_block_smem), or pass 2 cannot
// merge lists of depth.
inline int gathered_row_plan(int B, int R, int depth, size_t query_bytes, int sm_count,
                             int* plan) {
  if (B <= 0 || R <= 0 || depth <= 0 || depth > R || sm_count <= 0)
    return (int)cudaErrorInvalidValue;
  const int K = (depth + 31) / 32 * 32;
  if (row_block_smem(query_bytes, K) > kMaxSmem || merge_lists(depth) < 2)
    return (int)cudaErrorInvalidValue;
  const int want = (kRowBlocksPerSm * sm_count + B - 1) / B;
  const int most = (R + kRowRound - 1) / kRowRound;
  const int splits = want < most ? want : most;
  const int rows_per_split = ((R + splits - 1) / splits + 31) / 32 * 32;
  plan[0] = K;
  plan[1] = (R + rows_per_split - 1) / rows_per_split;  // no empty split
  plan[2] = rows_per_split;
  return 0;
}

// The better of (s, i) and (bs, bi) under (score desc, id asc), into (bs, bi).
__device__ __forceinline__ void keep_best(float s, int i, float& bs, int& bi) {
  if (precedes(s, i, bs, bi)) { bs = s; bi = i; }
}

// Pass 2: one block per query merges the splits' sorted lists of K and
// writes the first `depth` entries, -inf slots as id -1.  Only each list's
// first depth entries count (they are its split's exact top-depth).
//   * The threshold tau: the best, under (score desc, id asc), of every
//     split's depth-th entry, all read at once.  The split that holds tau
//     has depth entries at or before it, so no entry after tau can rank;
//     each list is cut after its last entry at or before tau (an entry tied
//     with tau in score but with a lower id is before it, and stays).
//   * The cut lists merge as a tree, every warp at once, a warp a list:
//     each level merges lists 2p and 2p + 1 into list p of the other
//     buffer, an entry's slot its index plus its rank in the other list
//     (binary search; list 2p goes first where two entries are equal, so
//     no two share a slot), slots >= depth dropped.  Up to `lists` lists
//     at a time: a later chunk of lists merges with the result so far, and
//     once that result holds depth entries its depth-th entry is a tighter
//     tau for the lists still to come.
// Where one warp merged every list of its query in turn, a query of 261
// splits took 261 dependent list reads and a sorted insert per entry that
// ranked (PERF.md §6).
__global__ void __launch_bounds__(kMergeThreads, 1) fused_topk_merge(
    const float* __restrict__ part_s, const int* __restrict__ part_i,  // (splits, B, K)
    int splits, int B, int K, int depth, int lists,
    float* __restrict__ out_s, int* __restrict__ out_i) {              // (B, depth)
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t cap = (size_t)lists * depth;
  float* xs = reinterpret_cast<float*>(smem);  // the buffer the next level reads
  int* xi = reinterpret_cast<int*>(xs + cap);
  float* ys = reinterpret_cast<float*>(xi + cap);  // and the one it writes
  int* yi = reinterpret_cast<int*>(ys + cap);
  int* xl = yi + cap;  // list lengths
  int* yl = xl + lists;
  float* red_s = reinterpret_cast<float*>(yl + lists);  // kMergeWarps partial taus
  int* red_i = reinterpret_cast<int*>(red_s + kMergeWarps);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qi = blockIdx.x;
  const size_t stride = (size_t)B * K;  // from one split's list to the next
  const float* ps = part_s + (size_t)qi * K;
  const int* pi = part_i + (size_t)qi * K;

  float tau_s = -INFINITY;
  int tau_i = kBigId;
  for (int s = tid; s < splits; s += kMergeThreads)
    keep_best(ps[s * stride + depth - 1], pi[s * stride + depth - 1], tau_s, tau_i);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    keep_best(__shfl_xor_sync(kFull, tau_s, m), __shfl_xor_sync(kFull, tau_i, m), tau_s, tau_i);
  if (lane == 0) { red_s[warp] = tau_s; red_i[warp] = tau_i; }
  __syncthreads();
  for (int w = 0; w < kMergeWarps; ++w) keep_best(red_s[w], red_i[w], tau_s, tau_i);

  int n_lists = 0;  // lists in x
  for (int s0 = 0; s0 < splits;) {
    const int take = min(splits - s0, lists - n_lists);
    for (int e = tid; e < take * depth; e += kMergeThreads) {
      const int j = e / depth, c = e - j * depth;
      const size_t src = (size_t)(s0 + j) * stride + c;
      xs[(size_t)(n_lists + j) * depth + c] = ps[src];
      xi[(size_t)(n_lists + j) * depth + c] = pi[src];
    }
    __syncthreads();
    for (int j = n_lists + tid; j < n_lists + take; j += kMergeThreads)  // entries at or before tau
      xl[j] = rank_in<true>(xs + (size_t)j * depth, xi + (size_t)j * depth, depth, tau_s, tau_i);
    n_lists += take;
    s0 += take;
    __syncthreads();
    while (n_lists > 1) {
      for (int a = warp; a < n_lists; a += kMergeWarps) {
        const int o = a ^ 1, na = xl[a], no = o < n_lists ? xl[o] : 0;
        const float* as = xs + (size_t)a * depth;
        const int* ai = xi + (size_t)a * depth;
        const float* os = xs + (size_t)o * depth;
        const int* oi = xi + (size_t)o * depth;
        float* rs = ys + (size_t)(a >> 1) * depth;
        int* ri = yi + (size_t)(a >> 1) * depth;
        for (int i = lane; i < na; i += 32) {
          const float v = as[i];
          const int id = ai[i];
          const int pos =
              i + ((a & 1) ? rank_in<true>(os, oi, no, v, id) : rank_in(os, oi, no, v, id));
          if (pos < depth) { rs[pos] = v; ri[pos] = id; }
        }
      }
      const int n_out = (n_lists + 1) / 2;
      for (int p = tid; p < n_out; p += kMergeThreads)
        yl[p] = min(depth, xl[2 * p] + (2 * p + 1 < n_lists ? xl[2 * p + 1] : 0));
      __syncthreads();
      float* fs = xs; xs = ys; ys = fs;
      int* fi = xi; xi = yi; yi = fi;
      fi = xl; xl = yl; yl = fi;
      n_lists = n_out;
    }
    if (xl[0] == depth) keep_best(xs[depth - 1], xi[depth - 1], tau_s, tau_i);
  }
  for (int c = tid; c < depth; c += kMergeThreads) {
    const float v = c < xl[0] ? xs[c] : -INFINITY;
    out_s[(size_t)qi * depth + c] = v;
    out_i[(size_t)qi * depth + c] = v == -INFINITY ? -1 : xi[c];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;  // every lane holds the same sum: each step adds the same pair
}
__device__ __forceinline__ int warp_sum(int v) {
  return static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(v)));
}

cudaError_t launch_merge(const float* part_s, const int* part_i, int splits, int B, int K,
                         int depth, void* out_s, void* out_i, cudaStream_t stream) {
  const int most = merge_lists(depth);
  if (most < 2 && splits > 1) return cudaErrorInvalidValue;
  const int lists = splits < most ? splits : most;
  const size_t smem = (size_t)lists * ((size_t)depth * 16 + 8) + kMergeFixed;
  cudaError_t err = cudaFuncSetAttribute(fused_topk_merge,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_topk_merge<<<B, kMergeThreads, smem, stream>>>(part_s, part_i, splits, B, K, depth, lists,
                                                  static_cast<float*>(out_s),
                                                  static_cast<int*>(out_i));
  return cudaGetLastError();
}

}  // namespace
