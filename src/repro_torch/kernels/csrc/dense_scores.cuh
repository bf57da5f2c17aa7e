// The dense (B, N) score tile of K8 (lsh_match.cu) on CUDA cores: out[b, n]
// = sum over the T columns of q[b, t] (*) docs[n, t] as int32, with (*) a
// MinHash collision count (uint32 slots that are equal and not the query
// sentinel 0xFFFFFFFF).  K6 and K7 run the tensor-core tile of
// score_matmul.cuh.
//
// Bound on an H100 SXM: the kernel writes a (B, N) matrix, 4 bytes an entry
// (3.07 GB at B = 256 over the 2,999,808-row ann-word2vec corpus), and reads
// the (N, T) store once; the compare runs on CUDA cores and at best reaches
// its operation bound (16.7e12 INT32 op/s).
//
// Design (simple first): a block of 256 threads owns kBM = 64 queries and
// kBN = 128 docs; each warp owns kTM = 8 query rows and each lane kTN = 4 doc
// columns (lane + 32 j), so the score tile lives in registers and the
// epilogue's stores are coalesced (a warp writes 128 consecutive bytes of a
// row).  The T axis is walked in chunks of kBK = 32 four-byte words (one f32
// or uint32 element a word); the next chunk is loaded from device memory
// into registers while the current one, staged in shared memory, is
// multiplied.  Rows are read with the widest load their alignment allows
// (16 bytes, 8 bytes, or element loads for other alignments and for the
// ragged end of a row).  Ragged B, N and T are bounds-checked: a missing
// column is 0 (the sentinel on the lsh query side, so it never counts), a
// missing row is never written.  The tile is templated on the score mode M
// (score_operands.cuh).  The grid is 1-D with the query tiles of one
// doc tile adjacent, so the B / 64 blocks that read one doc tile run
// together and re-read it from L2.
#pragma once

#include <limits.h>

#include "score_operands.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 8;               // query rows per warp
constexpr int kBM = kWarps * kTM;    // queries per block
constexpr int kTN = 4;               // doc columns per lane
constexpr int kBN = 32 * kTN;        // docs per block

// What the epilogue writes: the sum as int32.  E and the unused inv_norm
// parameter keep K8's instance, its parameter layout and so its SASS as
// they were when the tile also served K6's scaled f32 epilogue.
enum Epilogue { kOutI32 = 1 };

template <int M, int E>
__global__ void __launch_bounds__(kThreads) dense_scores(
    const typename Traits<M>::Raw* __restrict__ q,     // (B, T)
    const typename Traits<M>::Raw* __restrict__ docs,  // (N, T)
    const float* __restrict__ inv_norm,                 // unused
    void* __restrict__ out,                             // (B, N) int32
    int B, int N, int T, int q_align, int d_align, int q_tiles) {
  using Tr = Traits<M>;
  using V = Vec<M>;
  using Word = typename Tr::Word;
  using Acc = typename Tr::Acc;
  constexpr int kDLoads = kBN * V::kPerRow / kThreads;
  constexpr int kQLoads = kBM * V::kPerRow / kThreads;
  static_assert(kDLoads * kThreads == kBN * V::kPerRow, "doc chunk must split evenly");
  static_assert(kQLoads * kThreads == kBM * V::kPerRow, "query chunk must split evenly");

  __shared__ __align__(16) Word qs[kBK * kBM];  // k-major
  __shared__ Word ds[kBN * kSkew];              // row-major, skewed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (blockIdx.x % q_tiles) * kBM;
  const int d0 = (blockIdx.x / q_tiles) * kBN;
  const int n_chunks = ((T + Tr::kPerWord - 1) / Tr::kPerWord + kBK - 1) / kBK;

  uint4 dst[kDLoads], qst[kQLoads];
  auto load_chunk = [&](int chunk) {
    const int w0 = chunk * kBK;
#pragma unroll
    for (int i = 0; i < kDLoads; ++i) {
      const int v = tid + i * kThreads, r = v / V::kPerRow, c = v % V::kPerRow;
      const int di = d0 + r;
      dst[i] = load_pack<M>(docs + (size_t)di * T, di < N, (w0 + c * V::kWords) * Tr::kPerWord,
                            T, d_align, false);
    }
#pragma unroll
    for (int i = 0; i < kQLoads; ++i) {
      const int v = tid + i * kThreads, r = v % kBM, c = v / kBM;
      const int qi = q0 + r;
      qst[i] = load_pack<M>(q + (size_t)qi * T, qi < B, (w0 + c * V::kWords) * Tr::kPerWord, T,
                            q_align, true);
    }
  };

  Acc acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = Acc(0);

  load_chunk(0);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    __syncthreads();  // every warp is done with the previous chunk
#pragma unroll
    for (int i = 0; i < kDLoads; ++i) {
      const int v = tid + i * kThreads, r = v / V::kPerRow, c = v % V::kPerRow;
      store_pack<M>(ds + r * kSkew + c * V::kWords, 1, dst[i]);
    }
#pragma unroll
    for (int i = 0; i < kQLoads; ++i) {
      const int v = tid + i * kThreads, r = v % kBM, c = v / kBM;
      store_pack<M>(qs + c * V::kWords * kBM + r, kBM, qst[i]);
    }
    __syncthreads();
    if (chunk + 1 < n_chunks) load_chunk(chunk + 1);  // in flight during the products

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      Word a[kTM], b[kTN];
#pragma unroll
      for (int g = 0; g < kTM / 4; ++g) {  // one broadcast 16-byte read per 4 rows
        const uint4 av = *reinterpret_cast<const uint4*>(qs + kk * kBM + warp * kTM + 4 * g);
        a[4 * g + 0] = from_bits<M>(av.x);
        a[4 * g + 1] = from_bits<M>(av.y);
        a[4 * g + 2] = from_bits<M>(av.z);
        a[4 * g + 3] = from_bits<M>(av.w);
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ds[(lane + 32 * j) * kSkew + kk];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = mac<M>(acc[i][j], a[i], b[j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int qi = q0 + warp * kTM + i;
    if (qi >= B) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int d = d0 + lane + 32 * j;
      if (d >= N) continue;
      static_cast<int*>(out)[(size_t)qi * N + d] = static_cast<int>(acc[i][j]);
    }
  }
}

// Launch the tile over a (B, N) output on `stream`; returns the launch's
// error (a refused launch never runs, and a later synchronize does not
// report it).
template <int M>
cudaError_t launch_dense_scores(const void* q, const void* docs, void* out, int B, int N, int T,
                                int q_align, int d_align, cudaStream_t stream) {
  using Raw = typename Traits<M>::Raw;
  if (B <= 0 || N <= 0 || T <= 0) return cudaErrorInvalidValue;
  const int q_tiles = (B + kBM - 1) / kBM;
  const long long blocks = (long long)q_tiles * ((N + kBN - 1) / kBN);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  dense_scores<M, kOutI32><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const Raw*>(q), static_cast<const Raw*>(docs), nullptr, out, B, N, T, q_align,
      d_align, q_tiles);
  return cudaGetLastError();
}

}  // namespace
