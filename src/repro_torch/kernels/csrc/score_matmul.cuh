// The dense (B, N) score matrix on mma.sync tensor cores, shared by K7
// (../fakewords_score/csrc/fakewords_score.cu: bf16 HMMA and int8 IMMA) and
// K6 (../cosine_score/csrc/cosine_score.cu: split TF32 over f32 rows, each
// score times its doc's inverse norm): out[b, n] = sum over the T columns
// of q[b, t] docs[n, t].  One body (score_matmul_body), templated on the
// product type Op, which each source defines: the element of q and docs
// (and its score_operands.cuh mode, for the register loader), the columns
// of a 64-byte chunk, the docs of a block's tile (kBD), the registers of a
// query (A) and a doc (B) fragment as the mma takes them (kARegs, kBRegs:
// ldmatrix fills the first four and two, split_a and split_b the rest), the
// accumulator, the mma, and kFold: false where the mma sums onto the row's
// accumulator, true where it sums each chunk's products from zero into a
// fragment of their own that an f32 add then folds into the row's sum.
//
// Design (chip_smoke.py --ablate, PERF.md):
//   * Queries on M, docs on N: a block owns kBQ = 128 queries and walks doc
//     tiles of Op::kBD; 8 warps as 2 (queries) x 4 (docs), each warp 64
//     queries x kBD / 4 docs.  A C fragment's c0, c1 are two adjacent docs of
//     one query row, so each lane stores 8 bytes and the four lanes of a
//     quad one whole 32-byte sector of the row-major (B, N) output.  The
//     stores are streaming (st.global.cs): the scores are written once and
//     never read.  A query row and a doc row are both K-contiguous, the
//     row-major A and the column-major B operand of the mma, so both come by
//     ldmatrix without a transpose (K1's pass 1, mma_topk.cuh, has the two
//     sides swapped: docs on M, as its top-k wants).
//   * Persistent blocks, one a SM: the grid is the query tiles x as many
//     splits of the doc tiles as fill the SMs, the query tiles of a split
//     adjacent, so the blocks that read a doc tile run together and it
//     comes from device memory once and from L2 after that.  A tile's
//     stores are issued while the next tile's first chunks are in flight.
//   * Resident queries: where they fit beside the ring, the block's 128
//     query rows stay in shared memory, all chunks, for all its doc tiles
//     (rows n_chunks x 64 + 16 bytes apart: no bank conflicts), and only doc
//     chunks stream.  At B = 256 L2 then serves each doc tile twice, not
//     once a query tile and chunk.  The queries' chunks come through the
//     same ring as the docs' first, and each thread moves the packs it
//     copied into the resident rows.  Longer rows stream each query chunk
//     beside the doc chunk.
//   * A chunk is 64 bytes of every row (32 bf16, 64 int8 or 16 f32 columns),
//     two k-steps of 32 bytes; .bf16 m16n8k16, .s8 m16n8k32 and .tf32
//     m16n8k8 fragments sit at the same bytes, so the ldmatrix addressing is
//     shared.  Stages are unpadded, their 16-byte units swizzled (staged()),
//     so that a ring of kRingStages = 4 (three chunks in flight) fits beside
//     the resident queries.
//   * Loads: where every q and doc row is 16-byte aligned, a cp.async ring of
//     16-byte copies; 8-byte aligned rows take the same ring with two 8-byte
//     copies a pack (cp.async.ca, through L1).  Every copy lies wholly inside
//     or wholly past its row, and one past T, or of a row >= B or >= N, is
//     zero-filled and reads nothing: a stage that held an earlier chunk
//     keeps none of it where the last chunk ends inside a k-step.  Rows
//     aligned to 4 or 1 bytes go through registers one chunk ahead (element
//     loads, load_pack of score_operands.cuh) into two stages; no alignment
//     is refused.
#pragma once

#include <limits.h>
#include <stdint.h>

#include "mma_sync.cuh"        // ldmatrix, the mma, cp.async
#include "score_operands.cuh"  // the modes and load_pack, for the register loader

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 128;                       // queries a block (the mma's M side)
constexpr int kChunk = 64;                     // bytes of a row a chunk
constexpr int kPacks = kChunk / 16;            // 16-byte packs of a row a chunk
constexpr int kKSteps = kChunk / 32;           // mma k-steps of 32 bytes a chunk
constexpr int kRowLanes = kChunk / 2;          // 16-bit lanes of a staged row (unpadded)
constexpr int kRingStages = 4;                 // cp.async ring: three chunks in flight
constexpr int kRegStages = 2;                  // the register loader's stages
constexpr int kWarpsQ = 2, kWarpsD = 4;        // the warps' grid over the block's tile
constexpr int kWM = kBQ / (16 * kWarpsQ);      // 16-query fragments a warp
constexpr size_t kMaxSmem = 227 * 1024;        // opt-in dynamic shared memory of a block
static_assert(kWarpsQ * kWarpsD * 32 == kThreads, "the warps tile the block");

// 8-doc fragments a warp, and bytes of a stage of doc rows, for docs tiles
// of Op::kBD.
template <class Op>
__host__ __device__ constexpr int warp_doc_frags() {
  return Op::kBD / (8 * kWarpsD);
}
template <class Op>
__host__ __device__ constexpr int stage_bytes() {
  return Op::kBD * kChunk;
}

// The 16-byte pack at column e of row `row` of the (rows, T) matrix `base`
// into `dst` of a stage by cp.async, as CP-byte copies (CP = 16 or 8: every
// row CP-byte aligned, so each copy lies wholly inside or wholly past T).
// A copy past T, or of a row that does not exist (!row_ok), reads nothing
// and writes zeros.
template <int CP, class E>
__device__ __forceinline__ void copy_pack(uint16_t* dst, const E* base, int row, bool row_ok,
                                          int e, int T) {
  static_assert(CP == 16 || CP == 8, "16- or 8-byte copies");
  constexpr int kCopyCols = CP / sizeof(E);
#pragma unroll
  for (int h = 0; h < 16 / CP; ++h) {
    const int eh = e + h * kCopyCols;
    const bool ok = row_ok && eh < T;
    const E* src = ok ? base + (size_t)row * T + eh : base;
    if constexpr (CP == 16) cp_async16(dst, src, ok ? 16 : 0);
    else cp_async8(dst + 4 * h, src, ok ? 8 : 0);
  }
}

template <class O> struct Pair;
template <> struct Pair<float> {
  using T = float2;
  static __device__ __forceinline__ float2 make(float a, float b) { return make_float2(a, b); }
};
template <> struct Pair<int> {
  using T = int2;
  static __device__ __forceinline__ int2 make(int a, int b) { return make_int2(a, b); }
};

// Scores v0, v1 of docs d, d + 1 into the output row `row` of N, by
// streaming stores (st.global.cs): one 8-byte store where both docs exist
// and N is even (the pair is then 8-byte aligned), else one 4-byte store a
// doc that exists.
template <class O>
__device__ __forceinline__ void store_pair(O* row, int d, int N, O v0, O v1) {
  if (d + 1 < N && (N & 1) == 0) {
    __stcs(reinterpret_cast<typename Pair<O>::T*>(row + d), Pair<O>::make(v0, v1));
  } else {
    if (d < N) __stcs(row + d, v0);
    if (d + 1 < N) __stcs(row + d + 1, v1);
  }
}

// The 16-bit lane of 16-byte unit u of staged row r: a staged row is 64
// bytes, four units, stored in the order u ^ ((r / 2) % 4), so the eight
// consecutive rows an ldmatrix phase reads at one unit fall on the eight
// distinct 16-byte bank groups.
__device__ __forceinline__ int staged(int r, int u) {
  return r * kRowLanes + ((u ^ (r >> 1)) & 3) * 8;
}

// 16-bit lanes between two resident query rows of n_chunks chunks: n_chunks
// x 64 + 16 bytes, an odd number of 16-byte units, so the eight rows an
// ldmatrix phase reads fall on distinct banks.
__host__ __device__ constexpr int resident_stride(int n_chunks) {
  return n_chunks * kRowLanes + 8;
}

// Dynamic shared memory of a block: `stages` stages of the ring (Op::kBD doc
// rows each where the queries are resident, else kBQ query rows and
// Op::kBD doc rows), then, where resident, every chunk of the block's kBQ
// query rows.
template <class Op>
inline size_t smem_bytes(bool resident, int stages, int n_chunks) {
  return resident
             ? (size_t)stages * stage_bytes<Op>() + (size_t)kBQ * resident_stride(n_chunks) * 2
             : (size_t)stages * (kBQ + Op::kBD) * kChunk;
}

// The body of a block over the (B, N) output: block x owns queries
// [(x % q_tiles) kBQ, +kBQ) and the tiles_per_split doc tiles of Op::kBD
// docs from (x / q_tiles) tiles_per_split on, walked in steps of one chunk
// through a ring of NS stages.  CP = 16 or 8: the cp.async ring of CP-byte
// copies (every q and doc row CP-byte aligned); CP = 0: packs loaded
// through registers one step ahead (q_align and d_align: the alignment
// each side's rows start at, for load_pack).  RESIDENT: the block's queries
// stay in shared memory for all its tiles; the first n_chunks steps stage
// their chunks through the ring like any other (each thread moves the packs
// it copied into the resident rows), and every later step stages a doc
// chunk only.  Else each step stages the query chunk beside the doc chunk.
// SCALED: each score is written times its doc's inv_norm (read once a tile,
// never past N).
template <class Op, class O, bool SCALED, int CP, bool RESIDENT, int NS>
__device__ __forceinline__ void score_matmul_body(const typename Op::Elem* __restrict__ q,
                                                  const typename Op::Elem* __restrict__ docs,
                                                  const float* __restrict__ inv_norm,
                                                  O* __restrict__ out, int B, int N, int T,
                                                  int q_align, int d_align, int q_tiles,
                                                  int tiles_per_split) {
  using Acc = typename Op::Acc;
  static_assert(CP != 0 || !RESIDENT, "resident queries come through the ring");
  static_assert(CP ? NS >= 3 : NS == kRegStages, "a ring of stages, or two through registers");
  constexpr int kBD = Op::kBD;
  constexpr int kWN = warp_doc_frags<Op>();
  static_assert(kWN % 2 == 0, "doc fragments load in pairs");
  constexpr int kStageRows = RESIDENT ? kBD : kBQ + kBD;  // doc rows, after the query rows if any
  constexpr int kStageElems = kStageRows * kRowLanes;
  constexpr int kLoads = kStageRows * kPacks / kThreads;  // packs a thread stages a step
  constexpr int kQPackLoads = kBQ * kPacks / kThreads;    // a query chunk's packs a thread
  constexpr int kQLoads = RESIDENT ? 0 : kQPackLoads;     // stages beside the doc packs
  static_assert(kLoads * kThreads == kStageRows * kPacks && kQPackLoads * kThreads == kBQ * kPacks,
                "a thread's first kQLoads packs are query packs, the rest doc packs");
  constexpr int kPackCols = 16 / sizeof(typename Op::Elem);  // columns of a 16-byte pack
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* stages = reinterpret_cast<uint16_t*>(smem);  // NS x kStageRows rows
  uint16_t* slab = stages + NS * kStageElems;             // RESIDENT: kBQ query rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (blockIdx.x % q_tiles) * kBQ;
  const int tile_begin = (blockIdx.x / q_tiles) * tiles_per_split;
  const int wq = (warp % kWarpsQ) * kWM * 16, wd = (warp / kWarpsQ) * kWN * 8;
  const int n_chunks = (T + Op::kCols - 1) / Op::kCols;
  const int q_stride = resident_stride(n_chunks);  // RESIDENT only
  const int n_tiles = min(tile_begin + tiles_per_split, (N + kBD - 1) / kBD) - tile_begin;
  if (n_tiles <= 0) return;

  // The next chunk to load: chunk cc of doc tile ct of the block (ct = -1:
  // the resident queries' chunk cc), into stage n_loaded % NS.  Pack i of
  // this thread: staged row r = v / kPacks, 16-byte pack v % kPacks of the
  // chunk (v = tid + i kThreads); a query row for i < kQLoads, or for i <
  // kQPackLoads where ct = -1 (the other rows of the stage are not read
  // then), else a doc row.
  int cc = 0, ct = RESIDENT ? -1 : 0, n_loaded = 0;
  auto advance = [&]() {
    if (++cc == n_chunks) {
      cc = 0;
      ++ct;
    }
    ++n_loaded;
  };
  auto copy_next = [&]() {  // the next chunk into its stage of the ring
    if (ct >= n_tiles) return;
    uint16_t* st = stages + (n_loaded % NS) * kStageElems;
    const int d0 = (tile_begin + ct) * kBD;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int v = tid + i * kThreads, r = v / kPacks, p = v % kPacks;
      const int e = cc * Op::kCols + p * kPackCols;
      uint16_t* dst = st + staged(r, p);
      if (i < kQLoads || (ct < 0 && i < kQPackLoads))
        copy_pack<CP ? CP : 16>(dst, q, q0 + r, q0 + r < B, e, T);
      else if (ct >= 0)
        copy_pack<CP ? CP : 16>(dst, docs, d0 + r - (kQLoads ? kBQ : 0),
                                d0 + r - (kQLoads ? kBQ : 0) < N, e, T);
    }
    advance();
  };
  uint4 held[CP ? 1 : kLoads];  // the register loader's next chunk
  auto load_next = [&]() {
    if (ct >= n_tiles) return;
    const int d0 = (tile_begin + ct) * kBD;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int v = tid + i * kThreads, r = v / kPacks;
      const int e = cc * Op::kCols + (v % kPacks) * kPackCols;
      if (i < kQLoads)
        held[i] = load_pack<Op::kMode>(q + (size_t)(q0 + r) * T, q0 + r < B, e, T, q_align, true);
      else
        held[i] = load_pack<Op::kMode>(docs + (size_t)(d0 + r - kBQ) * T, d0 + r - kBQ < N, e, T,
                                       d_align, false);
    }
    advance();
  };

  // The stage of the next chunk in order, ready for every warp.
  int n_used = 0;
  auto next_stage = [&]() -> const uint16_t* {
    uint16_t* st = stages + (n_used++ % NS) * kStageElems;
    if constexpr (CP != 0) {
      // This chunk has landed; after the barrier every warp is done with
      // the previous chunk's stage, which the chunk NS - 1 ahead fills.
      cp_async_wait<NS - 2>();
      __syncthreads();
      copy_next();
      cp_async_commit();
    } else {
      // The stage written here was last read two chunks ago, before the
      // previous chunk's barrier.
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int v = tid + i * kThreads;
        *reinterpret_cast<uint4*>(st + staged(v / kPacks, v % kPacks)) = held[i];
      }
      __syncthreads();
      load_next();  // in flight during the products
    }
    return st;
  };

  if constexpr (CP != 0) {
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      copy_next();
      cp_async_commit();
    }
  } else {
    load_next();
  }
  if constexpr (RESIDENT) {
    // The queries' chunks into the resident rows, each thread the packs it
    // copied; the next barrier publishes them.
    for (int c = 0; c < n_chunks; ++c) {
      const uint16_t* st = next_stage();
#pragma unroll
      for (int i = 0; i < kQPackLoads; ++i) {
        const int v = tid + i * kThreads, r = v / kPacks, p = v % kPacks;
        *reinterpret_cast<uint4*>(slab + r * q_stride + c * kRowLanes + p * 8) =
            *reinterpret_cast<const uint4*>(st + staged(r, p));
      }
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    // SCALED: the inverse norms of this thread's docs of the tile, in
    // flight during the products.
    float inv[SCALED ? kWN : 1][2];
    if constexpr (SCALED) {
      const int d0 = (tile_begin + t) * kBD;
#pragma unroll
      for (int ni = 0; ni < kWN; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int d = d0 + wd + ni * 8 + 2 * (lane & 3) + j;
          inv[ni][j] = d < N ? __ldg(inv_norm + d) : 0.f;
        }
    }
    Acc acc[kWM][kWN][4];
#pragma unroll
    for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
      for (int ni = 0; ni < kWN; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);
    for (int c = 0; c < n_chunks; ++c) {
      const uint16_t* st = next_stage();
      const uint16_t* ds = RESIDENT ? st : st + kBQ * kRowLanes;
      // The chunk's products go onto sum: acc, or (kFold) part, which
      // starts from zero and is folded into acc after the chunk.
      Acc part[kWM][kWN][4];
      Acc(&sum)[kWM][kWN][4] = Op::kFold ? part : acc;
      if constexpr (Op::kFold) {
#pragma unroll
        for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
          for (int ni = 0; ni < kWN; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mi][ni][e] = Acc(0);
      }
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        unsigned a[kWM][Op::kARegs], b[kWN][Op::kBRegs];
#pragma unroll
        for (int mi = 0; mi < kWM; ++mi) {
          const int r = wq + mi * 16 + (lane & 15), u = 2 * ks + (lane >> 4);
          ldmatrix_x4(a[mi], smem_addr(RESIDENT ? slab + r * q_stride + c * kRowLanes + u * 8
                                                : st + staged(r, u)));
          Op::split_a(a[mi]);
        }
#pragma unroll
        for (int nj = 0; nj < kWN; nj += 2) {
          unsigned r[4];
          ldmatrix_x4(r, smem_addr(ds + staged(wd + nj * 8 + (lane >> 4) * 8 + (lane & 7),
                                               2 * ks + ((lane >> 3) & 1))));
          b[nj][0] = r[0];
          b[nj][1] = r[1];
          b[nj + 1][0] = r[2];
          b[nj + 1][1] = r[3];
          Op::split_b(b[nj]);
          Op::split_b(b[nj + 1]);
        }
#pragma unroll
        for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
          for (int ni = 0; ni < kWN; ++ni) Op::mma(sum[mi][ni], a[mi], b[ni]);
      }
      if constexpr (Op::kFold) {
#pragma unroll
        for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
          for (int ni = 0; ni < kWN; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
      }
    }

    // The tile is done (the next tile's first chunks are in flight):
    // acc[mi][ni][2 h + j] is query wq + 16 mi + 8 h + lane / 4 against doc
    // wd + 8 ni + 2 (lane % 4) + j of the tile.
    const int d0 = (tile_begin + t) * kBD;
#pragma unroll
    for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = q0 + wq + mi * 16 + h * 8 + (lane >> 2);
        if (qi >= B) continue;
        O* row = out + (size_t)qi * N;
#pragma unroll
        for (int ni = 0; ni < kWN; ++ni) {
          Acc v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
          if constexpr (SCALED) {
            v0 *= inv[ni][0];
            v1 *= inv[ni][1];
          }
          store_pair(row, d0 + wd + ni * 8 + 2 * (lane & 3), N, static_cast<O>(v0),
                     static_cast<O>(v1));
        }
      }
  }
}

// Launch `kernel` (an instance of a score_matmul_body kernel over product
// Op, with loader RESIDENT / NS) over the (B, N) output on `stream`, as
// kernel(args..., q_tiles, tiles_per_split): the query tiles of each split
// of the doc tiles adjacent (they read its tiles together: from device
// memory once, then from L2), as many splits as fill every SM's resident
// blocks once.  Returns the launch's error (a refused launch never runs, and
// a later synchronize does not report it).
template <class Op, bool RESIDENT, int NS, class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int B, int N, int n_chunks, cudaStream_t stream,
                   Args... args) {
  const size_t smem = smem_bytes<Op>(RESIDENT, NS, n_chunks);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int q_tiles = (B + kBQ - 1) / kBQ, d_tiles = (N + Op::kBD - 1) / Op::kBD;
  const int want = (sms + q_tiles - 1) / q_tiles;  // one block a SM
  const int splits = want < 1 ? 1 : (want < d_tiles ? want : d_tiles);
  const int per = (d_tiles + splits - 1) / splits;
  const long long blocks = (long long)q_tiles * ((d_tiles + per - 1) / per);  // no empty split
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(args..., q_tiles, per);
  return cudaGetLastError();
}

template <int C, bool R, int S> struct Loader {
  static constexpr int kCp = C;
  static constexpr bool kResident = R;
  static constexpr int kStages = S;
};

// Call go(Loader<CP, RESIDENT, NS>{}) for the loader of rows aligned to
// q_align and d_align bytes: the ring of 16- or 8-byte copies where both
// sides' rows allow it, else registers; the queries resident where their
// n_chunks chunks fit beside the ring, else streamed beside the docs.
template <class Op, class Go>
cudaError_t by_loader(int q_align, int d_align, int n_chunks, Go&& go) {
  const int a = q_align < d_align ? q_align : d_align;
  const bool resident = smem_bytes<Op>(true, kRingStages, n_chunks) <= kMaxSmem;
  if (a >= 16)
    return resident ? go(Loader<16, true, kRingStages>{}) : go(Loader<16, false, kRingStages>{});
  if (a >= 8)
    return resident ? go(Loader<8, true, kRingStages>{}) : go(Loader<8, false, kRingStages>{});
  return go(Loader<0, false, kRegStages>{});
}

}  // namespace
