// The score operands shared by the streaming kernels: the fused top-k pass 1
// (K1-K3, ../fused_topk/csrc/fused_topk.cu; K3's lsh mode counts with mac)
// and the register loader of K6 and K7's tensor-core tile (load_pack,
// score_matmul.cuh).  K2 and K8 count collisions with lsh_count.cuh, which
// takes kBK from here.  A score is a sum over the T columns
// of a query row and a stored row in one of four modes: f32, bf16 (widened
// to f32: the products are exact), int8 (four to a 32-bit word, summed in
// int32 by __dp4a) and lsh (uint32 MinHash slots that are equal and not the query's
// sentinel 0xFFFFFFFF).  Rows are read as 16-byte packs and staged in shared
// memory as 32-bit words, kBK words per reduce chunk.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;          // shared-memory words per reduce chunk
constexpr int kSkew = kBK + 1;   // doc row stride in words: conflict-free column reads
constexpr uint32_t kLshSentinel = 0xFFFFFFFFu;

enum Mode { kF32 = 0, kBF16 = 1, kI8 = 2, kLSH = 3 };

// Raw: element type in device memory; Word: 32-bit shared-memory word;
// kPerWord: elements per word.
template <int M> struct Traits;
template <> struct Traits<kF32> {
  using Raw = float; using Word = float; using Acc = float;
  static constexpr int kPerWord = 1;
};
template <> struct Traits<kBF16> {
  using Raw = uint16_t; using Word = float; using Acc = float;
  static constexpr int kPerWord = 1;
};
template <> struct Traits<kI8> {
  using Raw = int8_t; using Word = int; using Acc = int;
  static constexpr int kPerWord = 4;
};
template <> struct Traits<kLSH> {
  using Raw = uint32_t; using Word = uint32_t; using Acc = int;
  static constexpr int kPerWord = 1;
};

template <int M> struct Vec {
  using Raw = typename Traits<M>::Raw;
  static constexpr int kElems = 16 / sizeof(Raw);              // elements per 16-byte pack
  static constexpr int kWords = kElems / Traits<M>::kPerWord;  // shared words a pack fills
  static constexpr int kPerRow = kBK / kWords;                 // packs per row and chunk
  union Pack { uint4 u; uint2 h[2]; Raw e[kElems]; };
};

// Padding that contributes nothing: 0 for products; on the lsh query side the
// sentinel (never counts).
template <int M> __device__ __forceinline__ typename Traits<M>::Raw pad_raw(bool query) {
  if constexpr (M == kLSH) return query ? kLshSentinel : 0u;
  else return typename Traits<M>::Raw(0);
}

// Elements [e0, e0 + kElems) of a row of `t` elements as one 16-byte pack,
// read as one 16-byte load, two 8-byte loads, or element by element
// (`align`: the byte alignment every row starts at, 16, 8 or 1); elements
// past the end, and rows that do not exist, are padding.  kHalves = false
// compiles the 8-byte branch out (rows 8- but not 16-byte aligned then take
// element loads): the fused top-k pass 1, whose rows are never read that
// way, keeps the registers it would cost.
template <int M, bool kHalves = true>
__device__ __forceinline__ uint4 load_pack(const typename Traits<M>::Raw* row, bool row_ok,
                                           int e0, int t, int align, bool query) {
  using V = Vec<M>;
  typename V::Pack p;
  if (row_ok && e0 + V::kElems <= t && align == 16) {
    p.u = *reinterpret_cast<const uint4*>(row + e0);
  } else if (kHalves && row_ok && e0 + V::kElems <= t && align == 8) {
    const uint2* r = reinterpret_cast<const uint2*>(row + e0);
    p.h[0] = r[0];
    p.h[1] = r[1];
  } else {
    const typename Traits<M>::Raw pad = pad_raw<M>(query);
#pragma unroll
    for (int s = 0; s < V::kElems; ++s) p.e[s] = (row_ok && e0 + s < t) ? row[e0 + s] : pad;
  }
  return p.u;
}

// A staged shared-memory word (bf16 is staged already widened to f32).
template <int M> __device__ __forceinline__ typename Traits<M>::Word from_bits(uint32_t b) {
  if constexpr (M == kF32 || M == kBF16) return __uint_as_float(b);
  else if constexpr (M == kI8) return static_cast<int>(b);
  else return b;
}

// Write a pack's kWords shared-memory words to dst[0], dst[stride], ...
template <int M>
__device__ __forceinline__ void store_pack(typename Traits<M>::Word* dst, int stride, uint4 raw) {
  using V = Vec<M>;
  typename V::Pack p;
  p.u = raw;
  if constexpr (M == kBF16) {
#pragma unroll
    for (int w = 0; w < V::kWords; ++w)  // bf16 is the top half of an f32: exact
      dst[w * stride] = __uint_as_float(static_cast<uint32_t>(p.e[w]) << 16);
  } else {
    dst[0] = from_bits<M>(raw.x);
    dst[stride] = from_bits<M>(raw.y);
    dst[2 * stride] = from_bits<M>(raw.z);
    dst[3 * stride] = from_bits<M>(raw.w);
  }
}

template <int M>
__device__ __forceinline__ typename Traits<M>::Acc mac(
    typename Traits<M>::Acc acc, typename Traits<M>::Word a, typename Traits<M>::Word b) {
  if constexpr (M == kI8) return __dp4a(a, b, acc);
  else if constexpr (M == kLSH) return acc + ((a == b) & (a != kLshSentinel));
  else return fmaf(a, b, acc);
}

}  // namespace
