// Causal GQA flash attention (forward) for Hopper (sm_90a), CUDA C++ with a
// plain C interface (bound with ctypes by ../kernel.py).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (def 74, pallas_call 99): out = softmax(mask(q k^T /
// sqrt(D))) v for q (B, Hq, S, D) and k, v (B, Hkv, S, D), Hq % Hkv == 0;
// query head h reads KV head h / (Hq / Hkv) by index, with no copy of K or
// V.  As in the reference, the logits, the online-softmax statistics (row
// max m, row sum l) and both products are f32, masked logits are -1e30, and
// the output is acc / max(l, 1e-30) cast to the input dtype (f32 or bf16).
// There is no backward: the TPU kernel has none.
//
// Bound on an H100 SXM at deepseek-coder-33b's prefill_32k sequence (one
// layer: Hq 56, Hkv 8, D 128, S 32,768, bf16, B 1): the causal products are
// 4 * Hq * D * S (S + 1) / 2 = 1.54e13 operations, 15.6 ms at the bf16
// tensor-core rate (989 TFLOP/s), far above the 0.32 ms of its bytes
// (q, k, v and the output read or written once): operations bound it.  This
// first kernel computes in f32 on CUDA cores (67 TFLOP/s peak), as the
// reference's arithmetic is f32; tensor cores (wgmma, bf16 operands with
// f32 accumulation) are the step that could approach the bound.
//
// Design: one block of 256 threads per (query head, batch, 64-row query
// tile).  The grid's slowest axis is the query tile, walked from the last
// (the most KV tiles) to the first, so the heaviest blocks start first, and
// the query heads of one KV head are adjacent, so they share its tiles in
// L2.  The query tile sits in shared memory as f32; 32-key tiles
// of K and V stream through shared memory, and tiles wholly above the
// diagonal are never read.  Thread (ty, tx) of a 16 x 16 grid owns query
// rows 4 ty .. 4 ty + 3: it computes their logits against keys tx and tx + 16
// of the tile, keeps their running (m, l) (the 16 threads of a row reduce
// with shuffles) and their output columns tx + 16 c, c < D / 16, in
// registers.  The probabilities pass through shared memory to the P V
// product.  Rows of the query and key tiles are D + 1 words apart in shared
// memory, so the column reads of the logit product are free of bank
// conflicts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 32;       // keys per KV tile
constexpr int kRows = 4;      // query rows per thread
constexpr int kPStride = kBK + 1;
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t x) {  // bf16 bits: the top half of an f32
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, uint16_t* dst) {  // round to nearest even
  const uint32_t u = __float_as_uint(x);
  *dst = (x != x) ? uint16_t(0x7FC0) : uint16_t((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
                          (size_t)kBQ * kPStride);
}

// Rows [r0, r0 + n) of a head's (S, D) matrix into shared memory as f32,
// row stride `stride`; rows past S read as 0.
template <int D, typename T>
__device__ __forceinline__ void load_rows(float* dst, int stride, const T* __restrict__ src,
                                          int r0, int n, int S) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * stride + c] = r0 + r < S ? to_f32(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2) flash_attention_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Hq, int Hkv, int S, float scale) {
  constexpr int kDS = D + 1;
  constexpr int kCols = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;              // kBQ x kDS
  float* ks = qs + kBQ * kDS;    // kBK x kDS
  float* vs = ks + kBK * kDS;    // kBK x D
  float* ps = vs + kBK * D;      // kBQ x kPStride

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // the longest rows first
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (Hq / Hkv);
  const size_t q_head = ((size_t)b * Hq + h) * S * D;
  const size_t kv_head = ((size_t)b * Hkv + hk) * S * D;

  load_rows<D>(qs, kDS, q + q_head, q0, kBQ, S);

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int last_row = min(q0 + kBQ, S) - 1;
  const int n_tiles = last_row / kBK + 1;  // tiles wholly above the diagonal are skipped
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_rows<D>(ks, kDS, k + kv_head, k0, kBK, S);
    load_rows<D>(vs, D, v + kv_head, k0, kBK, S);
    __syncthreads();

    float s[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float b0 = ks[tx * kDS + d], b1 = ks[(tx + 16) * kDS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float a = qs[(kRows * ty + i) * kDS + d];
        s[i][0] = fmaf(a, b0, s[i][0]);
        s[i][1] = fmaf(a, b1, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + kRows * ty + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + tx + 16 * j;
        s[i][j] = (key <= row && key < S) ? scale * s[i][j] : kMasked;
      }
      float mx = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float p0 = expf(s[i][0] - m_new), p1 = expf(s[i][1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
      ps[(kRows * ty + i) * kPStride + tx] = p0;
      ps[(kRows * ty + i) * kPStride + tx + 16] = p1;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = ps[(kRows * ty + i) * kPStride + kk];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + kRows * ty + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + q_head + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) from_f32(acc[i][c] / denom, o + tx + 16 * c);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
                   int S, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_fwd<D, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, (S + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Hq, Hkv, S, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* out, int B, int Hq,
                     int Hkv, int S, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32, T>(q, k, v, out, B, Hq, Hkv, S, stream);
    case 64: return launch<64, T>(q, k, v, out, B, Hq, Hkv, S, stream);
    case 96: return launch<96, T>(q, k, v, out, B, Hq, Hkv, S, stream);
    case 128: return launch<128, T>(q, k, v, out, B, Hq, Hkv, S, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype 0: f32, 1: bf16.
int flash_attention_launch(int dtype, int D, const void* q, const void* k, const void* v,
                           void* out, int B, int Hq, int Hkv, int S, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || Hq % Hkv != 0 || B > 65535 ||
      (S + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(D, q, k, v, out, B, Hq, Hkv, S, s);
  if (dtype == 1) return launch_d<uint16_t>(D, q, k, v, out, B, Hq, Hkv, S, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
