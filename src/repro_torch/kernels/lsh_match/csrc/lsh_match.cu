// Dense MinHash collision counts for Hopper (sm_90a), CUDA C++ with a plain C
// interface (bound with ctypes by ../kernel.py).
//
// Replaces the TPU kernel repro/kernels/lsh_match/kernel.py::
// lsh_match_scores (def 41, pallas_call 64): scores[b, n] = #{s : sig_q[b, s]
// == sig_d[n, s] != 0xFFFFFFFF}, (B, N) int32.  The TPU kernel pads the
// signature axis with the sentinel on the query side and sentinel - 1 on the
// document side so that padding never matches; this kernel bounds-checks
// instead: a column past S is read as the sentinel on the query side and
// never counts, and rows past B or N are never written.
//
// Bound on an H100 SXM at the lexical-LSH cell (B = 256, N = 2,999,808,
// S = 300): 2.3e11 compare-and-counts at 16.7e12 INT32 op/s (64 INT32 lanes
// per SM x 132 SMs x 1.98 GHz), 13.8 ms, above the 1.99 ms of its bytes
// (3.60 GB of signatures, 3.07 GB of counts): operations bound it.  Each
// compare is an integer equality and add on CUDA cores; no tensor-core path
// exists for it.  The tile is ../../csrc/dense_scores.cuh.

#include "dense_scores.cuh"

extern "C" {

int lsh_match_scores_launch(const void* sig_q, const void* sig_d, void* out, int B, int N, int S,
                            int q_align, int d_align, void* stream) {
  return launch_dense_scores<kLSH>(sig_q, sig_d, out, B, N, S, q_align, d_align,
                                   static_cast<cudaStream_t>(stream));
}

const char* lsh_match_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
