// Cross-set Pareto dominator counts for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/pareto_filter.py
// (pallas_call at :69, entries cross_dominator_counts :44 and
// pareto_counts_blocked :84).  For each row i of FA (N, k) it counts the rows
// j of FB (M, k) that Pareto-dominate it: FB[j] <= FA[i] in every objective
// and < in at least one.  Comparisons are IEEE fp32, so a row of +inf
// dominates nothing (inf < x is never true) and NaN rows neither dominate nor
// are dominated, exactly as in the reference.
//
// Design.  The TPU kernel walks a (N/128, M/128) grid whose j axis runs in
// order and accumulates into the output block.  Blocks on a GPU run in no
// order, so the j axis becomes a loop inside the block: one thread owns one
// candidate row of FA, keeps it and its count in registers, and the block
// streams FB through shared memory in tiles of kTile rows.  Every thread of
// the block reads the same FB element at once (a broadcast), so the inner
// loop is k compares per pair with no bank conflicts and no cross-block
// reduction.
//
// Bound on this card.  N*M*k compares against (N+M)*k*4 + 4*N bytes: at the
// store's sizes (N, M up to a few thousand, k = 2..3) the work is tiny and
// the kernel is bound by its launch latency; at N = M = 4096 it is bound by
// the compares (integer/compare issue rate), never by memory.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 128;  // FB rows staged in shared memory at a time

// K > 0: k known at compile time (the candidate row lives in registers),
// for the store's k of 2 and 3.  K == 0: any other k; the candidate row is
// re-read from global memory (L1).
template <int K>
__global__ void __launch_bounds__(kThreads)
cross_dominator_counts_kernel(const float* __restrict__ FA,
                              const float* __restrict__ FB, int N, int M,
                              int k, int* __restrict__ out) {
  extern __shared__ float tile[];
  const int kk = K > 0 ? K : k;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < N;
  float a[K > 0 ? K : 1];
  if (K > 0) {
#pragma unroll
    for (int d = 0; d < (K > 0 ? K : 1); ++d)
      a[d] = valid ? FA[(size_t)i * K + d] : 0.0f;
  }
  int count = 0;
  for (int j0 = 0; j0 < M; j0 += kTile) {
    const int rows = min(kTile, M - j0);
    for (int e = threadIdx.x; e < rows * kk; e += kThreads)
      tile[e] = FB[(size_t)j0 * kk + e];
    __syncthreads();
    if (valid) {
      for (int j = 0; j < rows; ++j) {
        bool le = true, lt = false;
        if (K > 0) {
#pragma unroll
          for (int d = 0; d < (K > 0 ? K : 1); ++d) {
            const float b = tile[j * K + d];
            le = le && (b <= a[d]);
            lt = lt || (b < a[d]);
          }
        } else {
          for (int d = 0; d < kk; ++d) {
            const float b = tile[j * kk + d];
            const float av = FA[(size_t)i * kk + d];
            le = le && (b <= av);
            lt = lt || (b < av);
          }
        }
        count += (le && lt) ? 1 : 0;
      }
    }
    __syncthreads();
  }
  if (valid) out[i] = count;
}

template <int K>
cudaError_t launch(const float* FA, const float* FB, int N, int M, int k,
                   int* out, cudaStream_t stream) {
  const dim3 grid((N + kThreads - 1) / kThreads);
  const size_t smem = (size_t)kTile * k * sizeof(float);
  cross_dominator_counts_kernel<K>
      <<<grid, kThreads, smem, stream>>>(FA, FB, N, M, k, out);
  return cudaGetLastError();
}

}  // namespace

// FA (N, k), FB (M, k) fp32 row-major on the device; out (N,) int32.
// N, M >= 1 and 1 <= k <= kMaxK (the wrapper checks).  Returns the CUDA
// error of the launch (0 on success).
extern "C" int pareto_cross_dominator_counts(const float* FA, const float* FB,
                                             int N, int M, int k, int* out,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 2: return (int)launch<2>(FA, FB, N, M, k, out, s);
    case 3: return (int)launch<3>(FA, FB, N, M, k, out, s);
    default: return (int)launch<0>(FA, FB, N, M, k, out, s);
  }
}

// Text of a CUDA error code, for the wrappers' exceptions.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
