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
// What bounds it on this card.  N*M pairs of k compares against (N+M)*k*4 +
// 4*N bytes: never memory.  At the frontier store's calls (a batch of 4 to a
// few dozen rows against a live set of 64 to a few thousand, and back) the
// work is a few thousand pairs and the launch itself (~1.3 us on the device)
// is the floor; what the kernel must avoid there is walking the long side
// in series.  At N = M = 4096 (33.5 M compares) compare issue bounds it, and
// the card must be full.
//
// Design.  The first port gave each candidate row of FA one thread and
// walked FB in series through shared memory: at a store call, 4 live threads
// of one block walked 256 rows each (5 us), and at 4096 x 4096 the grid was
// 32 blocks on 132 SMs.  Here the long axis is spread over lanes instead,
// in one of two bodies (pareto_filter.layout picks):
//
// * Long FB (M > 32, or any k other than 2 and 3): a CTA owns R = 8
//   candidate rows, held in every thread's registers (generic k: in shared
//   memory).  Its threads (as many warps as FB's rows fill, up to 8) take
//   consecutive FB rows (one 8-byte load a row at k = 2, coalesced across
//   the warp), each keeping R counters; no barrier inside the compare loop.
//   A warp sums each counter with one __reduce_add_sync (lane r keeps
//   candidate r's), the warps' sums are added in shared memory in warp
//   order, and a CTA of one warp writes its own.
// * Short FB (M <= 32, k = 2 or 3): one lane a candidate row, FB's rows one
//   a lane in registers, broadcast in turn by __shfl_sync: the store's
//   batch against itself and its live rows against the kept batch.
//
// Integer counts: exact in any order of summation.  Trials on the H100
// (PERF.md) chose this over three variants: 32 candidate rows a CTA read
// 9.7 us against 8.2 at 4096 x 4096 and 1.8 against 1.4 at 256 x 4;
// splitting FB over the CTAs of a cluster, rank 0 adding the others' sums
// through distributed shared memory, read 13.1 against 9.6 (32-row tiles)
// at 4096 x 4096; the long body at the short shapes, counting by ballots,
// read 1.5-1.7 us against the first port's 1.3.
//
// The wrapper passes its layout (body, threads a CTA, grid, dynamic shared
// memory) in one packed struct, so the kernel covers FA and FB exactly as
// the layout that the CPU tests check says.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// The launch's arguments, packed by the wrapper (pareto_filter._pack) as 10
// int64: FA (N, k) and FB (M, k) fp32 row-major, out (N,) int32, all on the
// device; from pareto_filter.layout, short_fb (1: the short-FB body, for
// M <= 32 and k = 2 or 3), threads (32 to 256, a multiple of 32), grid and
// smem (bytes of dynamic shared memory: R x k floats for the generic-k
// body, else 0).  N, M >= 1 and 1 <= k <= 96 (the wrapper checks).
struct DomCall {
  long long FA, FB, out;
  long long N, M, k;
  long long short_fb, threads, grid, smem;
};

namespace {

constexpr int R = 8;  // candidate rows a CTA
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Whether FB row b dominates candidate a (all <= and any <).
template <int K>
__device__ __forceinline__ bool dominates(const float (&b)[K],
                                          const float (&a)[K]) {
  bool le = true, lt = false;
#pragma unroll
  for (int d = 0; d < K; ++d) {
    le = le && (b[d] <= a[d]);
    lt = lt || (b[d] < a[d]);
  }
  return le && lt;
}

// FB row j into b; an 8-byte load when k = 2 and FB is 8-byte aligned.
template <int K>
__device__ __forceinline__ void load_row(const float* __restrict__ F, int j,
                                         bool pair, float (&b)[K]) {
  if (K == 2 && pair) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(F) + j);
    b[0] = v.x;
    b[K - 1] = v.y;
  } else {
#pragma unroll
    for (int d = 0; d < K; ++d) b[d] = __ldg(F + (size_t)j * K + d);
  }
}

// Short FB (M <= 32, k = 2 or 3: a store's batch against itself, or the
// live rows against the kept batch): one lane a candidate row, FB's rows
// one a lane in registers and broadcast in turn by shuffles.  No shared
// memory, no barrier, no reduction.
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
dominator_counts_short(const float* __restrict__ FA,
                       const float* __restrict__ FB, int N, int M,
                       int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool pair_a = (reinterpret_cast<uintptr_t>(FA) & 7) == 0;
  const bool pair_b = (reinterpret_cast<uintptr_t>(FB) & 7) == 0;
  float a[K], b[K];
  load_row<K>(FA, min(i, N - 1), pair_a, a);  // padding lanes: any row
  load_row<K>(FB, min(lane, M - 1), pair_b, b);
  int cnt = 0;
  for (int j = 0; j < M; ++j) {
    float bj[K];
#pragma unroll
    for (int d = 0; d < K; ++d) bj[d] = __shfl_sync(kFull, b[d], j);
    cnt += dominates<K>(bj, a) ? 1 : 0;
  }
  if (i < N) out[i] = cnt;
}

// Long FB: a CTA a tile of R candidate rows, its threads over FB's rows.
// K > 0: k known at compile time (k = 2 and 3, the store's), candidates in
// registers.  K == 0: any k up to 96, candidates in shared memory and each
// FB row's verdicts on the R candidates kept as a bit mask while its k
// values pass.  Each thread keeps R counters over its rows and a warp sums
// each with one reduction.
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
dominator_counts_kernel(const float* __restrict__ FA,
                        const float* __restrict__ FB, int N, int M, int k,
                        int* __restrict__ out) {
  extern __shared__ float cand[];  // K == 0: R x k candidate values
  __shared__ int part[kMaxWarps][R];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int threads = blockDim.x;
  const int i0 = blockIdx.x * R;
  int cnt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) cnt[r] = 0;

  if constexpr (K > 0) {
    float a[R][K];
    const bool pair_a = (reinterpret_cast<uintptr_t>(FA) & 7) == 0;
    const bool pair_b = (reinterpret_cast<uintptr_t>(FB) & 7) == 0;
#pragma unroll
    for (int r = 0; r < R; ++r)  // padding rows: the last row
      load_row<K>(FA, min(i0 + r, N - 1), pair_a, a[r]);
    for (int j = tid; j < M; j += threads) {
      float b[K];
      load_row<K>(FB, j, pair_b, b);
#pragma unroll
      for (int r = 0; r < R; ++r) cnt[r] += dominates<K>(b, a[r]) ? 1 : 0;
    }
  } else {
    for (int e = tid; e < R * k; e += threads) {
      const int r = e / k;
      cand[e] = FA[(size_t)min(i0 + r, N - 1) * k + (e - r * k)];
    }
    __syncthreads();
    for (int j = tid; j < M; j += threads) {
      uint32_t le = ~0u, lt = 0u;  // bit r: candidate r's verdict so far
      for (int d = 0; d < k; ++d) {
        const float b = __ldg(FB + (size_t)j * k + d);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float av = cand[r * k + d];
          le &= ~((uint32_t)!(b <= av) << r);
          lt |= (uint32_t)(b < av) << r;
        }
      }
      const uint32_t dom = le & lt;
#pragma unroll
      for (int r = 0; r < R; ++r) cnt[r] += (dom >> r) & 1u;
    }
  }

  // the warp's sums, one reduction a candidate; lane r keeps candidate r's
  int mine = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int sum = __reduce_add_sync(kFull, cnt[r]);
    mine = lane == r ? sum : mine;
  }
  if (threads == 32) {  // one warp: no cross-warp sum
    if (lane < R && i0 + lane < N) out[i0 + lane] = mine;
    return;
  }
  if (lane < R) part[warp][lane] = mine;
  __syncthreads();
  if (tid < R && i0 + tid < N) {
    int sum = 0;
    for (int w = 0; w < (threads >> 5); ++w) sum += part[w][tid];
    out[i0 + tid] = sum;
  }
}

template <int K>
cudaError_t launch(const DomCall& c, cudaStream_t stream) {
  const float* FA = reinterpret_cast<const float*>(c.FA);
  const float* FB = reinterpret_cast<const float*>(c.FB);
  int* out = reinterpret_cast<int*>(c.out);
  const dim3 grid((unsigned)c.grid), block((unsigned)c.threads);
  if constexpr (K > 0) {
    if (c.short_fb) {
      dominator_counts_short<K>
          <<<grid, block, 0, stream>>>(FA, FB, (int)c.N, (int)c.M, out);
      return cudaGetLastError();
    }
  }
  dominator_counts_kernel<K><<<grid, block, (size_t)c.smem, stream>>>(
      FA, FB, (int)c.N, (int)c.M, (int)c.k, out);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).
extern "C" int pareto_cross_dominator_counts(const DomCall* c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c->k) {
    case 2: return (int)launch<2>(*c, s);
    case 3: return (int)launch<3>(*c, s);
    default: return (int)launch<0>(*c, s);
  }
}

// Text of a CUDA error code, for the wrappers' exceptions.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
