// All-pairs frontier composition for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/compose.py
// (pallas_call at :44, entry pairwise_compose_blocked :59).  For FA (N, k)
// and FB (M, k) it writes C (N*M, k) in row-major order:
//
//     C[i*M + j, o] = FA[i, o] + FB[j, o]      where bit o of add_mask is set
//                   = max(FA[i, o], FB[j, o])  otherwise
//
// fp32 add and max are correctly rounded, so the result equals the plain
// PyTorch version bit for bit.  The max propagates NaN as torch.maximum and
// jnp.maximum do (CUDA's fmaxf would return the other operand).
//
// Design.  The TPU kernel tiles the (N, M) pair grid into (128, 128, k)
// VMEM blocks padded with +inf.  Here the output row segment of one FA row,
// C[i*M : (i+1)*M, :], is M*k contiguous floats, and its flat index t is
// also the flat index of FB[j, o] (FB is row-major (M, k)).  So a block of
// threads walks the segment with t: it reads FB[t] (coalesced), FA[i, t % k]
// (k floats of one row, broadcast from L1) and writes C at t (coalesced).
// blockIdx.y walks the FA rows (a grid-stride loop past 65535 rows), and
// bound checks replace the +inf padding.  Row offsets are 64-bit: N*M*k
// passes 2^31 at the sizes this kernel is timed at.
//
// Bound on this card.  It reads (N + M)*k*4 bytes and writes N*M*k*4, with
// one add or max per output float: it is bound by the writes (3.35 TB/s).
// On the DAG path each launch writes at most about 4096 rows and is bound
// by its launch latency instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float max_nan(float x, float y) {
  if (x != x) return x;
  if (y != y) return y;
  return x < y ? y : x;
}

// K > 0: k known at compile time (t % K is a shift or a multiply), for the
// (latency, cost) and three-objective cases; K == 0: any k.
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
pairwise_compose_kernel(const float* __restrict__ FA,
                        const float* __restrict__ FB, int N, int Mk, int k,
                        uint32_t add_mask, float* __restrict__ out) {
  const int kk = K > 0 ? K : k;
  for (int64_t i = blockIdx.y; i < N; i += gridDim.y) {
    const float* a = FA + i * kk;
    float* c = out + i * (int64_t)Mk;
    for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < Mk;
         t += gridDim.x * blockDim.x) {
      const int o = t % kk;
      const float x = a[o];
      const float y = FB[t];
      c[t] = ((add_mask >> o) & 1u) ? x + y : max_nan(x, y);
    }
  }
}

template <int K>
cudaError_t launch(const float* FA, const float* FB, int N, int M, int k,
                   uint32_t add_mask, float* out, cudaStream_t stream) {
  const int Mk = M * k;
  // one warp-rounded block per row segment when it is short (the DAG
  // path's M*k is tens to hundreds), else enough blocks to cover it
  const int threads = Mk >= kMaxThreads ? kMaxThreads : ((Mk + 31) / 32) * 32;
  const int bx = (Mk + threads - 1) / threads;
  const dim3 grid(bx < 65535 ? bx : 65535, N < 65535 ? N : 65535);
  pairwise_compose_kernel<K>
      <<<grid, threads, 0, stream>>>(FA, FB, N, Mk, k, add_mask, out);
  return cudaGetLastError();
}

}  // namespace

// FA (N, k), FB (M, k) fp32 row-major on the device; out (N*M, k) fp32.
// N, M >= 1, 1 <= k <= 32 and M*k < 2^31 (the wrapper checks); bit o of
// add_mask selects + for objective o, else max.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int pairwise_compose(const float* FA, const float* FB, int N,
                                int M, int k, unsigned int add_mask,
                                float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 2: return (int)launch<2>(FA, FB, N, M, k, add_mask, out, s);
    case 3: return (int)launch<3>(FA, FB, N, M, k, add_mask, out, s);
    default: return (int)launch<0>(FA, FB, N, M, k, add_mask, out, s);
  }
}
