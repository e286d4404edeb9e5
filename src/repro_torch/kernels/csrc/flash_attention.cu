// Causal (and non-causal) flash attention for Hopper (sm_90a), fp32 on the
// CUDA cores.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/flash_attention.py
// (:29, entry flash_attention_bhsd :71, pallas_call :83), and computes the
// contract of its oracle ref.flash_attention (src/repro/kernels/ref.py:111):
//
//     o[b, s, h] = softmax_k( q[b, s, h] . k[b, k, hk] * dh^-0.5 ) v[b, k, hk]
//
// over keys k <= s when causal, with hk = h / (H / Hk) (grouped-query
// attention mapped here instead of the repeat that ops.flash_attention makes
// upstream of the Pallas kernel).  q is (B, S, H, dh) and k/v are
// (B, S, Hk, dh), contiguous, in bf16 or fp32; o is (B, S, H, dh) in the
// input dtype.  Scores, the running max, the denominator and the accumulator
// are fp32.
//
// Design.  One block of 256 threads per (query tile of 64 rows, head, batch
// row); tiles run heaviest first (the last causal query tile has the most
// keys).  The block stages its query tile, then each visible 64-key tile of
// K and V, in shared memory as fp32 (rows padded by one float so the
// column-wise reads hit distinct banks).  Thread (ty, tx) of the 16 x 16
// grid owns query rows ty + 16 i (i < 4): it computes the 4 x 4 scores
// against keys tx + 16 j, reduces each row's max and sum over the 16 lanes
// that share the row (shuffles inside a half-warp), and keeps the row's
// running max, denominator and a 4 x dh/16 slice of the output accumulator
// (columns tx + 16 j) in registers — dh = 128 is split over 16 lanes, so no
// thread holds a whole row.  Key tiles above the causal diagonal are never
// loaded; bound checks on the sequence replace the Pallas kernel's
// S % block == 0, so any S runs.
//
// Bound on this card.  Causal attention does 2 B H S (S+1) dh flops (the
// two products over the visible half).  On the tensor cores (989 TFLOP/s
// bf16) that is 0.14 ms at B = 1, H = 32, S = 4096, dh = 128; this kernel
// runs its products as fp32 FMAs on the CUDA cores (67 TFLOP/s, 2.1 ms at
// that shape) and feeds them from shared memory (8 loads per 16 FMAs in the
// score product), so it sits well above either bound.  wgmma tiles fed by
// TMA are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <int DH>
constexpr int smem_floats() {
  return kBQ * (DH + 1) + kBK * (DH + 1) + kBK * DH + kBQ * (kBK + 1);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int Hk, float scale, int causal) {
  constexpr int QS = DH + 1;   // padded row stride of the Q and K tiles
  constexpr int PS = kBK + 1;  // padded row stride of the P tile
  constexpr int DJ = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Vs + kBK * DH;

  const int n_q = (S + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const long long q_row = (long long)H * DH;    // stride of s in q and o
  const long long kv_row = (long long)Hk * DH;  // stride of s in k and v
  const T* qb = q + (long long)b * S * q_row + (long long)h * DH;
  const T* kb = k + (long long)b * S * kv_row + (long long)hk * DH;
  const T* vb = v + (long long)b * S * kv_row + (long long)hk * DH;
  T* ob = o + (long long)b * S * q_row + (long long)h * DH;

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, d = e - (e / DH) * DH;
    const int s = q0 + r;
    Qs[r * QS + d] = s < S ? to_f(qb[(long long)s * q_row + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + kBQ) : S;
  const int n_kt = (kv_end + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's reads of Ks, Vs and Ps are done
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int r = e / DH, d = e - (e / DH) * DH;
      const int s = k0 + r;
      const bool in = s < S;
      Ks[r * QS + d] = in ? to_f(kb[(long long)s * kv_row + d]) : 0.f;
      Vs[r * DH + d] = in ? to_f(vb[(long long)s * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int r = q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool ok = c < S && (!causal || c <= r);
        sc[i][j] = ok ? sc[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every row sees key 0 in the first tile, so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = sc[i][j] == -INFINITY ? 0.f : expf(sc[i][j] - m_new);
        Ps[row * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();  // P is complete

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) vv[jj] = Vs[c * DH + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      ob[(long long)r * q_row + tx + 16 * jj] = from_f<T>(acc[i][jj] / l[i]);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int Hk, float scale, int causal,
                   cudaStream_t stream) {
  const int smem = smem_floats<DH>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hk, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int Hk, int dh, float scale,
                        int causal, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, Hk, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, Hk, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, Hk, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, Hk, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, S, H, dh), k/v: (B, S, Hk, dh), o: (B, S, H, dh), all contiguous,
// fp32 (bf16 == 0) or bf16 (bf16 == 1).  dh in {16, 32, 64, 128}; H % Hk ==
// 0; B, S >= 1; B, H <= 65535 (the wrapper checks).  scale multiplies the
// scores (dh^-0.5 for the model).  Returns the CUDA error of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int Hk, int dh, int bf16,
                                   float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)dispatch_dh<__nv_bfloat16>(q, k, v, o, B, S, H, Hk, dh, scale,
                                           causal, s);
  return (int)dispatch_dh<float>(q, k, v, o, B, S, H, Hk, dh, scale, causal,
                                 s);
}
