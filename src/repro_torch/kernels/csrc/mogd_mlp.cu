// Fused surrogate-MLP forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/mogd_mlp.py
// (:33), launched at :63 by `_forward` behind `mlp_forward_fused` (:107).
// For x (B, D_in) and a ReLU MLP with a linear head (weights w_l (d_l,
// d_{l+1}) and biases b_l (d_{l+1},), any depth >= 1, any widths) it writes
//
//     h_0 = x,  h_{l+1} = relu(h_l w_l + b_l)  (hidden),  out = h_L  (head)
//
// as (B, D_out) fp32.  The backward pass (the reference's `_fused_bwd`,
// :83, plain jnp there) stays in PyTorch: `kernels/mogd_mlp.py`.
//
// What bounds it.  The work is 2*B*sum(d_l*d_{l+1}) fp32 FLOPs against
// (B*(D_in + D_out) + sum(d_l*d_{l+1} + d_{l+1}))*4 bytes.  At the paper's
// shape (13 -> 128 x 4 -> 1, 50,944 weights) and B = 4096 that is 417 MFLOP
// and 0.44 MB: bound by the fp32 FMA rate of the SMs (67 TFLOP/s outside
// the tensor cores on an H100 SXM), about 6 us.  On the model-server path
// the batches are tens to a few thousand rows, and a launch is bound by its
// latency instead.
//
// Design.  The TPU kernel keeps every weight and the running activation in
// VMEM.  At the paper's shape the weights alone are 204 KB, nearly all of
// the 227 KB of shared memory a block may use, so that does not carry over.
// Here one block owns a tile of T rows (T in {64, 32, 16, 8}, chosen by the
// wrapper): the tile's activations stay in shared memory, ping-ponged
// between two (T, S) buffers (S = the widest layer input, rounded up to a
// multiple of 4 floats), and each layer's weights stream through a third
// buffer in chunks of whole columns (all K input rows of NC columns), so
// every output element is finished inside one chunk and no partial sum
// lives across chunks.  The chunk is staged with asynchronous copies
// (cp.async, global to shared memory without a register round trip), so a
// thread has all of its copies in flight at once instead of waiting out an
// L2 round trip per float.  A thread owns a micro-tile of RM = 8 rows x
// RN = 4 columns: each activation read (a float4 of 4 inputs, broadcast to the
// warp) feeds 16 FMAs and each weight read 8.  Bias and ReLU are fused into
// the epilogue; the head writes straight to global memory.  Bound checks on
// the ragged last tile (rows past B are zeros in shared memory and are
// never stored) replace the reference's zero padding to 256 rows.
//
// Precision.  Products are explicit fmaf in input order k = 0..K-1 from 0,
// then + bias, then ReLU (NaN kept, as torch.relu keeps it); no TF32, no
// fast math, compiled with -fmad=false like the other kernels.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRM = 8;  // rows of a thread's micro-tile
constexpr int kRN = 4;  // columns of a thread's micro-tile
constexpr int kMaxLayers = 32;

// 4-byte asynchronous copy from global to shared memory (sm_80 and later);
// complete with cp_async_wait_all() before the block reads the buffer.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

struct Net {
  int n_layers;
  int dims[kMaxLayers + 1];
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
};

__global__ void __launch_bounds__(kThreads)
mlp_forward_kernel(const float* __restrict__ x, int B, Net net, int T, int S,
                   int wc, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* cur = smem;
  float* nxt = smem + T * S;
  float* wbuf = smem + 2 * T * S;
  const long long row0 = (long long)blockIdx.x * T;
  const int din = net.dims[0];
  for (int e = threadIdx.x; e < T * din; e += blockDim.x) {
    const int r = e / din, d = e - r * din;
    const long long gr = row0 + r;
    cur[r * S + d] = gr < B ? x[gr * din + d] : 0.0f;
  }
  const int groups = T / kRM;
  for (int l = 0; l < net.n_layers; ++l) {
    const int K = net.dims[l], N = net.dims[l + 1];
    const bool head = l == net.n_layers - 1;
    const float* __restrict__ W = net.w[l];
    const float* __restrict__ bias = net.b[l];
    int NC = wc / K;
    if (NC > N) NC = N;
    for (int n0 = 0; n0 < N; n0 += NC) {
      const int nc = NC < N - n0 ? NC : N - n0;
      // the previous chunk's (or layer's) readers and writers are done
      __syncthreads();
      for (int k = 0; k < K; ++k) {
        const float* row = W + (long long)k * N + n0;
        for (int j = threadIdx.x; j < nc; j += blockDim.x)
          cp_async4(wbuf + k * nc + j, row + j);
      }
      cp_async_wait_all();
      __syncthreads();
      const int cw = (nc + kRN - 1) / kRN;  // columns j, j+cw, j+2cw, j+3cw
      for (int it = threadIdx.x; it < groups * cw; it += blockDim.x) {
        const int g = it / cw, j = it - g * cw;
        const float* a = cur + g * kRM * S;
        float acc[kRM][kRN];
#pragma unroll
        for (int m = 0; m < kRM; ++m)
#pragma unroll
          for (int q = 0; q < kRN; ++q) acc[m][q] = 0.0f;
        int k = 0;
        for (; k + 4 <= K; k += 4) {
          float w[4][kRN];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int q = 0; q < kRN; ++q) {
              const int c = j + q * cw;
              w[u][q] = c < nc ? wbuf[(k + u) * nc + c] : 0.0f;
            }
#pragma unroll
          for (int m = 0; m < kRM; ++m) {
            const float4 av = *reinterpret_cast<const float4*>(a + m * S + k);
#pragma unroll
            for (int q = 0; q < kRN; ++q) {
              float s = acc[m][q];
              s = fmaf(av.x, w[0][q], s);
              s = fmaf(av.y, w[1][q], s);
              s = fmaf(av.z, w[2][q], s);
              s = fmaf(av.w, w[3][q], s);
              acc[m][q] = s;
            }
          }
        }
        for (; k < K; ++k) {
          float w[kRN];
#pragma unroll
          for (int q = 0; q < kRN; ++q) {
            const int c = j + q * cw;
            w[q] = c < nc ? wbuf[k * nc + c] : 0.0f;
          }
#pragma unroll
          for (int m = 0; m < kRM; ++m) {
            const float av = a[m * S + k];
#pragma unroll
            for (int q = 0; q < kRN; ++q) acc[m][q] = fmaf(av, w[q], acc[m][q]);
          }
        }
#pragma unroll
        for (int q = 0; q < kRN; ++q) {
          const int c = j + q * cw;
          if (c >= nc) continue;
          const float bc = __ldg(bias + n0 + c);
#pragma unroll
          for (int m = 0; m < kRM; ++m) {
            const float v = acc[m][q] + bc;
            const int r = g * kRM + m;
            if (!head) {
              nxt[r * S + n0 + c] = v < 0.0f ? 0.0f : v;
            } else if (row0 + r < B) {
              out[(row0 + r) * N + n0 + c] = v;
            }
          }
        }
      }
    }
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

}  // namespace

// x (B, dims[0]) and out (B, dims[n_layers]) fp32 row-major on the device;
// dims and the pointer arrays ws/bs are host arrays of n_layers + 1 ints and
// n_layers device pointers (w_l (dims[l], dims[l+1]), b_l (dims[l+1],), fp32,
// contiguous).  tile_rows is a multiple of 8, stride a multiple of 4 that is
// at least every hidden width and dims[0], wc (floats of the weight buffer)
// at least every dims[l] < n_layers, smem = (2*tile_rows*stride + wc)*4
// bytes; the wrapper checks all of it.  Returns the CUDA error of the launch
// (0 on success).
extern "C" int mlp_forward(const float* x, int B, int n_layers,
                           const int* dims, const void* const* ws,
                           const void* const* bs, int tile_rows, int stride,
                           int wc, int smem, float* out, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || B < 1 || tile_rows % kRM)
    return (int)cudaErrorInvalidValue;
  Net net;
  net.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) net.dims[l] = dims[l];
  for (int l = 0; l < n_layers; ++l) {
    net.w[l] = static_cast<const float*>(ws[l]);
    net.b[l] = static_cast<const float*>(bs[l]);
  }
  cudaError_t err = cudaFuncSetAttribute(
      mlp_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + tile_rows - 1) / tile_rows;
  mlp_forward_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, B, net, tile_rows, stride, wc, out);
  return (int)cudaGetLastError();
}
