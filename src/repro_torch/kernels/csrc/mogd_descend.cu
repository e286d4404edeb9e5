// Fused multi-start projected-Adam MOGD descent for Hopper (sm_90a).
//
// Replaces the Pallas kernel built by `_make_kernel` in
// src/repro/kernels/mogd_descend.py (:239), launched at :303 by
// `_descend_pallas` (:274) behind `descend_batch` (:319).  For every row of a
// grouped batch (G groups x Mp rows, rows of a group share one surrogate) it
// runs `steps` iterations of: the forward pass of each objective's ReLU MLP
// (standardization affine already folded into the first and last layers), the
// scalar dL/df of the paper's Eq. 4 loss plus the user-bound penalty
// (`_dloss_df`, :137-156), the chain back through the transposed layers with
// the ReLU masks (`_grad_rows`, :159-195), the isfinite guard, and the
// projected Adam update with cosine learning-rate decay (`_adam_update`,
// :198-209, t 1-based).  It writes only the final points.
//
// What bounds it.  The work is G*Mp*steps*k*4*sum(d_l*d_{l+1}) fp32 FLOPs
// (forward and input-gradient products, 2 FLOPs per multiply-add each),
// against bytes that are tiny by comparison: the kernel is bound by the fp32
// FMA rate of the SMs (67 TFLOP/s outside the tensor cores on an H100 SXM),
// provided the weights are fed from on-chip memory.
//
// Shared-memory budget and design.  The TPU kernel keeps every objective's
// weights in VMEM for all steps.  At the paper's width (D = 13, hidden
// (128,)*4, k = 2) the folded weights of one group are about 2 x 51k fp32 =
// 400 KB, more than the 227 KB of shared memory a block may use, so that
// design does not carry over.  Here each layer's weights are streamed per
// step from L2 through the read-only data path (__ldg): one group's weights
// are far below the 50 MB L2 and stay resident there and, layer by layer, in
// L1.  What the block keeps in shared memory is the row tile's state: the
// point x, Adam's m and v, the gradient accumulator, the row constants, the
// post-ReLU activations of every hidden layer (they are the backward pass's
// masks) and two ping-pong buffers for the backward vector.
//
// Work split.  A block is 4 warps over BM = 4*TR rows; warp w owns rows
// [w*TR, (w+1)*TR) for the whole descent, so every dependency is inside a
// warp and only __syncwarp() is needed between layers.  In a layer product a
// lane owns output columns lane, lane+32, lane+64, lane+96 of a 128-column
// chunk and all TR rows of its warp: each weight load feeds TR FMAs and each
// activation (a shared-memory broadcast) feeds 4.  The backward product
// reads the transposed weights (laid out by the wrapper), so its loads are
// coalesced like the forward's.  Products use explicit fmaf in input order;
// everything else is compiled with -fmad=false and no fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kColsPerLane = 4;
constexpr int kChunk = 32 * kColsPerLane;
constexpr int kMaxObj = 8;
constexpr int kMaxLayers = 8;

struct LayerDesc {
  int din, dout;
  long long w, b, wt;  // float offsets into one group's weight block
};

// Mirrors the ctypes structure the Python wrapper fills in.
struct Plan {
  int k;
  int n_layers[kMaxObj];
  int log_target[kMaxObj];
  float sign[kMaxObj];
  LayerDesc layer[kMaxObj][kMaxLayers];
};

struct Hyper {
  int steps, D, H, n_acts;  // H: row stride of the activation buffers
  float lr, lr_floor, cos_coef, b1, omb1, b2, omb2, eps, tie2;
};

enum Epilogue { kRelu = 0, kStore = 1, kMasked = 2, kAccumulate = 3 };

// out[r, c] = epilogue(sum_i in[r, i] * W[i, c] (+ bias[c])) for the TR
// rows of the calling warp.  W is (n_in, n_out) row-major in global memory.
template <int TR, int EPI>
__device__ __forceinline__ void dense(const float* in, int ld_in, int n_in,
                                      const float* __restrict__ W,
                                      const float* __restrict__ bias,
                                      int n_out, float* out, int ld_out,
                                      const float* mask, int ld_mask) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * TR;
  for (int c0 = 0; c0 < n_out; c0 += kChunk) {
    float acc[TR][kColsPerLane];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[r][j] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < n_in; ++i) {
      float w[kColsPerLane];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int c = c0 + lane + 32 * j;
        w[j] = c < n_out ? __ldg(W + (size_t)i * n_out + c) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float h = in[(r0 + r) * ld_in + i];
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j)
          acc[r][j] = fmaf(h, w[j], acc[r][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c >= n_out) continue;
      const float bc = bias != nullptr ? __ldg(bias + c) : 0.0f;
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        float v = acc[r][j];
        if (bias != nullptr) v = v + bc;
        float* o = out + (r0 + r) * ld_out + c;
        if (EPI == kRelu) {
          *o = v < 0.0f ? 0.0f : v;  // jnp.maximum(a, 0): NaN stays NaN
        } else if (EPI == kStore) {
          *o = v;
        } else if (EPI == kMasked) {
          *o = v * (mask[(r0 + r) * ld_mask + c] > 0.0f ? 1.0f : 0.0f);
        } else {
          *o = *o + v;
        }
      }
    }
  }
}

// dL/df for one objective of one row (`_dloss_df`).
__device__ __forceinline__ float dloss_df(float f, float lo, float hi,
                                          float ulo, float uhi, float us,
                                          float tsel, float tie2) {
  const float width = fmaxf(hi - lo, 1e-12f);
  const float fhat = (f - lo) / width;
  const bool violated = (fhat < 0.0f) || (fhat > 1.0f);
  float d = tsel * (violated ? 0.0f : 2.0f * fhat);
  d = d + (violated ? 2.0f * (fhat - 0.5f) : 0.0f);
  const float cl = fminf(fmaxf(fhat, 0.0f), 1.0f);
  d = d + (violated ? 0.0f : tie2 * cl);
  d = d / width;
  const float over = f - uhi;
  const float under = ulo - f;
  const float excess = fmaxf(under, 0.0f) + fmaxf(over, 0.0f);
  const float bsign = over > 0.0f ? 1.0f : (under > 0.0f ? -1.0f : 0.0f);
  return d + (excess > 0.0f ? 2.0f * excess / (us * us) * bsign : 0.0f);
}

template <int TR>
__global__ void __launch_bounds__(kThreads)
mogd_descend_kernel(const float* __restrict__ x0, const float* __restrict__ lo,
                    const float* __restrict__ hi, const float* __restrict__ ulo,
                    const float* __restrict__ uhi, const float* __restrict__ us,
                    const float* __restrict__ tsel,
                    const float* __restrict__ weights, long long group_stride,
                    const Plan plan, const Hyper hp, int Mp,
                    float* __restrict__ out) {
  constexpr int BM = kWarps * TR;
  extern __shared__ float smem[];
  const int D = hp.D, k = plan.k, H = hp.H;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * TR;
  float* xs = smem;             // (BM, D) current point
  float* ms = xs + BM * D;      // (BM, D) Adam first moment
  float* vs = ms + BM * D;      // (BM, D) Adam second moment
  float* dxs = vs + BM * D;     // (BM, D) dL/dx accumulator
  float* cst = dxs + BM * D;    // 6 x (BM, k) row constants
  float* raw = cst + 6 * BM * k;  // (BM,) last-layer output
  float* acts = raw + BM;       // n_acts x (BM, H) post-ReLU activations
  float* gb0 = acts + (size_t)hp.n_acts * BM * H;  // (BM, H)
  float* gb1 = gb0 + BM * H;                        // (BM, H)

  const size_t row0 = (size_t)blockIdx.y * Mp + (size_t)blockIdx.x * BM;
  const float* wg = weights + (size_t)blockIdx.y * group_stride;

  // each warp loads, updates and stores only its own TR rows
  for (int e = lane; e < TR * D; e += 32) {
    const int r = r0 + e / D, d = e % D;
    xs[r * D + d] = x0[(row0 + r) * D + d];
    ms[r * D + d] = 0.0f;
    vs[r * D + d] = 0.0f;
  }
  const float* src[6] = {lo, hi, ulo, uhi, us, tsel};
  for (int e = lane; e < TR * k; e += 32) {
    const int r = r0 + e / k, j = e % k;
#pragma unroll
    for (int q = 0; q < 6; ++q)
      cst[q * BM * k + r * k + j] = src[q][(row0 + r) * k + j];
  }
  __syncwarp();

  for (int step = 0; step < hp.steps; ++step) {
    const float t = (float)step + 1.0f;
    for (int e = lane; e < TR * D; e += 32) dxs[(r0 + e / D) * D + e % D] = 0.0f;
    __syncwarp();
    for (int j = 0; j < k; ++j) {
      const int L = plan.n_layers[j];
      // forward: hidden layers keep their post-ReLU outputs (the masks)
      const float* in = xs;
      int ld_in = D;
      for (int l = 0; l < L - 1; ++l) {
        const LayerDesc& ly = plan.layer[j][l];
        float* a = acts + (size_t)l * BM * H;
        dense<TR, kRelu>(in, ld_in, ly.din, wg + ly.w, wg + ly.b, ly.dout, a,
                         H, nullptr, 0);
        __syncwarp();
        in = a;
        ld_in = H;
      }
      {
        const LayerDesc& ly = plan.layer[j][L - 1];
        dense<TR, kStore>(in, ld_in, ly.din, wg + ly.w, wg + ly.b, 1, raw, 1,
                          nullptr, 0);
        __syncwarp();
      }
      // the scalar dL/draw of each row
      if (lane < TR) {
        const int r = r0 + lane;
        const float s = plan.sign[j];
        const float rv = raw[r];
        float f, dfdraw;
        if (plan.log_target[j]) {
          const float ex = expf(rv);
          f = s * ex;
          dfdraw = s * ex;
        } else {
          f = s * rv;
          dfdraw = s;
        }
        const int c = r * k + j;
        const float dl = dloss_df(f, cst[c], cst[BM * k + c],
                                  cst[2 * BM * k + c], cst[3 * BM * k + c],
                                  cst[4 * BM * k + c], cst[5 * BM * k + c],
                                  hp.tie2);
        gb0[r * H] = dl * dfdraw;
      }
      __syncwarp();
      // backward: g <- (g @ W^T) * (act > 0), down to dL/dx
      float* gin = gb0;
      float* gout = gb1;
      for (int l = L - 1; l >= 0; --l) {
        const LayerDesc& ly = plan.layer[j][l];
        if (l > 0) {
          dense<TR, kMasked>(gin, H, ly.dout, wg + ly.wt, nullptr, ly.din,
                             gout, H, acts + (size_t)(l - 1) * BM * H, H);
          float* tmp = gin;
          gin = gout;
          gout = tmp;
        } else {
          dense<TR, kAccumulate>(gin, H, ly.dout, wg + ly.wt, nullptr, ly.din,
                                 dxs, D, nullptr, 0);
        }
        __syncwarp();
      }
    }
    // projected Adam with cosine decay (t is 1-based)
    const float bc1 = 1.0f - powf(hp.b1, t);
    const float bc2 = 1.0f - powf(hp.b2, t);
    const float frac = (t - 1.0f) / (float)hp.steps;
    const float lr_t =
        hp.lr * (hp.lr_floor +
                 hp.cos_coef * (1.0f + cosf(3.14159265358979323846f * frac)));
    for (int e = lane; e < TR * D; e += 32) {
      const int idx = (r0 + e / D) * D + e % D;
      float g = dxs[idx];
      g = isfinite(g) ? g : 0.0f;
      const float m = hp.b1 * ms[idx] + hp.omb1 * g;
      const float v = hp.b2 * vs[idx] + hp.omb2 * g * g;
      ms[idx] = m;
      vs[idx] = v;
      const float mh = m / bc1;
      const float vh = v / bc2;
      const float x = xs[idx] - lr_t * mh / (sqrtf(vh) + hp.eps);
      xs[idx] = fminf(fmaxf(x, 0.0f), 1.0f);
    }
    __syncwarp();
  }

  for (int e = lane; e < TR * D; e += 32) {
    const int r = r0 + e / D, d = e % D;
    out[(row0 + r) * D + d] = xs[r * D + d];
  }
}

template <int TR>
cudaError_t launch(const float* x0, const float* lo, const float* hi,
                   const float* ulo, const float* uhi, const float* us,
                   const float* tsel, const float* weights,
                   long long group_stride, const Plan& plan, const Hyper& hp,
                   int G, int Mp, int smem, float* out, cudaStream_t stream) {
  constexpr int BM = kWarps * TR;
  cudaError_t err = cudaFuncSetAttribute(
      mogd_descend_kernel<TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Mp / BM, G);
  mogd_descend_kernel<TR><<<grid, kThreads, smem, stream>>>(
      x0, lo, hi, ulo, uhi, us, tsel, weights, group_stride, plan, hp, Mp,
      out);
  return cudaGetLastError();
}

}  // namespace

// sizeof(Plan), so the wrapper can check its ctypes mirror.
extern "C" int mogd_plan_bytes() { return (int)sizeof(Plan); }

// x0 (G, Mp, D); lo/hi/ulo/uhi/us/tsel (G, Mp, k); weights (G, group_stride)
// packed per the plan; out (G, Mp, D).  Mp is a multiple of the block rows
// (4 * TR for TR in {2, 4, 8}); every pointer is fp32 on the device.  Returns
// the CUDA error of the launch (0 on success).
extern "C" int mogd_descend(const float* x0, const float* lo, const float* hi,
                            const float* ulo, const float* uhi,
                            const float* us, const float* tsel,
                            const float* weights, long long group_stride,
                            const void* plan_ptr, int G, int Mp, int D,
                            int block_rows, int steps, float lr,
                            float lr_floor, float cos_coef, float b1,
                            float omb1, float b2, float omb2, float eps,
                            float tie2, int smem, float* out, void* stream) {
  const Plan& plan = *static_cast<const Plan*>(plan_ptr);
  int H = 1, n_acts = 0;
  for (int j = 0; j < plan.k; ++j) {
    const int L = plan.n_layers[j];
    if (L - 1 > n_acts) n_acts = L - 1;
    for (int l = 0; l < L - 1; ++l)
      if (plan.layer[j][l].dout > H) H = plan.layer[j][l].dout;
  }
  Hyper hp;
  hp.steps = steps;
  hp.D = D;
  hp.H = H;
  hp.n_acts = n_acts;
  hp.lr = lr;
  hp.lr_floor = lr_floor;
  hp.cos_coef = cos_coef;
  hp.b1 = b1;
  hp.omb1 = omb1;
  hp.b2 = b2;
  hp.omb2 = omb2;
  hp.eps = eps;
  hp.tie2 = tie2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_rows) {
    case 8:
      return (int)launch<2>(x0, lo, hi, ulo, uhi, us, tsel, weights,
                            group_stride, plan, hp, G, Mp, smem, out, s);
    case 16:
      return (int)launch<4>(x0, lo, hi, ulo, uhi, us, tsel, weights,
                            group_stride, plan, hp, G, Mp, smem, out, s);
    case 32:
      return (int)launch<8>(x0, lo, hi, ulo, uhi, us, tsel, weights,
                            group_stride, plan, hp, G, Mp, smem, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
