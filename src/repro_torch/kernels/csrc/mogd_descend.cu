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
// Two routes, chosen by the wrapper from the plan's shape
// (kernels/mogd_descend.py `descend_route`), each counted under its own key.
//
// Resident route (descend_resident; every plan whose weights fit a cluster's
// shared memory, the paper shape included).  The TPU kernel keeps every
// objective's weights in VMEM for all steps; one group's folded weights are
// about 2 x 51k fp32 = 400 KB at the paper's width (D = 13, hidden (128,)*4,
// k = 2), more than the 227 KB one block may use, so here a thread-block
// cluster of 2k CTAs holds them in its CTAs' shared memory together: CTA
// (j, h) holds objective j's weights for output columns h*n/2 .. (h+1)*n/2
// of every hidden layer (and the matching half of the last layer's input
// rows), about 104 KB at the paper shape, loaded from device memory once per
// launch.  The cluster covers BM rows (16, 32 or 64) of one group; a group's
// rows are split over more than one cluster when G is small, so the card
// fills.  Per step and objective the CTA pair exchanges activation halves
// through distributed shared memory: each CTA writes its half of a layer's
// output into its own buffer and its partner's (st to a mapa'd address), and
// one cluster barrier per layer publishes them (not after the last hidden
// layer: the last layer splits by input half, so each CTA reads only its
// own).  The backward reads the same
// resident W with the transposed access pattern (no second, transposed copy
// on chip): each CTA forms the partial input gradient over its half of the
// output columns, writes the partner's input half to the partner, and the two
// halves are added in a fixed order (half 0's first).  dL/dx is the sum of
// the 2k CTAs' partials in rank order, read by every CTA, and every CTA runs
// the same Adam update on its own copy of the rows, so they never diverge.
// ReLU masks are kept as bits (64 rows x 64 columns x 4 layers is 2 KB a
// CTA), not activations, each 32-row word OR-ed together by the lanes that
// own its rows (shuffles, no atomics).  8 warps a CTA; a thread owns a
// 4-row x 4-column register tile and each float4 shared-memory load of W
// feeds 16 FMAs (activations and gradients are stored column-major, rows
// contiguous).  Two 16-byte loads per 16 FMAs a warp keep the
// shared-memory pipe, not the FMA units, the limit of a 64 x 64 output
// tile: at most half the fp32 peak.
// Products use fmaf in input order; the split changes the order of
// summation in the backward and in the last layer (two halves added), which
// chip_smoke.py's descend checks allow.
//
// Streaming route (mogd_descend_kernel; a plan too wide for the cluster, or
// with more than 4 objectives, or objectives of unequal depth).  Each layer's
// weights are streamed per step from L2 through the read-only data path
// (__ldg): one group's weights are far below the 50 MB L2 and stay resident
// there and, layer by layer, in L1.  What the block keeps in shared memory is
// the row tile's state: the point x, Adam's m and v, the gradient
// accumulator, the row constants, the post-ReLU activations of every hidden
// layer (they are the backward pass's masks) and two ping-pong buffers for
// the backward vector.  A block is 4 warps over BM = 4*TR rows; warp w owns
// rows [w*TR, (w+1)*TR) for the whole descent, so every dependency is inside
// a warp and only __syncwarp() is needed between layers.  In a layer product
// a lane owns output columns lane, lane+32, lane+64, lane+96 of a 128-column
// chunk and all TR rows of its warp: each weight load feeds TR FMAs and each
// activation (a shared-memory broadcast) feeds 4.  The backward product reads
// the transposed weights (laid out by the wrapper), so its loads are
// coalesced like the forward's.  Products use explicit fmaf in input order;
// everything else is compiled with -fmad=false and no fast math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// Resident route: one cluster of 2k CTAs per (group, BM rows)
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kResThreads = 256;  // 8 warps

// A hidden layer of the CTA's weight block: kp padded input rows, np padded
// local output columns (a multiple of 4), float offsets of W (kp, np) and of
// the bias (np,).  For l > 0 the input rows are the previous layer's two
// halves side by side, np_{l-1} each.
struct RLayer {
  int kp, np, w, b;
};

// Mirrors the ctypes structure the Python wrapper fills in.
struct RPlan {
  int k;       // objectives (the cluster is 2k CTAs)
  int dp;      // input dimension padded to 4
  int block;   // floats of one CTA's weight block (a multiple of 4)
  int wmax;    // largest np of any hidden layer
  int hidden;  // hidden layers of every objective
  int log_target[kMaxObj];
  float sign[kMaxObj];
  int last_w[kMaxObj];  // the last layer's input half (np_{L-1},)
  int last_b[kMaxObj];  // its bias
  RLayer layer[kMaxObj][kMaxLayers];
};

// out[n, r] = relu(sum_k in[k, r] W[k, n] + b[n]) for the np local columns,
// stored column-major into this CTA's buffer (and, unless out_remote is
// null, its partner's), with the mask bit (pre-activation > 0) of every
// element.  The lanes whose 4-row tiles share a 32-row mask word are
// consecutive (min(8, BM/4) of them): their nibbles are OR-ed with
// xor-shuffles and one lane stores the word, so every word is written once.
template <int BM>
__device__ __forceinline__ void res_forward(const float* in, int kp,
                                            const float* W, const float* b,
                                            int np, float* out,
                                            float* out_remote,
                                            uint32_t* mask) {
  constexpr int RT = BM / 4;
  constexpr int NW = (BM + 31) / 32;
  constexpr int kGroup = RT < 8 ? RT : 8;
  const int ntiles = (np / 4) * RT;
  for (int t0 = 0; t0 < ntiles; t0 += kResThreads) {
    const int t = t0 + (int)threadIdx.x;
    const unsigned live = __ballot_sync(0xffffffffu, t < ntiles);
    if (t >= ntiles) continue;
    const int n0 = 4 * (t / RT), r0 = 4 * (t % RT);
    float acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[q][i] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < kp; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(in + kk * BM + r0);
      const float4 w = *reinterpret_cast<const float4*>(W + kk * np + n0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][i] = fmaf(av[i], wv[q], acc[q][i]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float bq = b[n0 + q];
      float o[4];
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = acc[q][i] + bq;
        o[i] = v < 0.0f ? 0.0f : v;  // jnp.maximum(a, 0): NaN stays NaN
        word |= (v > 0.0f ? 1u : 0u) << ((r0 & 31) + i);
      }
      const float4 o4 = make_float4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<float4*>(out + (n0 + q) * BM + r0) = o4;
      if (out_remote != nullptr)
        *reinterpret_cast<float4*>(out_remote + (n0 + q) * BM + r0) = o4;
#pragma unroll
      for (int off = 1; off < kGroup; off <<= 1)
        word |= __shfl_xor_sync(live, word, off);
      if ((threadIdx.x & (kGroup - 1)) == 0)
        mask[(n0 + q) * NW + (r0 >> 5)] = word;
    }
  }
}

// part[k, r] = sum_n g[n, r] W[k, n] over the np local columns, for every
// input row k of W (kp, np), n in order.  Input rows are two halves of
// `split` rows: the half `mine` goes to `local`, the other to `remote`, each
// indexed within its half.
template <int BM>
__device__ __forceinline__ void res_backward(const float* g, int np,
                                             const float* W, int kp,
                                             int split, int mine,
                                             float* local, float* remote) {
  constexpr int RT = BM / 4;
  for (int t = threadIdx.x; t < (kp / 4) * RT; t += kResThreads) {
    const int k0 = 4 * (t / RT), r0 = 4 * (t % RT);
    float acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[q][i] = 0.0f;
    for (int n0 = 0; n0 < np; n0 += 4) {
      float wv[4][4], gv[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 w =
            *reinterpret_cast<const float4*>(W + (k0 + q) * np + n0);
        wv[q][0] = w.x; wv[q][1] = w.y; wv[q][2] = w.z; wv[q][3] = w.w;
        const float4 a =
            *reinterpret_cast<const float4*>(g + (n0 + q) * BM + r0);
        gv[q][0] = a.x; gv[q][1] = a.y; gv[q][2] = a.z; gv[q][3] = a.w;
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[q][i] = fmaf(gv[p][i], wv[q][p], acc[q][i]);
    }
    const int hk = k0 / split;
    float* dst = (hk == mine ? local : remote) + (k0 - hk * split) * BM + r0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float4*>(dst + q * BM) =
          make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
  }
}

template <int BM>
__device__ __forceinline__ bool mask_bit(const uint32_t* mask, int n, int r) {
  constexpr int NW = (BM + 31) / 32;
  return (mask[n * NW + (r >> 5)] >> (r & 31)) & 1u;
}

template <int BM>
__global__ void __launch_bounds__(kResThreads, 1)
descend_resident(const float* __restrict__ x0, const float* __restrict__ lo,
                 const float* __restrict__ hi, const float* __restrict__ ulo,
                 const float* __restrict__ uhi, const float* __restrict__ us,
                 const float* __restrict__ tsel,
                 const float* __restrict__ weights, const RPlan plan,
                 const Hyper hp, int Mp, float* __restrict__ out) {
  constexpr int NW = (BM + 31) / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ncta = 2 * plan.k;
  const int j = rank >> 1, half = rank & 1, partner = rank ^ 1;
  const int g = blockIdx.y;
  const size_t row0 = (size_t)g * Mp + (size_t)(blockIdx.x / ncta) * BM;
  const int D = hp.D, dp = plan.dp, k = plan.k, wmax = plan.wmax;
  const int L = plan.hidden;
  const int tid = threadIdx.x;

  extern __shared__ float4 smem4[];
  float* W = reinterpret_cast<float*>(smem4);  // this CTA's weight block
  float* xT = W + plan.block;                   // (dp, BM) current point
  float* mT = xT + dp * BM;                     // (dp, BM) Adam first moment
  float* vT = mT + dp * BM;                     // (dp, BM) Adam second moment
  float* cst = vT + dp * BM;                    // 6 x (BM,) objective j
  float* raw = cst + 6 * BM;                    // 2 x (BM,) last-layer halves
  float* dl = raw + 2 * BM;                     // (BM,) dL/draw
  float* dxp = dl + BM;                         // (dp, BM) partial dL/dx
  uint32_t* masks = reinterpret_cast<uint32_t*>(dxp + dp * BM);
  const int mask_words = (L * wmax * NW + 3) & ~3;
  float* act0 = reinterpret_cast<float*>(masks + mask_words);  // (2 wmax, BM)
  float* act1 = act0 + 2 * wmax * BM;                           // (2 wmax, BM)
  // the backward reuses the activation buffers (the masks keep what it needs)
  float* gb = act0;               // (wmax, BM) gradient at a layer's output
  float* part = act0 + wmax * BM;  // (wmax, BM) my half of a partial
  float* inc[2] = {act1, act1 + wmax * BM};  // the partner's, by layer parity

  const float* wsrc = weights + ((size_t)g * ncta + rank) * plan.block;
  for (int e = tid; e < plan.block / 4; e += kResThreads)
    smem4[e] = __ldg(reinterpret_cast<const float4*>(wsrc) + e);
  for (int e = tid; e < dp * BM; e += kResThreads) {
    const int d = e / BM, r = e % BM;
    xT[e] = d < D ? x0[(row0 + r) * D + d] : 0.0f;
    mT[e] = 0.0f;
    vT[e] = 0.0f;
  }
  const float* src[6] = {lo, hi, ulo, uhi, us, tsel};
  for (int e = tid; e < 6 * BM; e += kResThreads)
    cst[e] = src[e / BM][(row0 + e % BM) * k + j];
  float* raw_remote = cluster.map_shared_rank(raw, partner);
  cluster.sync();  // every CTA of the cluster runs before any remote store

  const RLayer* lys = plan.layer[j];
  const float* wl = W + plan.last_w[j];
  for (int step = 0; step < hp.steps; ++step) {
    const float t = (float)step + 1.0f;
    // forward through the hidden layers, halves exchanged per layer; the
    // last one's other half is never read (the last layer splits by input
    // half), so it stays local
    const float* in = xT;
    int kp = dp;
    for (int l = 0; l < L; ++l) {
      float* o = (l & 1) ? act1 : act0;
      float* mine = o + half * lys[l].np * BM;
      const bool last = l == L - 1;
      res_forward<BM>(in, kp, W + lys[l].w, W + lys[l].b, lys[l].np, mine,
                      last ? nullptr : cluster.map_shared_rank(mine, partner),
                      masks + l * wmax * NW);
      if (last)
        __syncthreads();
      else
        cluster.sync();
      in = o;
      kp = 2 * lys[l].np;
    }
    // the last layer: each half's partial, then raw = (h0 + h1) + b
    const int npl = lys[L - 1].np;
    for (int r = tid; r < BM; r += kResThreads) {
      float a = 0.0f;
      for (int i = 0; i < npl; ++i)
        a = fmaf(in[(half * npl + i) * BM + r], wl[i], a);
      raw[half * BM + r] = a;
      raw_remote[half * BM + r] = a;
    }
    cluster.sync();
    for (int r = tid; r < BM; r += kResThreads) {
      const float rv = (raw[r] + raw[BM + r]) + W[plan.last_b[j]];
      const float sg = plan.sign[j];
      float f, dfdraw;
      if (plan.log_target[j]) {
        const float ex = expf(rv);
        f = sg * ex;
        dfdraw = sg * ex;
      } else {
        f = sg * rv;
        dfdraw = sg;
      }
      dl[r] = dloss_df(f, cst[r], cst[BM + r], cst[2 * BM + r],
                       cst[3 * BM + r], cst[4 * BM + r], cst[5 * BM + r],
                       hp.tie2) *
              dfdraw;
    }
    __syncthreads();
    // backward: the last layer's input gradient, masked, my half
    for (int e = tid; e < npl * BM; e += kResThreads) {
      const int i = e / BM, r = e % BM;
      const float v = dl[r] * wl[i];
      gb[e] = v * (mask_bit<BM>(masks + (L - 1) * wmax * NW, i, r) ? 1.0f
                                                                   : 0.0f);
    }
    __syncthreads();
    for (int l = L - 1; l >= 1; --l) {
      const int npp = lys[l - 1].np;
      float* in_l = inc[l & 1];
      res_backward<BM>(gb, lys[l].np, W + lys[l].w, 2 * npp, npp, half, part,
                       cluster.map_shared_rank(in_l, partner));
      cluster.sync();
      const uint32_t* mk = masks + (l - 1) * wmax * NW;
      for (int e = tid; e < npp * BM; e += kResThreads) {
        const float s = half == 0 ? part[e] + in_l[e] : in_l[e] + part[e];
        gb[e] = s * (mask_bit<BM>(mk, e / BM, e % BM) ? 1.0f : 0.0f);
      }
      __syncthreads();
    }
    res_backward<BM>(gb, lys[0].np, W + lys[0].w, dp, dp, 0, dxp, dxp);
    cluster.sync();
    // dL/dx: the objectives' sums in order, each the sum of its two halves;
    // then projected Adam with cosine decay (t is 1-based), in every CTA
    const float bc1 = 1.0f - powf(hp.b1, t);
    const float bc2 = 1.0f - powf(hp.b2, t);
    const float frac = (t - 1.0f) / (float)hp.steps;
    const float lr_t =
        hp.lr * (hp.lr_floor +
                 hp.cos_coef * (1.0f + cosf(3.14159265358979323846f * frac)));
    for (int e = tid; e < D * BM; e += kResThreads) {
      float gsum = 0.0f;
      for (int jj = 0; jj < k; ++jj) {
        const float p0 = *cluster.map_shared_rank(dxp + e, 2 * jj);
        const float p1 = *cluster.map_shared_rank(dxp + e, 2 * jj + 1);
        gsum = gsum + (p0 + p1);
      }
      const float g = isfinite(gsum) ? gsum : 0.0f;
      const float m = hp.b1 * mT[e] + hp.omb1 * g;
      const float v = hp.b2 * vT[e] + hp.omb2 * g * g;
      mT[e] = m;
      vT[e] = v;
      const float mh = m / bc1;
      const float vh = v / bc2;
      const float x = xT[e] - lr_t * mh / (sqrtf(vh) + hp.eps);
      xT[e] = fminf(fmaxf(x, 0.0f), 1.0f);
    }
    // every CTA has read every partial before any is written again: the
    // next step's backward ends after L + 1 more cluster barriers
    __syncthreads();
  }

  if (rank == 0)
    for (int e = tid; e < D * BM; e += kResThreads)
      out[(row0 + e % BM) * D + e / BM] = xT[e];
  cluster.sync();  // no CTA leaves while a partner may still read it
}

template <int BM>
cudaError_t launch_resident(const float* x0, const float* lo, const float* hi,
                            const float* ulo, const float* uhi,
                            const float* us, const float* tsel,
                            const float* weights, const RPlan& plan,
                            const Hyper& hp, int G, int Mp, int smem,
                            float* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      descend_resident<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * plan.k * (Mp / BM), G, 1);
  cfg.blockDim = dim3(kResThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2 * plan.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, descend_resident<BM>, x0, lo, hi, ulo, uhi,
                           us, tsel, weights, plan, hp, Mp, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// sizeof(Plan) and sizeof(RPlan), so the wrapper can check its ctypes
// mirrors.
extern "C" int mogd_plan_bytes() { return (int)sizeof(Plan); }
extern "C" int mogd_resident_plan_bytes() { return (int)sizeof(RPlan); }

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

// The resident route.  x0 (G, Mp, D); lo/hi/ulo/uhi/us/tsel (G, Mp, k);
// weights (G, 2k, plan.block) packed per the RPlan, CTA (j, h) at 2j + h; out
// (G, Mp, D).  Mp is a multiple of block_rows (16, 32 or 64); k <= 4; smem
// is the wrapper's count (`_resident_smem_bytes`).  Returns the CUDA error
// of the launch (0 on success).
extern "C" int mogd_descend_resident(
    const float* x0, const float* lo, const float* hi, const float* ulo,
    const float* uhi, const float* us, const float* tsel,
    const float* weights, const void* plan_ptr, int G, int Mp, int D,
    int block_rows, int steps, float lr, float lr_floor, float cos_coef,
    float b1, float omb1, float b2, float omb2, float eps, float tie2,
    int smem, float* out, void* stream) {
  const RPlan& plan = *static_cast<const RPlan*>(plan_ptr);
  if (plan.k < 1 || 2 * plan.k > 8) return (int)cudaErrorInvalidValue;
  Hyper hp;
  hp.steps = steps;
  hp.D = D;
  hp.H = 0;
  hp.n_acts = 0;
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
    case 16:
      return (int)launch_resident<16>(x0, lo, hi, ulo, uhi, us, tsel, weights,
                                      plan, hp, G, Mp, smem, out, s);
    case 32:
      return (int)launch_resident<32>(x0, lo, hi, ulo, uhi, us, tsel, weights,
                                      plan, hp, G, Mp, smem, out, s);
    case 64:
      return (int)launch_resident<64>(x0, lo, hi, ulo, uhi, us, tsel, weights,
                                      plan, hp, G, Mp, smem, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
