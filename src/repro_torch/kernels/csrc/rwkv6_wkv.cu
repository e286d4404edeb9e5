// RWKV-6 ("Finch") WKV recurrence for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/rwkv6_wkv.py
// (:27, entry wkv_chunked :50, pallas_call :59), and computes the contract of
// its oracle ref.rwkv6_wkv (src/repro/kernels/ref.py:123): per batch row b and
// head h, with S a (dh, dh) fp32 state,
//
//     y_t = r_t^T (S + diag(u) k_t v_t^T)
//     S  <- diag(w_t) S + k_t v_t^T
//
// from an optional initial state S0 (zero when absent), returning y and the
// final state.  The Pallas kernel is the special case S0 = 0, y only; the
// serving path needs the general form (prefill writes S_fin into the cache,
// decode is T = 1 from the cached state).
//
// Layout.  r/k/v/w are read in the time mix's (B, T, H, dh) layout through
// their (b, t, h) strides, the last dimension contiguous, so the wrapper
// never folds or transposes; u is (H, dh); S0 and S_out are (B, H, dh, dh)
// row-major (S[i][j]: i indexes k, j indexes v); y is (B, T, H, dh)
// contiguous.  Any T: a partial last run of steps takes bound checks, not
// the Pallas kernel's T % chunk == 0.
//
// Design.  One block per (b, h) with dh threads.  Thread j owns column j of
// S in registers for the whole sequence (dh floats; every loop over i is
// unrolled so S never leaves registers).  Runs of kSteps = 2048/dh steps of
// r, k, w and v are staged in shared memory (32 KB), read back as broadcasts
// (every thread reads the same r_t[i], k_t[i], w_t[i]).  Each step costs a
// thread about 5 dh fp32 operations: y_j = sum_i r_i (S_ij + u_i k_i v_j) in
// four partial sums, then S_ij = w_i S_ij + k_i v_j.
//
// Bound on this card.  It moves 5 B T H dh floats (r, k, v, w, y) plus the
// states, and does about 7 dh^2 operations a step and head, so it is bound
// by the bytes at dh = 64 — but the recurrence is sequential in T, and with
// one block per (b, h) a B = 1 prefill of RWKV-6 3B (H = 40) fills 40 of the
// 132 SMs with two warps each: the chain of T steps, not the card's rates,
// sets the time.  Splitting S's columns over more blocks (and the chunked
// parallel form for long prompts) is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, t, h;  // in elements; the last dimension has stride 1
};

struct WkvArgs {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  Strides sr, sk, sv, sw;
  const float* u;   // (H, DH)
  const float* S0;  // (B, H, DH, DH) or null (zero initial state)
  float* y;         // (B, T, H, DH)
  float* S_out;     // (B, H, DH, DH)
  int T, H;
};

template <int DH>
__global__ void __launch_bounds__(DH) wkv_kernel(WkvArgs a) {
  constexpr int kSteps = 2048 / DH;
  __shared__ float s_r[kSteps][DH];
  __shared__ float s_k[kSteps][DH];
  __shared__ float s_w[kSteps][DH];
  __shared__ float s_v[kSteps][DH];
  __shared__ float s_u[DH];

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int j = threadIdx.x;

  float S[DH];
  const long long sbase = (long long)bh * DH * DH;
#pragma unroll
  for (int i = 0; i < DH; ++i) S[i] = a.S0 ? a.S0[sbase + i * DH + j] : 0.f;
  s_u[j] = a.u[h * DH + j];

  const float* rp = a.r + b * a.sr.b + h * a.sr.h + j;
  const float* kp = a.k + b * a.sk.b + h * a.sk.h + j;
  const float* vp = a.v + b * a.sv.b + h * a.sv.h + j;
  const float* wp = a.w + b * a.sw.b + h * a.sw.h + j;
  const long long y_t = (long long)a.H * DH;
  float* yp = a.y + (long long)b * a.T * y_t + (long long)h * DH + j;

  for (int t0 = 0; t0 < a.T; t0 += kSteps) {
    const int n = min(kSteps, a.T - t0);
    __syncthreads();  // the previous run's reads are done
    for (int s = 0; s < n; ++s) {
      const long long t = t0 + s;
      s_r[s][j] = rp[t * a.sr.t];
      s_k[s][j] = kp[t * a.sk.t];
      s_w[s][j] = wp[t * a.sw.t];
      s_v[s][j] = vp[t * a.sv.t];
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const float vj = s_v[s][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        const float ukv = (s_u[i] * s_k[s][i]) * vj;
        acc[i & 3] = fmaf(s_r[s][i], S[i] + ukv, acc[i & 3]);
      }
      yp[(long long)(t0 + s) * y_t] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        S[i] = fmaf(s_w[s][i], S[i], s_k[s][i] * vj);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < DH; ++i) a.S_out[sbase + i * DH + j] = S[i];
}

template <int DH>
cudaError_t launch(const WkvArgs& a, int BH, cudaStream_t stream) {
  wkv_kernel<DH><<<BH, DH, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// r/k/v/w: fp32 (B, T, H, dh) views with unit last stride; `strides` holds
// 12 host integers, the (b, t, h) strides of r, k, v and w in that order.
// u: (H, dh) fp32; S0: (B, H, dh, dh) fp32 or null; y: (B, T, H, dh) fp32;
// S_out: (B, H, dh, dh) fp32.  dh in {16, 32, 64, 128}; B*H >= 1, T >= 1
// (the wrapper checks).  Returns the CUDA error of the launch (0 on success).
extern "C" int rwkv6_wkv(const float* r, const float* k, const float* v,
                         const float* w, const long long* strides,
                         const float* u, const float* S0, int B, int T, int H,
                         int dh, float* y, float* S_out, void* stream) {
  WkvArgs a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = w;
  a.sr = Strides{strides[0], strides[1], strides[2]};
  a.sk = Strides{strides[3], strides[4], strides[5]};
  a.sv = Strides{strides[6], strides[7], strides[8]};
  a.sw = Strides{strides[9], strides[10], strides[11]};
  a.u = u;
  a.S0 = S0;
  a.y = y;
  a.S_out = S_out;
  a.T = T;
  a.H = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  switch (dh) {
    case 16: return (int)launch<16>(a, BH, s);
    case 32: return (int)launch<32>(a, BH, s);
    case 64: return (int)launch<64>(a, BH, s);
    case 128: return (int)launch<128>(a, BH, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
