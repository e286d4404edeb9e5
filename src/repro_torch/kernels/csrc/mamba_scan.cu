// Mamba / S6 selective scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/mamba_scan.py
// (:26, entry selective_scan :48, pallas_call :60), and computes the contract
// of its oracle ref.mamba_scan (src/repro/kernels/ref.py:143): per batch row
// b and channel c, with h a (n,) fp32 state,
//
//     h_t = exp(dt_t A_c) * h_{t-1} + (dt_t x_t) B_t
//     y_t = h_t . C_t
//
// from an optional initial state h0 (zero when absent), returning y and the
// final state.  The Pallas kernel is the special case h0 = 0, y only, with
// T % chunk == 0; the serving path needs the general form (prefill writes
// h_fin into the cache, decode is T = 1 from the cached state), so any T.
//
// Layout.  dt and x are (B, T, d), B_t and C_t (B, T, n), each read through
// its (b, t) strides with the last dimension contiguous (C_t and B_t arrive
// as column slices of the x projection); A is (d, n); h0 and h_out are
// (B, d, n); y is (B, T, d), all contiguous.
//
// Design.  One block holds kChannels = 32 channels of one batch row, four
// lanes a channel (128 threads): lane l keeps states l*NPT .. l*NPT+NPT-1
// of its channel in registers for the whole sequence (NPT = ceil(n / 4),
// compiled for 1, 2, 4, 8 and 16), and y_t is the lanes' partial dots summed
// with two xor-shuffles.  At Jamba's B = 1, d_inner = 8192, n = 16 that is
// 256 blocks, two per SM, where one thread a channel would give 64 blocks
// for 132 SMs.  Runs of kRun = 32 steps are staged in shared memory: dt and
// x as rows of 32 channels (each a coalesced 128-byte read), the B_t and
// C_t rows that every channel of the block reads, and y, written back as
// rows of 32 channels.
//
// Rounding.  The project builds with -fmad=false and without fast math, so
// h = exp(dt*A)*h + (dt*x)*B rounds after every operation, as the plain
// version's separate tensor ops do; expf is the IEEE-accurate one (2 ulp).
// Only the dot y = h . C differs in order (fmaf within a lane, then the
// shuffle tree); the tolerance of TestMambaScan (3e-4) covers it.
//
// Bound on this card.  It moves 3 B T d floats (dt, x, y) plus B T 2n
// (B_t, C_t), A and the states, and does about 6 flops and one exp per
// (t, channel, state): at B = 1, T = 512, d = 8192, n = 16 that is 51.9 MB
// (0.0155 ms at 3.35 TB/s) against 0.40 GFLOP (0.006 ms at 67 TFLOP/s), so
// the bytes bound it.  Each warp runs T dependent iterations, and each
// iteration waits on its own chain (shared loads, exp, multiply, add, FMA,
// two shuffles, a store) although only h carries over: that latency times
// T, not the card's rates or its occupancy, sets the time.  Computing a
// run's exp(dt A) and (dt x) B ahead and reducing y after the run would
// leave only the two operations on h in the chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                      // lanes sharing a channel
constexpr int kChannels = 32;                  // channels a block
constexpr int kThreads = kLanes * kChannels;   // 128
constexpr int kRun = 32;                       // steps staged at a time

struct ScanArgs {
  const float* dt;
  const float* x;
  const float* Bm;
  const float* Cm;
  long long dt_b, dt_t, x_b, x_t, B_b, B_t, C_b, C_t;  // strides, elements
  const float* A;   // (d, n)
  const float* h0;  // (B, d, n) or null (zero initial state)
  float* y;         // (B, T, d)
  float* h_out;     // (B, d, n)
  int T, d, n;
};

template <int NPT>
__global__ void __launch_bounds__(kThreads) scan_kernel(ScanArgs a) {
  constexpr int NS = kLanes * NPT;  // the state width, padded
  __shared__ float s_dt[kRun][kChannels];
  __shared__ float s_x[kRun][kChannels];
  __shared__ float s_y[kRun][kChannels];
  __shared__ float s_B[kRun][NS];
  __shared__ float s_C[kRun][NS];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int c = tid / kLanes;
  const int lane = tid - c * kLanes;
  const int ch = d0 + c;
  const bool live = ch < a.d;
  const long long hbase = ((long long)b * a.d + ch) * a.n;

  // Padded states (k >= n) and dead channels keep A = 0, h = 0 and see
  // B = C = 0, so they stay 0 and add nothing to y.
  float h[NPT], A[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int k = lane * NPT + i;
    const bool on = live && k < a.n;
    A[i] = on ? a.A[(long long)ch * a.n + k] : 0.f;
    h[i] = (on && a.h0) ? a.h0[hbase + k] : 0.f;
  }

  const float* dtp = a.dt + b * a.dt_b + d0;
  const float* xp = a.x + b * a.x_b + d0;
  const float* Bp = a.Bm + b * a.B_b;
  const float* Cp = a.Cm + b * a.C_b;
  float* yp = a.y + (long long)b * a.T * a.d + d0;
  const int width = min(kChannels, a.d - d0);

  for (int t0 = 0; t0 < a.T; t0 += kRun) {
    const int nr = min(kRun, a.T - t0);
    for (int i = tid; i < kRun * kChannels; i += kThreads) {
      const int s = i / kChannels;
      const int cc = i - s * kChannels;
      const bool ok = s < nr && cc < width;
      const long long t = t0 + s;
      s_dt[s][cc] = ok ? dtp[t * a.dt_t + cc] : 0.f;
      s_x[s][cc] = ok ? xp[t * a.x_t + cc] : 0.f;
    }
    for (int i = tid; i < kRun * NS; i += kThreads) {
      const int s = i / NS;
      const int k = i - s * NS;
      const bool ok = s < nr && k < a.n;
      const long long t = t0 + s;
      s_B[s][k] = ok ? Bp[t * a.B_t + k] : 0.f;
      s_C[s][k] = ok ? Cp[t * a.C_t + k] : 0.f;
    }
    __syncthreads();
    for (int s = 0; s < nr; ++s) {
      const float dtv = s_dt[s][c];
      const float dtx = dtv * s_x[s][c];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const int k = lane * NPT + i;
        const float dA = expf(dtv * A[i]);
        h[i] = dA * h[i] + dtx * s_B[s][k];
        acc = fmaf(h[i], s_C[s][k], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (lane == 0) s_y[s][c] = acc;
    }
    __syncthreads();
    for (int i = tid; i < nr * kChannels; i += kThreads) {
      const int s = i / kChannels;
      const int cc = i - s * kChannels;
      if (cc < width) yp[(long long)(t0 + s) * a.d + cc] = s_y[s][cc];
    }
  }
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int k = lane * NPT + i;
    if (live && k < a.n) a.h_out[hbase + k] = h[i];
  }
}

template <int NPT>
cudaError_t launch(const ScanArgs& a, int B, cudaStream_t stream) {
  dim3 grid((a.d + kChannels - 1) / kChannels, B);
  scan_kernel<NPT><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dt, x: fp32 (B, T, d) views and Bm, Cm: fp32 (B, T, n) views, each with a
// unit last stride; `strides` holds 8 host integers, the (b, t) strides of
// dt, x, Bm and Cm in that order.  A: (d, n) fp32; h0: (B, d, n) fp32 or
// null; y: (B, T, d) fp32; h_out: (B, d, n) fp32.  1 <= n <= 64, B*d >= 1,
// T >= 1 (the wrapper checks).  Returns the CUDA error of the launch (0 on
// success).
extern "C" int mamba_scan(const float* dt, const float* x, const float* Bm,
                          const float* Cm, const long long* strides,
                          const float* A, const float* h0, int B, int T,
                          int d, int n, float* y, float* h_out,
                          void* stream) {
  ScanArgs a;
  a.dt = dt;
  a.x = x;
  a.Bm = Bm;
  a.Cm = Cm;
  a.dt_b = strides[0];
  a.dt_t = strides[1];
  a.x_b = strides[2];
  a.x_t = strides[3];
  a.B_b = strides[4];
  a.B_t = strides[5];
  a.C_b = strides[6];
  a.C_t = strides[7];
  a.A = A;
  a.h0 = h0;
  a.y = y;
  a.h_out = h_out;
  a.T = T;
  a.d = d;
  a.n = n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npt = (n + kLanes - 1) / kLanes;
  if (npt <= 1) return (int)launch<1>(a, B, s);
  if (npt <= 2) return (int)launch<2>(a, B, s);
  if (npt <= 4) return (int)launch<4>(a, B, s);
  if (npt <= 8) return (int)launch<8>(a, B, s);
  if (npt <= 16) return (int)launch<16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
