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
// Design.  A CTA of 128 threads holds CH = 32 channels of one batch row,
// L = 4 lanes a channel: lane l keeps states l*NPT .. l*NPT+NPT-1 of its
// channel in registers for the whole sequence (NPT = ceil(n / 4), compiled
// for 1, 2, 4, 8 and 16; the padded states keep A = 0, B = C = 0 and stay
// 0); at Jamba's d_inner = 8192, n = 16 that is 256 CTAs of four warps.
// Runs of RUN steps
// of dt, x, B_t and C_t are staged with cp.async into two buffers, so run
// n+1 loads while run n computes; dt and x as rows of CH channels, B_t and C_t
// as rows of the padded state width, zero-filled past n, past d and past
// the run's last step, and read back as vectors.  Within a run the lane
// works in groups of G steps (4, or fewer where NPT is large): first, off
// the h chain, every exp(dt A_k) and (dt x) B_k of the group; then the
// chain itself, h = dA * h + dBx (a multiply and an add a step), with the
// lane's partial dot fmaf(h_k, C_k, .) stored to shared memory.  A step
// past the run's end sees dt = x = 0, so dA = 1 and dBx = 0 leave h as it
// is.  After the run each y_t is the sum of its L partials in a fixed
// pairwise order ((p0 + p1) + (p2 + p3)), written as rows of CH
// channels.
//
// Rounding.  The project builds with -fmad=false and without fast math, so
// h = exp(dt*A)*h + (dt*x)*B rounds after every operation, as the plain
// version's separate tensor ops do; expf is the IEEE-accurate one (2 ulp).
// Only the dot y = h . C differs in order (fmaf within a lane, then the
// pairwise sum over lanes); the tolerance of TestMambaScan (3e-4) covers it.
//
// Bound on this card.  It moves 3 B T d floats (dt, x, y) plus B T 2n (B_t,
// C_t), A and the states: at B = 1, T = 512, d = 8192, n = 16 that is 51.9
// MB, 0.0155 ms at 3.35 TB/s.  It needs T d n = 67.1 M accurate expf, one
// MUFU.EX2 each at 16 a clock an SM (CUDA C Programming Guide, arithmetic
// instruction throughput, compute capability 9.0): 0.016 ms at the clock
// of the fp32 peak, so the SFUs, not the bytes, set the bound.  expf's range
// reduction, the state update and the dot add about 12 FMA-pipe
// instructions a state-step, ~0.03 ms at full issue: at that shape the
// kernel is bound by the issue rate, which is why the exps leave the chain
// (a chain of dependent exps left most issue slots empty).
//
// Measured on an H100 SXM (PERF.md): 0.067 ms at that shape (the
// chain of dependent exps took 0.119); about half the issue rate.  Trial
// builds with 8 lanes a channel (512 CTAs) ran alike at B = 1 and 17 %
// slower at B = 4, and were not kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int L = 4;  // lanes a channel
constexpr int kBufs = 2;  // runs staged at once: this one and the next

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
  bool vec_dx, vec_bc;  // 16-byte copies for dt/x rows, B_t/C_t rows
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One cp.async of P floats (P = 4: 16 bytes, L2 only; P = 1: 4 bytes),
// zero-filled where `in` is false (nothing is read then).
template <int P>
__device__ __forceinline__ void copy(uint32_t dst, const float* src,
                                     bool in) {
  if constexpr (P == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
}

// Copies rows 0..pad-1 of LEN floats into the row-major dst in pieces of P
// floats; row s of the source is at src + s * stride.  Element c of row s
// is taken where s < rows and c < width, and zero-filled elsewhere (with
// P = 4, width and the rows 16-byte aligned, so a piece is wholly in or
// out).  The CTA's threads take pieces kThreads apart; kThreads is a
// multiple of a row's pieces, so a thread's pieces keep one column: each
// costs the copy and two adds, not an address computed anew.  The caller
// commits the group.
template <int LEN, int P>
__device__ __forceinline__ void stage_by(float* dst, const float* src,
                                         long long stride, int rows,
                                         int pad, int width, int tid) {
  constexpr int Q = LEN / P;  // pieces a row
  static_assert(kThreads % Q == 0, "a CTA stages whole rows at a time");
  constexpr int DS = kThreads / Q;  // rows between a thread's pieces
  int s = tid / Q;
  const int c = (tid % Q) * P;
  const float* p = src + s * stride + c;
  uint32_t d = smem(dst + s * LEN + c);
  for (; s < pad; s += DS, p += DS * stride, d += DS * LEN * 4) {
    const bool in = s < rows && c < width;
    copy<P>(d, in ? p : src, in);
  }
}

// stage_by in 16-byte pieces where the rows allow it (vec), else in 4-byte
// ones.
template <int LEN>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long stride, int rows, int pad,
                                      int width, bool vec, int tid) {
  if (vec)
    stage_by<LEN, 4>(dst, src, stride, rows, pad, width, tid);
  else
    stage_by<LEN, 1>(dst, src, stride, rows, pad, width, tid);
}

template <int NPT>
struct Layout {
  static constexpr int CH = kThreads / L;  // channels a CTA
  static constexpr int NS = L * NPT;       // padded state width
  static constexpr int G = NPT >= 16 ? 1 : NPT >= 8 ? 2 : 4;  // steps ahead
  // steps staged at a time, a multiple of G: as many as kBufs buffers of
  // dt, x, B_t and C_t and one of partials fit in 48 KB of shared memory
  static constexpr int RUN =
      49152 / (4 * (kBufs * 2 * (CH + NS) + CH * L)) / G * G;
};

// NPT floats of shared memory into registers, as the widest aligned vectors.
template <int NPT>
__device__ __forceinline__ void load_states(float* dst, const float* src) {
  if constexpr (NPT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NPT; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + i);
      dst[i] = q.x;
      dst[i + 1] = q.y;
      dst[i + 2] = q.z;
      dst[i + 3] = q.w;
    }
  } else if constexpr (NPT == 2) {
    const float2 q = *reinterpret_cast<const float2*>(src);
    dst[0] = q.x;
    dst[1] = q.y;
  } else {
    dst[0] = src[0];
  }
}

template <int NPT>
__global__ void __launch_bounds__(kThreads) scan_kernel(ScanArgs a) {
  using Lay = Layout<NPT>;
  constexpr int CH = Lay::CH, NS = Lay::NS, G = Lay::G, RUN = Lay::RUN;
  __shared__ __align__(16) float s_dt[kBufs][RUN][CH];
  __shared__ __align__(16) float s_x[kBufs][RUN][CH];
  __shared__ __align__(16) float s_B[kBufs][RUN][NS];
  __shared__ __align__(16) float s_C[kBufs][RUN][NS];
  __shared__ __align__(16) float s_p[RUN][CH * L];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int c = tid / L;
  const int lane = tid - c * L;
  const int ch = d0 + c;
  const bool live = ch < a.d;
  const int width = min(CH, a.d - d0);

  const float* dtp = a.dt + b * a.dt_b + d0;
  const float* xp = a.x + b * a.x_b + d0;
  const float* Bp = a.Bm + b * a.B_b;
  const float* Cp = a.Cm + b * a.C_b;
  float* yp = a.y + (long long)b * a.T * a.d + d0;
  const int runs = (a.T + RUN - 1) / RUN;

  // Stages run `run` (nothing past the last; the group is still committed,
  // so that every thread's groups count alike).
  auto issue = [&](int run) {
    const int buf = run % kBufs;
    const long long t0 = (long long)run * RUN;
    const int n = min(RUN, a.T - (int)t0);
    const int pad = (n + G - 1) / G * G;
    stage<CH>(&s_dt[buf][0][0], dtp + t0 * a.dt_t, a.dt_t, n, pad, width,
              a.vec_dx, tid);
    stage<CH>(&s_x[buf][0][0], xp + t0 * a.x_t, a.x_t, n, pad, width,
              a.vec_dx, tid);
    stage<NS>(&s_B[buf][0][0], Bp + t0 * a.B_t, a.B_t, n, pad, a.n,
              a.vec_bc, tid);
    stage<NS>(&s_C[buf][0][0], Cp + t0 * a.C_t, a.C_t, n, pad, a.n,
              a.vec_bc, tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int run = 0; run < kBufs - 1; ++run) issue(run);

  const long long hbase = ((long long)b * a.d + ch) * a.n;
  float h[NPT], A[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int k = lane * NPT + i;
    const bool on = live && k < a.n;
    A[i] = on ? a.A[(long long)ch * a.n + k] : 0.f;
    h[i] = (on && a.h0) ? a.h0[hbase + k] : 0.f;
  }

  for (int run = 0; run < runs; ++run) {
    const int buf = run % kBufs;
    const int n = min(RUN, a.T - run * RUN);
    // Every thread left the previous run's steps (the barrier before its
    // reduction), so that run's buffer is free for run + kBufs - 1.
    issue(run + kBufs - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kBufs - 1) : "memory");
    __syncthreads();  // run's rows landed; the last reduction's reads done
    for (int s0 = 0; s0 < n; s0 += G) {
      float dA[G][NPT], dBx[G][NPT];
#pragma unroll
      for (int g = 0; g < G; ++g) {  // off the chain
        const float dtv = s_dt[buf][s0 + g][c];
        const float dtx = dtv * s_x[buf][s0 + g][c];
        float Bv[NPT];
        load_states<NPT>(Bv, &s_B[buf][s0 + g][lane * NPT]);
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          dA[g][i] = expf(dtv * A[i]);
          dBx[g][i] = dtx * Bv[i];
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {  // the chain
        float Cv[NPT];
        load_states<NPT>(Cv, &s_C[buf][s0 + g][lane * NPT]);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          h[i] = dA[g][i] * h[i] + dBx[g][i];
          acc = fmaf(h[i], Cv[i], acc);
        }
        s_p[s0 + g][tid] = acc;
      }
    }
    __syncthreads();  // partials complete
    for (int o = tid; o < n * CH; o += kThreads) {
      const int s = o / CH;
      const int cc = o - s * CH;
      float p[L];
#pragma unroll
      for (int l = 0; l < L; ++l) p[l] = s_p[s][cc * L + l];
#pragma unroll
      for (int w = 1; w < L; w *= 2)
#pragma unroll
        for (int l = 0; l < L; l += 2 * w) p[l] += p[l + w];
      if (cc < width) yp[(long long)(run * RUN + s) * a.d + cc] = p[0];
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
  constexpr int CH = Layout<NPT>::CH;
  dim3 grid((a.d + CH - 1) / CH, B);
  scan_kernel<NPT><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The launch's arguments, packed by the wrapper as 20 int64 (one foreign
// argument, not 20: the decode path pays for each).  dt, x: fp32 (B, T, d)
// views and Bm, Cm: fp32 (B, T, n) views, each with a unit last stride and
// the (b, t) strides given, in elements.  A: (d, n) fp32; h0: (B, d, n)
// fp32 or 0 (zero initial state); y: (B, T, d) fp32; h_out: (B, d, n)
// fp32.  1 <= n <= 64, B*d >= 1, T >= 1 (the wrapper checks).
struct ScanCall {
  long long dt, x, Bm, Cm, A, h0, y, h_out;
  long long dt_b, dt_t, x_b, x_t, B_b, B_t, C_b, C_t;
  long long B, T, d, n;
};

// Returns the CUDA error of the launch (0 on success).
extern "C" int mamba_scan(const ScanCall* c, void* stream) {
  auto f = [](long long p) { return reinterpret_cast<const float*>(p); };
  ScanArgs a;
  a.dt = f(c->dt);
  a.x = f(c->x);
  a.Bm = f(c->Bm);
  a.Cm = f(c->Cm);
  a.dt_b = c->dt_b;
  a.dt_t = c->dt_t;
  a.x_b = c->x_b;
  a.x_t = c->x_t;
  a.B_b = c->B_b;
  a.B_t = c->B_t;
  a.C_b = c->C_b;
  a.C_t = c->C_t;
  a.A = f(c->A);
  a.h0 = f(c->h0);
  a.y = reinterpret_cast<float*>(c->y);
  a.h_out = reinterpret_cast<float*>(c->h_out);
  a.T = (int)c->T;
  a.d = (int)c->d;
  a.n = (int)c->n;
  a.vec_dx = aligned(a.dt) && aligned(a.x) && a.d % 4 == 0 &&
             ((a.dt_b | a.dt_t | a.x_b | a.x_t) & 3) == 0;
  a.vec_bc = aligned(a.Bm) && aligned(a.Cm) && a.n % 4 == 0 &&
             ((a.B_b | a.B_t | a.C_b | a.C_t) & 3) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = (int)c->B;
  const int npt = (a.n + L - 1) / L;
  if (npt <= 1) return (int)launch<1>(a, B, s);
  if (npt <= 2) return (int)launch<2>(a, B, s);
  if (npt <= 4) return (int)launch<4>(a, B, s);
  if (npt <= 8) return (int)launch<8>(a, B, s);
  if (npt <= 16) return (int)launch<16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
