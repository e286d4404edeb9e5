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
// contiguous.  Any T: the last run of steps is cut short, not padded.
//
// Design.  Column j of S only ever meets v_j and y_j, so a head's state
// splits by columns with no exchange between the parts.  A CTA holds a slab
// of SW columns of one head's S in registers for the whole sequence, and
// its threads split the slab by row group: thread (rg, cg) keeps rows
// rg*RPT .. rg*RPT+RPT-1 of the slab's columns 2cg and 2cg+1 (RPT*2 floats).
// Two layouts, chosen by the wrapper from B*H and the card's SM count:
//
//   * split: SW = 8, RPT = 4 (dh threads a CTA).  At RWKV-6 3B's B = 1,
//     H = 40, dh = 64 that is 8 slabs a head, 320 CTAs of two warps over
//     132 SMs, where one CTA a head filled 40 SMs with two warps each.  Each
//     CTA stages its head's whole r, k and w rows (8 CTAs read them, from
//     L2) and the slab's 8 columns of v.
//   * whole: SW = min(dh, 64), RPT = dh/4 for dh <= 64 (16 for dh = 128):
//     one slab a head (two at dh = 128), where B*H alone gives enough CTAs
//     and the split layout's repeated r/k/w reads would cost more than its
//     finer spread gains.
//
// Each step a thread computes u_i k_i for its rows (u kept in registers),
// then for each of its elements, in the plain version's order,
//     ukv = (u_i k_i) v_j,  acc_j = fmaf(r_i, S_ij + ukv, acc_j),
//     S_ij = fmaf(w_i, S_ij, k_i v_j)
// with acc_j summed over the thread's rows in row order from 0.  So the
// only chain a step carries is one FMA on each S_ij.  The partials go to
// shared memory, and after each run y_j = p_0 + p_1 + ... + p_{RG-1} is
// summed over the row groups in that fixed order and written: only y's
// summation order differs from the plain version.  Runs of RUN steps of r,
// k, w and v (as many as fit the static shared memory: 22 at the split
// layout's dh = 64) are staged with cp.async into two buffers, so run n+1
// loads while run n computes (16-byte copies where every row is 16-byte
// aligned, 4-byte copies otherwise).
//
// Bound on this card.  It moves 5 B T H dh floats (r, k, v, w, y) plus the
// states: at B = 1, T = 512, H = 40, dh = 64, 26.2 MB, 0.0080 ms at 3.35
// TB/s.  Its operations: about 5 per element and step (two multiplies, an
// add, two FMAs), 0.42 G thread-instructions at that shape, ~14 us at full
// issue on 132 SMs; the split layout adds the staging and the y reduction.
// So the issue rate of the FMA pipes, not the bytes, bounds the prefill; a
// decode step (T = 1) moves the state twice (1.3 MB) and is bound by the
// host's launch.
//
// Measured on an H100 SXM (PERF.md): 0.068 ms at that shape (one
// CTA a head took 0.198), 0.17 ms at B = 4 on one slab a head.  A step
// costs a warp about twice the issue slots of its ~50 instructions, and
// trial builds without the cp.async staging ran 25-35 % faster; holding the
// rows in registers straight from global memory instead, four steps ahead,
// ran twice as slow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 2;   // columns of S a thread holds
constexpr int kSplit = 8;  // slab width of the split layout
constexpr int kBufs = 2;   // runs staged at once: this one and the next

struct WkvArgs {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  long long rb, rt, rh, kb, kt, kh, vb, vt, vh, wb, wt, wh;  // strides
  const float* u;   // (H, DH)
  const float* S0;  // (B, H, DH, DH) or null (zero initial state)
  float* y;         // (B, T, H, DH)
  float* S_out;     // (B, H, DH, DH)
  int T, H;
  bool vec;  // every staged row 16-byte aligned
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One cp.async of P floats (P = 4: 16 bytes, L2 only; P = 1: 4 bytes).
template <int P>
__device__ __forceinline__ void copy(uint32_t dst, const float* src) {
  if constexpr (P == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
}

// Copies `rows` rows of LEN floats (row s at src + s * stride) into the
// row-major dst in pieces of P floats, the CTA's NT threads taking
// pieces NT apart.  NT is a multiple of a row's pieces, so a thread's
// pieces keep one column: each costs the copy and two adds, not an address
// computed anew.  The caller commits the group.
template <int LEN, int NT, int P>
__device__ __forceinline__ void stage_by(float* dst, const float* src,
                                         long long stride, int rows,
                                         int tid) {
  constexpr int Q = LEN / P;  // pieces a row
  static_assert(NT % Q == 0, "a CTA stages whole rows at a time");
  constexpr int DS = NT / Q;  // rows between a thread's pieces
  int s = tid / Q;
  const int c = (tid % Q) * P;
  const float* p = src + s * stride + c;
  uint32_t d = smem(dst + s * LEN + c);
  for (; s < rows; s += DS, p += DS * stride, d += DS * LEN * 4)
    copy<P>(d, p);
}

// stage_by in 16-byte pieces where every staged row is 16-byte aligned
// (vec), else in 4-byte ones.
template <int LEN, int NT>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long stride, int rows, bool vec,
                                      int tid) {
  if (vec)
    stage_by<LEN, NT, 4>(dst, src, stride, rows, tid);
  else
    stage_by<LEN, NT, 1>(dst, src, stride, rows, tid);
}

// Four floats of shared memory (16-byte aligned) into registers.
__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 q = *reinterpret_cast<const float4*>(src);
  dst[0] = q.x;
  dst[1] = q.y;
  dst[2] = q.z;
  dst[3] = q.w;
}

template <int DH, int SW, int RPT>
struct Layout {
  static constexpr int CG = SW / kCols;  // column groups
  static constexpr int RG = DH / RPT;    // row groups
  static constexpr int NT = CG * RG;     // threads a CTA
  static constexpr int SLABS = DH / SW;
  // a step's partials, padded so that the y reduction's reads of four
  // steps at once fall in distinct banks
  static constexpr int PP = RG * SW + (SW < 32 ? SW : 0);
  // steps staged at a time: as many as kBufs buffers of r, k, w and v and
  // one of partials fit in the 48 KB of static shared memory
  static constexpr int RUN = 49152 / (4 * (kBufs * (3 * DH + SW) + PP));
};

template <int DH, int SW, int RPT>
__global__ void __launch_bounds__(Layout<DH, SW, RPT>::NT)
    wkv_kernel(WkvArgs a) {
  using L = Layout<DH, SW, RPT>;
  constexpr int RUN = L::RUN, NT = L::NT, CG = L::CG, RG = L::RG;
  static_assert(RPT % 4 == 0, "rows a thread are read as float4");
  __shared__ __align__(16) float s_r[kBufs][RUN][DH];
  __shared__ __align__(16) float s_k[kBufs][RUN][DH];
  __shared__ __align__(16) float s_w[kBufs][RUN][DH];
  __shared__ __align__(16) float s_v[kBufs][RUN][SW];
  __shared__ __align__(16) float s_p[RUN][L::PP];

  const int bh = blockIdx.x / L::SLABS;
  const int j0 = (blockIdx.x - bh * L::SLABS) * SW;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int tid = threadIdx.x;
  const int cg = tid % CG;
  const int rg = tid / CG;
  const int c0 = cg * kCols;  // first column of the thread, in the slab
  const int i0 = rg * RPT;    // first row of the thread

  const float* rp = a.r + b * a.rb + h * a.rh;
  const float* kp = a.k + b * a.kb + h * a.kh;
  const float* wp = a.w + b * a.wb + h * a.wh;
  const float* vp = a.v + b * a.vb + h * a.vh + j0;
  const long long yt = (long long)a.H * DH;
  float* yp = a.y + (long long)b * a.T * yt + (long long)h * DH + j0;
  const int runs = (a.T + RUN - 1) / RUN;

  // Stages run `run` (nothing past the last; the group is still committed,
  // so that every thread's groups count alike).
  auto issue = [&](int run) {
    const int buf = run % kBufs;
    const long long t0 = (long long)run * RUN;
    const int n = min(RUN, a.T - (int)t0);
    stage<DH, NT>(&s_r[buf][0][0], rp + t0 * a.rt, a.rt, n, a.vec, tid);
    stage<DH, NT>(&s_k[buf][0][0], kp + t0 * a.kt, a.kt, n, a.vec, tid);
    stage<DH, NT>(&s_w[buf][0][0], wp + t0 * a.wt, a.wt, n, a.vec, tid);
    stage<SW, NT>(&s_v[buf][0][0], vp + t0 * a.vt, a.vt, n, a.vec, tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int run = 0; run < kBufs - 1; ++run) issue(run);

  float S[RPT][kCols], u[RPT];
  const long long sbase = (long long)bh * DH * DH + j0 + c0;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    u[q] = a.u[h * DH + i0 + q];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      S[q][c] = a.S0 ? a.S0[sbase + (i0 + q) * DH + c] : 0.f;
  }

  for (int run = 0; run < runs; ++run) {
    const int buf = run % kBufs;
    const int n = min(RUN, a.T - run * RUN);
    // Every thread left the previous run's steps (the barrier before its
    // reduction), so that run's buffer is free for run + kBufs - 1.
    issue(run + kBufs - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kBufs - 1) : "memory");
    __syncthreads();  // run's rows landed; the last reduction's reads done
#pragma unroll 2
    for (int s = 0; s < n; ++s) {
      float rv[RPT], kv[RPT], wv[RPT];
#pragma unroll
      for (int q = 0; q < RPT; q += 4) {
        load4(rv + q, &s_r[buf][s][i0 + q]);
        load4(kv + q, &s_k[buf][s][i0 + q]);
        load4(wv + q, &s_w[buf][s][i0 + q]);
      }
      const float2 vj = *reinterpret_cast<const float2*>(&s_v[buf][s][c0]);
      const float v2[kCols] = {vj.x, vj.y};
      float acc[kCols] = {0.f, 0.f};
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const float uk = u[q] * kv[q];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float ukv = uk * v2[c];
          acc[c] = fmaf(rv[q], S[q][c] + ukv, acc[c]);
          S[q][c] = fmaf(wv[q], S[q][c], kv[q] * v2[c]);
        }
      }
      *reinterpret_cast<float2*>(&s_p[s][rg * SW + c0]) =
          make_float2(acc[0], acc[1]);
    }
    __syncthreads();  // partials complete
    for (int o = tid; o < n * SW; o += NT) {
      const int s = o / SW;
      const int c = o - s * SW;
      float sum = s_p[s][c];
#pragma unroll
      for (int g = 1; g < RG; ++g) sum += s_p[s][g * SW + c];
      yp[(long long)(run * RUN + s) * yt + c] = sum;
    }
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q)
    *reinterpret_cast<float2*>(a.S_out + sbase + (i0 + q) * DH) =
        make_float2(S[q][0], S[q][1]);
}

template <int DH, int SW, int RPT>
cudaError_t launch(const WkvArgs& a, int BH, cudaStream_t stream) {
  using L = Layout<DH, SW, RPT>;
  wkv_kernel<DH, SW, RPT><<<BH * L::SLABS, L::NT, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(const WkvArgs& a, int BH, bool split,
                      cudaStream_t stream) {
  if (split) return launch<DH, kSplit, 4>(a, BH, stream);
  constexpr int SW = DH < 64 ? DH : 64;
  constexpr int RPT = DH < 64 ? DH / 4 : 16;
  return launch<DH, SW, RPT>(a, BH, stream);
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The launch's arguments, packed by the wrapper as 25 int64 (one foreign
// argument, not 25: the decode path pays for each).  r/k/v/w: fp32 (B, T,
// H, dh) views with unit last stride and the (b, t, h) strides given, in
// elements; u: (H, dh) fp32; S0: (B, H, dh, dh) fp32 or 0 (zero initial
// state); y: (B, T, H, dh) fp32; S_out: (B, H, dh, dh) fp32.  dh in {16,
// 32, 64, 128}; B*H >= 1, T >= 1 (the wrapper checks).  `split` picks the
// layout (8-column slabs, or one slab a head).
struct WkvCall {
  long long r, k, v, w, u, S0, y, S_out;
  long long rb, rt, rh, kb, kt, kh, vb, vt, vh, wb, wt, wh;
  long long B, T, H, dh, split;
};

// Returns the CUDA error of the launch (0 on success).
extern "C" int rwkv6_wkv(const WkvCall* c, void* stream) {
  auto f = [](long long p) { return reinterpret_cast<const float*>(p); };
  WkvArgs a;
  a.r = f(c->r);
  a.k = f(c->k);
  a.v = f(c->v);
  a.w = f(c->w);
  a.rb = c->rb;
  a.rt = c->rt;
  a.rh = c->rh;
  a.kb = c->kb;
  a.kt = c->kt;
  a.kh = c->kh;
  a.vb = c->vb;
  a.vt = c->vt;
  a.vh = c->vh;
  a.wb = c->wb;
  a.wt = c->wt;
  a.wh = c->wh;
  a.u = f(c->u);
  a.S0 = f(c->S0);
  a.y = reinterpret_cast<float*>(c->y);
  a.S_out = reinterpret_cast<float*>(c->S_out);
  a.T = (int)c->T;
  a.H = (int)c->H;
  a.vec = aligned(a.r) && aligned(a.k) && aligned(a.v) && aligned(a.w) &&
          ((a.rb | a.rt | a.rh | a.kb | a.kt | a.kh | a.vb | a.vt | a.vh |
            a.wb | a.wt | a.wh) & 3) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = (int)(c->B * c->H);
  const bool split = c->split != 0;
  switch (c->dh) {
    case 16: return (int)launch_dh<16>(a, BH, split, s);
    case 32: return (int)launch_dh<32>(a, BH, split, s);
    case 64: return (int)launch_dh<64>(a, BH, split, s);
    case 128: return (int)launch_dh<128>(a, BH, split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
