// Causal (and non-causal) flash attention for Hopper (sm_90a): bf16 on the
// tensor cores (wgmma), fp32 on the CUDA cores.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/flash_attention.py
// (:29, entry flash_attention_bhsd :71, pallas_call :83), and computes the
// contract of that kernel and of its oracle ref.flash_attention
// (src/repro/kernels/ref.py:111):
//
//     o[b, s, h] = softmax_k( q[b, s, h] . k[b, k, hk] * dh^-0.5 ) v[b, k, hk]
//
// over keys k <= s when causal, with hk = h / (H / Hk) (grouped-query
// attention mapped here instead of the repeat that ops.flash_attention makes
// upstream of the Pallas kernel).  q is (B, S, H, dh) and k/v are
// (B, S, Hk, dh), contiguous, in bf16 or fp32; o is (B, S, H, dh) in the
// input dtype.  Scores, the running max, the denominator and the accumulator
// are fp32, as the Pallas kernel's (it casts q, k, v to fp32 and keeps p in
// fp32 for the second product).  Key tiles above the causal diagonal are
// never loaded, the heaviest query tiles run first, and bound checks on the
// sequence replace the Pallas kernel's S % block == 0, so any S runs.
//
// Bound on this card.  Causal attention does 2 B H S (S+1) dh flops (the two
// products over the visible half) and moves q, k, v and o once.  At B = 1,
// H = 32 / Hk = 8, dh = 128 that is 0.0031 ms at S = 512 (bytes) and 0.139
// ms at S = 4096 (bf16 tensor-core operations, 989 TFLOP/s).
//
// bf16: the tensor-core kernel (namespace tc).  A block of two consumer
// warpgroups takes 128 query rows of one head, 64 rows a warpgroup.
//  * S = Q K^T runs on wgmma m64n64k16 (bf16 in, fp32 accumulator) with Q
//    and K read from shared memory through descriptors.  bf16 products are
//    exact in fp32, so this is the Pallas kernel's fp32 dot up to the order
//    of summation.
//  * The online softmax runs in the accumulator's register layout: a thread
//    holds two rows' 16 scores, row max and sum close with two quad
//    shuffles, exp is IEEE expf, the scale dh^-0.5 multiplies S, and the
//    causal diagonal is masked in registers.
//  * O += P V runs on wgmma with A = P from registers (the S accumulator's
//    layout is the A fragment's, so no shuffle) and B = V from shared memory,
//    read MN-major through the descriptor's transpose bit.  P stays fp32 in
//    effect: P = P_hi + P_lo with P_hi = bf16(P), P_lo = bf16(P - P_hi), two
//    wgmmas, so P keeps about 2^-17 of its value (one bf16 cast would round
//    it at 2^-9, a precision change against the Pallas kernel).
//  * Tiles live in shared memory in the 128-byte swizzle wgmma reads: rows of
//    64 bf16 (128 B), 16-byte chunk c of row r at chunk c ^ (r % 8), a
//    1024-byte atom per 8 rows, 64-column regions side by side (dh = 128 is
//    two).  Head sizes 16 and 32 are zero-padded to 64 columns in shared
//    memory (zeros add nothing to a dot).  V tiles need no transpose: a
//    [key][d] tile is both the K-major layout of K and the MN-major layout
//    of V, and each P V wgmma takes one 64-column region (N = 64), so the
//    descriptor's two strides are the 8-row-group stride only.
//  * Loads are cp.async, 16 bytes a thread, into a ring of two K/V stages:
//    tile t+1 is in flight while tile t is multiplied (a third stage, and
//    issuing tile t+1's scores before tile t's P V so that the softmax
//    overlaps the tensor cores, were tried and were not faster: ptxas
//    serializes the overlapped wgmmas, C7514).
//    Rows past S are zero-filled; K/V rows of a head are Hk*dh elements
//    apart and are read there, with no copy on the host.
//
// fp32: the CUDA-core kernel (flash_fwd_f32), the first port's design, kept
// since the port keeps TF32 off.  One block of 256 threads per (query tile
// of 64 rows, head, batch row).  The block stages its query tile, then each
// visible 64-key tile of K and V, in shared memory as fp32 (rows padded by
// one float so the column-wise reads hit distinct banks).  Thread (ty, tx)
// of the 16 x 16 grid owns query rows ty + 16 i (i < 4): it computes the
// 4 x 4 scores against keys tx + 16 j, reduces each row's max and sum over
// the 16 lanes that share the row (shuffles inside a half-warp), and keeps
// the row's running max, denominator and a 4 x dh/16 slice of the output
// accumulator (columns tx + 16 j) in registers.  Its products are fp32 FMAs
// fed from shared memory (8 loads per 16 FMAs in the score product).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

template <int DH>
constexpr int smem_floats() {
  return kBQ * (DH + 1) + kBK * (DH + 1) + kBK * DH + kBQ * (kBK + 1);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S,
              int H, int Hk, float scale, int causal) {
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
  const float* qb = q + (long long)b * S * q_row + (long long)h * DH;
  const float* kb = k + (long long)b * S * kv_row + (long long)hk * DH;
  const float* vb = v + (long long)b * S * kv_row + (long long)hk * DH;
  float* ob = o + (long long)b * S * q_row + (long long)h * DH;

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, d = e - (e / DH) * DH;
    const int s = q0 + r;
    Qs[r * QS + d] = s < S ? qb[(long long)s * q_row + d] : 0.f;
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
      Ks[r * QS + d] = in ? kb[(long long)s * kv_row + d] : 0.f;
      Vs[r * DH + d] = in ? vb[(long long)s * kv_row + d] : 0.f;
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
      ob[(long long)r * q_row + tx + 16 * jj] = acc[i][jj] / l[i];
  }
}


namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;   // query rows of a block: two warpgroups of 64
constexpr int kKeys = 64;    // keys of a K/V tile
constexpr int kStages = 2;   // K/V tiles in the ring
constexpr int kThreads = 256;

template <int DH>
__host__ __device__ constexpr int padded() {
  return DH < 64 ? 64 : DH;
}
template <int DH>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * padded<DH>() * 2;
}
// Q, the K and V stages, and room to align the base to 1024 bytes
template <int DH>
__host__ __device__ constexpr int smem_bytes() {
  return tile_bytes<DH>(kRows) + 2 * kStages * tile_bytes<DH>(kKeys) + 1024;
}

// Byte offset of 16-byte chunk `ch` (over the padded width) of row `r` in a
// swizzled tile of `rows` rows: 64-column regions of rows * 128 bytes.
__device__ __forceinline__ uint32_t swz(int rows, int r, int ch) {
  return (uint32_t)((ch >> 3) * rows * 128 + r * 128 +
                    (((ch & 7) ^ (r & 7)) << 4));
}

// A shared-memory matrix descriptor for the 128-byte swizzle: start address,
// both byte offsets 1024 (the 8-row-group stride; the other stride is not
// read for these shapes), layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wg_arrive() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups are pending (older first).
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The 32 fp32 accumulator operands (%0..%31) of an m64n64 wgmma.
#define WG_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_D32_OUT(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (+)= A B, m64n64k16, A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32_OUT(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16, A from registers, B MN-major in shared memory.
__device__ __forceinline__ void mma_rs_tb(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// cp.async `rows` rows of width DH from row s0 of a (., row_stride) head
// slice into a swizzled tile; rows at or past S are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile(uint32_t dst, int rows,
                                          const bf16* g, long long row_stride,
                                          int s0, int S) {
  constexpr int kChunks = DH / 8;
  for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
    const int r = e / kChunks, ch = e - (e / kChunks) * kChunks;
    const bool in = s0 + r < S;
    cp16(dst + swz(rows, r, ch),
         g + (long long)(in ? s0 + r : 0) * row_stride + ch * 8, in);
  }
}

// Issues S = Q K^T of one key tile for this warpgroup's 64 query rows
// (asynchronous: the caller commits and waits).
template <int DH>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_tile,
                                         uint32_t k_tile) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence_regs(s);
  wg_arrive();
#pragma unroll
  for (int ks = 0; ks < padded<DH>() / 16; ++ks)
    mma_ss(s, desc(q_tile + (ks >> 2) * (kRows * 128) + (ks & 3) * 32),
           desc(k_tile + (ks >> 2) * (kKeys * 128) + (ks & 3) * 32), ks > 0);
}

// Issues O += P V of one key tile, P = P_hi + P_lo from registers.
template <int NR>
__device__ __forceinline__ void issue_pv(float (&acc)[NR][32],
                                         const uint32_t (&ph)[4][4],
                                         const uint32_t (&pl)[4][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int c = 0; c < NR; ++c) fence_regs(acc[c]);
  wg_arrive();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      const uint64_t vd = desc(v_tile + c * (kKeys * 128) + kc * (16 * 128));
      mma_rs_tb(acc[c], ph[kc], vd);
      mma_rs_tb(acc[c], pl[kc], vd);
    }
}

// This thread's two query rows of the online softmax.
struct Rows {
  int a, b;       // query rows
  float m_a, m_b;  // running maxima
  float l_a, l_b;  // running denominators
};

// The online softmax of one score tile in the accumulator's register layout:
// register i holds row (i & 2 ? b : a), key k0 + 8 (i >> 2) + 2 (lane & 3) +
// (i & 1).  Masks, scales, updates the row maxima and denominators, leaves
// p = exp(s - m) in s and returns the accumulator's correction factors.
__device__ __forceinline__ void softmax_tile(float (&s)[32], int k0, int S,
                                             int causal, float scale,
                                             Rows& rw, float& corr_a,
                                             float& corr_b) {
  const int lane = threadIdx.x & 31;
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    const int row = (i & 2) ? rw.b : rw.a;
    const bool ok = col < S && (!causal || col <= row);
    s[i] = ok ? s[i] * scale : -INFINITY;
    if (i & 2)
      mx_b = fmaxf(mx_b, s[i]);
    else
      mx_a = fmaxf(mx_a, s[i]);
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(rw.m_a, mx_a), mn_b = fmaxf(rw.m_b, mx_b);
  corr_a = rw.m_a == -INFINITY ? 0.f : expf(rw.m_a - mn_a);
  corr_b = rw.m_b == -INFINITY ? 0.f : expf(rw.m_b - mn_b);
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float mn = (i & 2) ? mn_b : mn_a;
    s[i] = s[i] == -INFINITY ? 0.f : expf(s[i] - mn);
    if (i & 2)
      sum_b += s[i];
    else
      sum_a += s[i];
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
  }
  rw.l_a = rw.l_a * corr_a + sum_a;
  rw.l_b = rw.l_b * corr_b + sum_b;
  rw.m_a = mn_a;
  rw.m_b = mn_b;
}

// P = P_hi + P_lo as A fragments: k16 chunk kc holds keys 16 kc .. 16 kc +
// 15, register t the pair (p[8 kc + 2 t], p[8 kc + 2 t + 1]).
__device__ __forceinline__ void split_p(const float (&p)[32],
                                        uint32_t (&ph)[4][4],
                                        uint32_t (&pl)[4][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float x0 = p[8 * kc + 2 * t], x1 = p[8 * kc + 2 * t + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(hi);
      ph[kc][t] = bits(hi);
      pl[kc][t] = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                int H, int Hk, float scale, int causal) {
  constexpr int NR = padded<DH>() / 64;  // 64-column regions
  constexpr uint32_t QB = tile_bytes<DH>(kRows);
  constexpr uint32_t KB = tile_bytes<DH>(kKeys);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + QB;             // kStages K tiles
  const uint32_t sV = sK + kStages * KB;   // kStages V tiles

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int n_q = (S + kRows - 1) / kRows;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hk);
  const long long q_row = (long long)H * DH;
  const long long kv_row = (long long)Hk * DH;
  const bf16* qb = q + (long long)b * S * q_row + (long long)h * DH;
  const bf16* kb = k + (long long)b * S * kv_row + (long long)hk * DH;
  const bf16* vb = v + (long long)b * S * kv_row + (long long)hk * DH;
  bf16* ob = o + (long long)b * S * q_row + (long long)h * DH;

  if constexpr (DH < 64) {  // padding columns: zeroed once, cp.async never
                            // writes them
    constexpr int kPad = 8 - DH / 8;
    const uint4 z = make_uint4(0, 0, 0, 0);
    for (int e = tid; e < (kRows + 2 * kStages * kKeys) * kPad;
         e += kThreads) {
      const int r = e / kPad, ch = DH / 8 + e % kPad;
      const uint32_t a = r < kRows ? sQ + swz(kRows, r, ch)
                                   : sK + ((r - kRows) / kKeys) * KB +
                                         swz(kKeys, (r - kRows) % kKeys, ch);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
                   "r"(z.x), "r"(z.y), "r"(z.z), "r"(z.w)
                   : "memory");
    }
  }

  // the ring: tile t in stage t % kStages, kStages - 1 tiles ahead; one
  // cp.async group per tile (empty past the last)
  const int kv_end = causal ? min(S, q0 + kRows) : S;
  const int n_kt = (kv_end + kKeys - 1) / kKeys;
  load_tile<DH>(sQ, kRows, qb, q_row, q0, S);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_kt) {
      load_tile<DH>(sK + t * KB, kKeys, kb, kv_row, t * kKeys, S);
      load_tile<DH>(sV + t * KB, kKeys, vb, kv_row, t * kKeys, S);
    }
    cp_commit();
  }

  // this thread's two rows of its warpgroup's 64 (the accumulator layout)
  const int qw0 = q0 + 64 * wg;
  const uint32_t sQw = sQ + wg * (64 * 128);
  Rows rw;
  rw.a = qw0 + 16 * warp + (lane >> 2);
  rw.b = rw.a + 8;
  rw.m_a = rw.m_b = -INFINITY;
  rw.l_a = rw.l_b = 0.f;
  float acc[NR][32];
#pragma unroll
  for (int c = 0; c < NR; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  int st = 0;  // stage of tile kt
  for (int kt = 0; kt < n_kt; ++kt) {
    // refill the stage the last tile released (at the last barrier)
    const int ahead = kt + kStages - 1;
    const int ast = st == 0 ? kStages - 1 : st - 1;
    if (ahead < n_kt) {
      load_tile<DH>(sK + ast * KB, kKeys, kb, kv_row, ahead * kKeys, S);
      load_tile<DH>(sV + ast * KB, kKeys, vb, kv_row, ahead * kKeys, S);
    }
    cp_commit();
    cp_wait<kStages - 1>();  // tile kt has landed
    // make this thread's cp.async writes visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (!causal || kt * kKeys <= qw0 + 63) {  // uniform over the warpgroup
      float s[32];
      issue_qk<DH>(s, sQw, sK + st * KB);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      float corr_a, corr_b;
      softmax_tile(s, kt * kKeys, S, causal, scale, rw, corr_a, corr_b);
      uint32_t ph[4][4], pl[4][4];
      split_p(s, ph, pl);
#pragma unroll
      for (int c = 0; c < NR; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] *= (i & 2) ? corr_b : corr_a;
      issue_pv<NR>(acc, ph, pl, sV + st * KB);
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int c = 0; c < NR; ++c) fence_regs(acc[c]);
    }
    __syncthreads();  // every warpgroup is done with stage st
    st = st + 1 == kStages ? 0 : st + 1;
  }

#pragma unroll
  for (int c = 0; c < NR; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = (i & 2) ? rw.b : rw.a;
      const int col = 64 * c + 8 * (i >> 2) + 2 * (lane & 3);
      if (row >= S || col >= DH) continue;
      const float l = (i & 2) ? rw.l_b : rw.l_a;
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * q_row + col) =
          __floats2bfloat162_rn(acc[c][i] / l, acc[c][i + 1] / l);
    }
}

}  // namespace tc

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int Hk, float scale, int causal,
                       cudaStream_t stream) {
  const int smem = smem_floats<DH>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_f32<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, Hk, scale,
      causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int Hk, float scale, int causal,
                        cudaStream_t stream) {
  constexpr int smem = tc::smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      tc::flash_fwd_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + tc::kRows - 1) / tc::kRows, H, B);
  tc::flash_fwd_wgmma<DH><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, H, Hk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q: (B, S, H, dh), k/v: (B, S, Hk, dh), o: (B, S, H, dh), all contiguous,
// fp32 (bf16 == 0: the CUDA-core kernel) or bf16 (bf16 == 1: the tensor-core
// kernel; every pointer 16-byte aligned).  dh in {16, 32, 64, 128}; H % Hk ==
// 0; B, S >= 1; B, H <= 65535 (the wrapper checks).  scale multiplies the
// scores (dh^-0.5 for the model).  Returns the CUDA error of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int Hk, int dh, int bf16,
                                   float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh * 2 + (bf16 ? 1 : 0)) {
    case 32:
      return (int)launch_f32<16>(q, k, v, o, B, S, H, Hk, scale,
                                 causal, s);
    case 64:
      return (int)launch_f32<32>(q, k, v, o, B, S, H, Hk, scale,
                                 causal, s);
    case 128:
      return (int)launch_f32<64>(q, k, v, o, B, S, H, Hk, scale,
                                 causal, s);
    case 256:
      return (int)launch_f32<128>(q, k, v, o, B, S, H, Hk, scale,
                                  causal, s);
    case 33:
      return (int)launch_bf16<16>(q, k, v, o, B, S, H, Hk, scale,
                                  causal, s);
    case 65:
      return (int)launch_bf16<32>(q, k, v, o, B, S, H, Hk, scale,
                                  causal, s);
    case 129:
      return (int)launch_bf16<64>(q, k, v, o, B, S, H, Hk, scale,
                                  causal, s);
    case 257:
      return (int)launch_bf16<128>(q, k, v, o, B, S, H, Hk, scale,
                                   causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
