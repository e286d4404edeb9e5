// Fused surrogate-MLP forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/mogd_mlp.py
// (:33), launched at :63 by `_forward` behind `mlp_forward_fused` (:107).
// For x (B, D_in) and a ReLU MLP with a linear head (weights w_l (d_l,
// d_{l+1}) and biases b_l (d_{l+1},), depth 1 to 32, any widths) it writes
//
//     h_0 = x,  h_{l+1} = relu(h_l w_l + b_l)  (hidden),  out = h_L  (head)
//
// as (B, D_out) fp32.  The backward pass (the reference's `_fused_bwd`,
// :83, plain jnp there) stays in PyTorch: `kernels/mogd_mlp.py`.
//
// What bounds it.  The work is 2*B*sum(d_l*d_{l+1}) fp32 FLOPs against
// (B*(D_in + D_out) + sum(d_l*d_{l+1} + d_{l+1}))*4 bytes.  At the paper's
// shape (13 -> 128 x 4 -> 1, 50,944 weights, 204 KB) that is 0.41 MFLOP a
// row: at 4,096 rows 417 MFLOP, 6.2 us at the fp32 FMA peak of an H100 SXM
// (67 TFLOP/s outside the tensor cores).  The model server's launches are
// 30 to 409 rows (245 for most; PERF.md), where the bound is under 1 us and
// a launch is bound by latency instead: every block must have the weights
// on chip before its last layer, and the copy from L2 runs at ~14 B/cycle
// an SM (measured), ~14k cycles for the 204 KB; then each tile's 5 layers
// run one after the other.
//
// Design.  One body.  A block is 8 consumer warps and one producer warp;
// the grid is one block a tile of 8 rows up to one block an SM, each block
// walking its tiles (`kernels/mogd_mlp.py` `layout`).
// - Weights on chip.  At the paper's shape every weight stays in shared
//   memory for the whole launch (51,712 padded floats beside two 8-row
//   activation tiles, two x tiles, the biases and 1,024 floats of partial
//   sums: 220 KB).  The producer issues every layer's bulk copy (one
//   `cp.async.bulk` a layer, on its own mbarrier) and the first x tile
//   within a few hundred cycles of the launch, without waiting, so a layer
//   starts as soon as its own weights have landed.  Where the weights do
//   not fit (a 1,000-wide layer), the same chunks stream through a ring of
//   two slots (a full and an empty barrier a slot): column blocks by as
//   many k rows as a slot holds, the next in flight while the current one
//   multiplies.  Rows that are not 16-byte aligned (widths that are not a
//   multiple of 4) and x use 4-byte `cp.async` with the barrier's
//   `cp.async.mbarrier.arrive`; rows past K and columns past N are 0.
// - Products.  A lane holds 8 rows x 4 columns (one column quad) over the
//   k-blocks kb = p, p + P, ... of its layer's inputs (P = 8 for a hidden
//   layer, 32 for the head, so the head does not run as one long chain).
//   A warp is 2^lw split lanes x (32 >> lw) consecutive quads, so the 8
//   lanes of a quarter-warp read 8 different quads of one weight row (no
//   bank conflict, and no swizzle that a bulk copy could not write) and
//   share one activation read; the rest of the split is over warps.
//   Per k-block a lane does 12 16-byte shared loads for 128 FMAs.
// - Sums.  Each lane's partial is an fmaf chain in input order; the P
//   partials of a quad are added in a fixed tree: a reduce-scatter by
//   shuffles over the warp's split lanes (((p0 + p1) + (p2 + p3)) for a
//   hidden layer), then the other warps' (k-groups') sums in group order
//   through shared memory.  This order differs from the plain version's
//   (cuBLAS); the tolerances of the reference tests hold (2e-5, 3e-5 at
//   the paper shape).  Then + bias and ReLU (NaN kept, as torch.relu keeps
//   it); no TF32, no fast math, -fmad=false like the other kernels.
//
// What held it back (PERF.md §6, per tile of a hidden layer, a clock64
// trace on the card): ~2.05k cycles of products (12 shared loads a
// k-block, the shared-memory pipe), ~1.3k for the reduce, the cross-warp
// sums and the barriers' skew, ~0.7k of per-layer set-up; at the path's
// sizes the copy of the last hidden layer's weights ends near the 18k-th
// cycle.
//
// The layout not kept.  (b) The descent's resident layout: a CTA pair in a
// cluster holding halves of each layer's columns, activations exchanged
// through distributed shared memory with one cluster barrier a layer.
// Timed against (a) on an earlier body of this kernel (8 warps issuing
// 16-byte cp.async at the launch, before the producer warp and the bulk
// copies; one call on an NVIDIA H100 80GB HBM3, 700.00 W): device ms (a) /
// (b) 0.0198 / 0.0179 at 30 rows, 0.0200 / 0.0182 at 245, 0.0201 / 0.0183
// at 409, 0.0477 / 0.0918 at 4,096.  (b) halved each CTA's copy and
// products but gained under 10 % at the path's sizes and took twice as
// long at 4,096 rows (its shorter chains and cluster barriers on every
// layer), so (a) is kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 256;             // 8 warps run the products
constexpr int kThreads = kConsumers + 32;   // and one warp every copy
constexpr int kRows = 8;  // rows of a tile, and of every lane's tile
constexpr int kMaxLayers = 32;
constexpr int kMaxDevices = 64;

struct Net {
  const float* x;
  float* out;
  int B, n_layers, slots, slot, stride, nbar, part, bias;
  int dims[kMaxLayers + 1];
  int ncw[kMaxLayers];  // column block of each layer (a multiple of 4)
  int kc[kMaxLayers];   // k rows of a chunk (a multiple of 4)
  int lp[kMaxLayers];   // log2 of the lanes that split a column quad's K
  int lw[kMaxLayers];   // log2 of those lanes inside one warp
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
};

// A layer as the consumers read it, staged in shared memory at launch (a
// kernel parameter indexed at run time costs a constant-cache round trip).
struct __align__(16) Stage {
  int bo;  // the layer's biases in the shared bias table
  int K4, N, N4, ncw, kc, lp, lw;
};
static_assert(sizeof(Stage) == 32, "kernels/mogd_mlp.py STAGE_BYTES");

// A position in the ring of weight slots (streaming): the slot, and the
// parity of the pass through the ring, which is the parity of the slot's
// barrier phase.
struct Ring {
  int slot = 0, phase = 0;
  __device__ __forceinline__ void advance(int slots) {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// The barrier's pending count drops by one once every cp.async this thread
// issued before has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One bulk copy (the Tensor Memory Accelerator's, issued by one thread) of
// `bytes` from global to shared memory, counted on the barrier's tx-count.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Copy k rows [k0, k0 + kr) of columns [c0, c0 + cw) of layer l into dst
// (row-major, row stride cw) over the producer's 32 lanes, and arrive on
// `bar` (count 32) once this lane's share has landed.  Where the layer's
// rows are 16-byte aligned the rows are bulk copies (one for the whole
// chunk when it spans every column); otherwise 4-byte asynchronous copies.
// Rows past K and columns past N are zero-filled.
__device__ __forceinline__ void issue_chunk(const Net& net, int l, int c0,
                                            int cw, int k0, int kr,
                                            float* dst, uint64_t* bar,
                                            int lane) {
  const int K = net.dims[l], N = net.dims[l + 1];
  const float* W = net.w[l];
  int kv = K - k0;  // rows that hold weights
  kv = kv < 0 ? 0 : kv > kr ? kr : kv;
  if ((reinterpret_cast<uintptr_t>(W) & 15) == 0 && (N & 3) == 0) {
    if (lane == 0) mbar_expect_tx(bar, kv * cw * 4);
    __syncwarp();
    if (cw == N) {
      if (lane == 0 && kv > 0)
        bulk_copy(dst, W + (long long)k0 * N, kv * N * 4, bar);
    } else {
      for (int r = lane; r < kv; r += 32)
        bulk_copy(dst + r * cw, W + (long long)(k0 + r) * N + c0, cw * 4,
                  bar);
    }
    for (int e = kv * cw + lane; e < kr * cw; e += 32)
      cp_async4(dst + e, W, 0);
  } else {
    for (int e = lane; e < kr * cw; e += 32) {
      const int r = e / cw, k = k0 + r, col = c0 + e - r * cw;
      const bool in = k < K && col < N;
      cp_async4(dst + e, in ? W + (long long)k * N + col : W, in ? 4 : 0);
    }
  }
  cp_async_arrive(bar);
}

// Copy the 8 rows of x from row0 (rows past B and columns past D are 0)
// into dst, row stride D4, and arrive on `bar` once they have landed.
__device__ __forceinline__ void issue_x(const Net& net, long long row0,
                                        float* dst, uint64_t* bar,
                                        int lane) {
  const int D = net.dims[0], D4 = round4(D);
  for (int e = lane; e < kRows * D4; e += 32) {
    const int r = e / D4, d = e - r * D4;
    const bool in = row0 + r < net.B && d < D;
    cp_async4(dst + e, in ? net.x + (row0 + r) * D + d : net.x, in ? 4 : 0);
  }
  cp_async_arrive(bar);
}

// upper ? a : b, selected as values: a select between two elements of the
// accumulator array must not become a select of their addresses, which
// would index the array at run time and move it to local memory.
__device__ __forceinline__ float pick(bool upper, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %1, 0;\n\t"
      "selp.f32 %0, %2, %3, p;\n\t}"
      : "=f"(r)
      : "r"((int)upper), "f"(a), "f"(b));
  return r;
}

// Where a column quad's sums go: bias, then ReLU into the next activation
// tile, or the head's bias into out.  b0..b3: the quad's biases (0 past N),
// read from the shared bias table before the products.
struct Epilogue {
  float* out;
  float* nxt;
  long long row0;
  int B, N, S, col0;
  float b0, b1, b2, b3;
  bool head, on;
};

// One round of the reduce-scatter: a lane keeps the half of its 2*HALF
// sums picked by `upper` and adds its partner's (lane ^ MASK) to them.
template <int HALF, int MASK>
__device__ __forceinline__ void halve(float (&v)[32], bool upper) {
#pragma unroll
  for (int e = 0; e < HALF; ++e) {
    const float send = pick(upper, v[e], v[e + HALF]);
    const float keep = pick(upper, v[e + HALF], v[e]);
    v[e] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
  }
}

// The end of a column block, for 2^LW of a quad's split lanes in each warp
// (lane = pin * (32 >> LW) + quad) and `pout` warps (k-groups) a quad:
// reduce-scatter over the warp's split lanes (after round r a lane keeps
// the half of its sums picked by bit r of pin, added to its partner's),
// then, with more than one k-group, every other group's sums added to
// group 0's through `part` in group order, then bias and ReLU (or the
// head's bias) and the store.  Every consumer thread calls it (it holds the
// consumers' barrier when pout > 1).
// A lane's place in its column block's split: its split lane in the warp
// (pin), its k-group (kg) of pout, and its place (slot) among the `lanes`
// lanes of one k-group; `active`: this warp holds a k-group.
struct Split {
  int pin, kg, pout, slot, lanes;
  bool active;
};

template <int LW>
__device__ __forceinline__ void finish(float (&v)[32], const Split& sp,
                                       float* part, const Epilogue& ep) {
  constexpr int E = 32 >> LW;  // sums a lane keeps
  const int pin = sp.pin, kg = sp.kg, pout = sp.pout, slot = sp.slot;
  const int lanes = sp.lanes;
  const bool active = sp.active;
  if (active) {
    if constexpr (LW > 0) halve<16, (1 << (5 - LW))>(v, pin & 1);
    if constexpr (LW > 1) halve<8, (1 << (6 - LW))>(v, (pin >> 1) & 1);
    if constexpr (LW > 2) halve<4, (1 << (7 - LW))>(v, (pin >> 2) & 1);
    if constexpr (LW > 3) halve<2, (1 << (8 - LW))>(v, (pin >> 3) & 1);
    if constexpr (LW > 4) halve<1, (1 << (9 - LW))>(v, (pin >> 4) & 1);
  }
  if (pout > 1) {
    if (active && kg > 0) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        part[((kg - 1) * lanes + slot) * E + e] = v[e];
    }
    consumers_sync();
    if (active && kg == 0) {
      for (int g = 1; g < pout; ++g) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          v[e] += part[((g - 1) * lanes + slot) * E + e];
      }
    }
  }
  if (!active || kg > 0 || !ep.on) return;
  int o0 = 0;  // this lane's first sum: row o0 / 4, column o0 % 4
#pragma unroll
  for (int r = 0; r < LW; ++r) o0 += ((pin >> r) & 1) * (16 >> r);
  if constexpr (E >= 4) {
    // whole rows of the quad: bias in order, one 16-byte store a row
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const int r = (o0 + e) >> 2;
      float y0 = v[e] + ep.b0, y1 = v[e + 1] + ep.b1;
      float y2 = v[e + 2] + ep.b2, y3 = v[e + 3] + ep.b3;
      if (ep.head) {
        if (ep.row0 + r < ep.B) {
          float* o = ep.out + (ep.row0 + r) * ep.N + ep.col0;
          const int n = ep.N - ep.col0;  // columns of the quad that exist
          o[0] = y0;
          if (n > 1) o[1] = y1;
          if (n > 2) o[2] = y2;
          if (n > 3) o[3] = y3;
        }
        continue;
      }
      // torch.relu (NaN stays NaN); padding columns stay exactly 0
      const int n = ep.N - ep.col0;
      y0 = y0 < 0.0f ? 0.0f : y0;
      y1 = n <= 1 || y1 < 0.0f ? 0.0f : y1;
      y2 = n <= 2 || y2 < 0.0f ? 0.0f : y2;
      y3 = n <= 3 || y3 < 0.0f ? 0.0f : y3;
      *reinterpret_cast<float4*>(ep.nxt + r * ep.S + ep.col0) =
          make_float4(y0, y1, y2, y3);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int o = o0 + e, r = o >> 2, c = o & 3, col = ep.col0 + c;
      const float bias = c == 0 ? ep.b0 : c == 1 ? ep.b1 : c == 2 ? ep.b2
                                                                  : ep.b3;
      if (ep.head) {
        if (col < ep.N && ep.row0 + r < ep.B)
          ep.out[(ep.row0 + r) * ep.N + col] = v[e] + bias;
        continue;
      }
      const float y = v[e] + bias;  // padding columns stay exactly 0
      ep.nxt[r * ep.S + col] = col >= ep.N || y < 0.0f ? 0.0f : y;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_forward_kernel(const Net net) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int L = net.n_layers;
  const int tiles = (net.B + kRows - 1) / kRows;
  const int my_tiles =
      (int)blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (my_tiles == 0) return;  // (the wrapper's grid has a tile for each)
  const bool resident = net.slots == 0;
  const int D4 = round4(net.dims[0]), S = net.stride;
  // [barriers][stages][x tiles x 2][activation tiles x 2][partials]
  // [biases][weights]
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* const xfull = bars;       // x tile landed (x 2)
  uint64_t* const xempty = bars + 2;  // x tile read (x 2)
  uint64_t* const full = bars + 4;    // chunk landed (a chunk or a slot)
  uint64_t* const empty = full + net.slots;  // slot read (streaming)
  Stage* const stage = reinterpret_cast<Stage*>(bars + net.nbar);
  float* const xbuf = reinterpret_cast<float*>(stage + L);
  float* const hbuf = xbuf + 2 * kRows * D4;
  float* const part = hbuf + 2 * kRows * S;
  float* const sbias = part + net.part;
  float* const wmem = sbias + net.bias;

  if (tid == 0) {
    mbar_init(xfull, 32);
    mbar_init(xfull + 1, 32);
    mbar_init(xempty, 1);
    mbar_init(xempty + 1, 1);
    for (int i = 4; i < net.nbar; ++i)
      mbar_init(bars + i,
                resident || i < 4 + net.slots ? 32 : kConsumers / 32);
    // the barriers are seen by the bulk copies' async proxy
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int l = tid; l < L; l += kThreads) {
    Stage s;
    s.bo = 0;
    for (int i = 0; i < l; ++i) s.bo += round4(net.dims[i + 1]);
    s.K4 = round4(net.dims[l]);
    s.N = net.dims[l + 1];
    s.N4 = round4(s.N);
    s.ncw = net.ncw[l];
    s.kc = net.kc[l];
    s.lp = net.lp[l];
    s.lw = net.lw[l];
    stage[l] = s;
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer: every chunk of weights, once (resident) or for every
    // tile (streaming), in the order the consumers use them, and every
    // tile's x; each chunk is one phase of its barrier.  Bulk copies do not
    // block it, so the first tile's x and all resident weights are in
    // flight within a few hundred cycles of the launch.
    const int lane = tid - kConsumers;
    // the biases, zero past N, land with the first x tile
    for (int l = 0; l < L; ++l) {
      const Stage st = stage[l];
      for (int e = lane; e < st.N4; e += 32)
        cp_async4(sbias + st.bo + e, e < st.N ? net.b[l] + e : net.b[l],
                  e < st.N ? 4 : 0);
    }
    Ring ring;
    bool wrapped = false;  // every slot has held a chunk
    for (int t = 0; t < my_tiles; ++t) {
      const long long row0 = (long long)(blockIdx.x + t * gridDim.x) * kRows;
      const int xs = t & 1;
      if (t >= 2) mbar_wait(xempty + xs, ((t >> 1) - 1) & 1);
      issue_x(net, row0, xbuf + xs * kRows * D4, xfull + xs, lane);
      if (resident && t > 0) continue;
      int off = 0;
      for (int l = 0; l < L; ++l) {
        const int K4 = round4(net.dims[l]), N4 = round4(net.dims[l + 1]);
        for (int c0 = 0; c0 < N4; c0 += net.ncw[l]) {
          const int cw = min(net.ncw[l], N4 - c0);
          for (int k0 = 0; k0 < K4; k0 += net.kc[l]) {
            const int kr = min(net.kc[l], K4 - k0);
            float* dst = wmem + off;
            if (resident) {
              issue_chunk(net, l, c0, cw, k0, kr, dst, full + ring.slot,
                          lane);
              ++ring.slot;  // a barrier a chunk
            } else {
              dst = wmem + ring.slot * net.slot;
              if (wrapped) mbar_wait(empty + ring.slot, ring.phase ^ 1);
              issue_chunk(net, l, c0, cw, k0, kr, dst, full + ring.slot,
                          lane);
              wrapped |= ring.slot == net.slots - 1;
              ring.advance(net.slots);
            }
            off += cw * kr;
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // The consumers: 8 warps.  In a column block a lane holds 8 rows x 4
  // columns (one column quad) over the k-blocks kb = p, p + P, ... of the
  // layer's inputs; a warp's lanes are 2^lw split lanes x (32 >> lw)
  // consecutive quads, so the 8 lanes of a quarter-warp read 8 quads of one
  // weight row (no bank conflict, no swizzle) and share one activation
  // read; P >> lw warps (k-groups) cover the rest of the split.
  const int warp = tid >> 5, wl = tid & 31;
  Ring ring;
  for (int t = 0; t < my_tiles; ++t) {
    const long long row0 = (long long)(blockIdx.x + t * gridDim.x) * kRows;
    const int xs = t & 1;
    mbar_wait(xfull + xs, (t >> 1) & 1);
    int j = 0, off = 0;  // chunk of this pass, its resident offset
    if (resident) ring.slot = 0;
    for (int l = 0; l < L; ++l) {
      const Stage st = stage[l];
      const bool head = l == L - 1;
      const float* cur =
          l == 0 ? xbuf + xs * kRows * D4 : hbuf + ((l - 1) & 1) * kRows * S;
      const int ld = l == 0 ? D4 : S;
      float* nxt = hbuf + (l & 1) * kRows * S;
      const int lp = st.lp, P = 1 << lp, lw = st.lw;
      const int qw_n = 32 >> lw, pout = 1 << (lp - lw);
      const int pin = wl >> (5 - lw), qw = wl & (qw_n - 1);
      for (int c0 = 0; c0 < st.N4; c0 += st.ncw) {
        const int cw = min(st.ncw, st.N4 - c0);
        const int nq = cw >> 2;
        const int groups = (nq + qw_n - 1) >> (5 - lw);  // warps a k-group
        int kg = 0;  // warp / groups, groups <= 8
        while ((kg + 1) * groups <= warp) ++kg;
        const int q = (warp - kg * groups) * qw_n + qw;
        const bool active = kg < pout;
        const bool on = active && q < nq;
        const int p = (kg << lw) + pin;
        const int col0 = c0 + 4 * q;
        float4 bq = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (on && kg == 0)
          bq = *reinterpret_cast<const float4*>(sbias + st.bo + col0);
        float v[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) v[e] = 0.0f;
        for (int k0 = 0; k0 < st.K4; k0 += st.kc, ++j) {
          const int kr = min(st.kc, st.K4 - k0);
          const int slot = ring.slot;
          mbar_wait(full + slot, ring.phase);
          const float* wch = resident ? wmem + off : wmem + slot * net.slot;
          off += cw * kr;
          if (on) {
            const int kb0 = k0 >> 2, kb1 = (k0 + kr) >> 2;
#pragma unroll 2
            for (int kb = kb0 + ((p - kb0) & (P - 1)); kb < kb1; kb += P) {
              const float* wr = wch + 4 * (kb - kb0) * cw + 4 * q;
              const float4 w0 = *reinterpret_cast<const float4*>(wr);
              const float4 w1 = *reinterpret_cast<const float4*>(wr + cw);
              const float4 w2 = *reinterpret_cast<const float4*>(wr + 2 * cw);
              const float4 w3 = *reinterpret_cast<const float4*>(wr + 3 * cw);
              const float* ar = cur + 4 * kb;
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                const float4 a = *reinterpret_cast<const float4*>(ar + r * ld);
                v[4 * r] = fmaf(a.x, w0.x, v[4 * r]);
                v[4 * r + 1] = fmaf(a.x, w0.y, v[4 * r + 1]);
                v[4 * r + 2] = fmaf(a.x, w0.z, v[4 * r + 2]);
                v[4 * r + 3] = fmaf(a.x, w0.w, v[4 * r + 3]);
                v[4 * r] = fmaf(a.y, w1.x, v[4 * r]);
                v[4 * r + 1] = fmaf(a.y, w1.y, v[4 * r + 1]);
                v[4 * r + 2] = fmaf(a.y, w1.z, v[4 * r + 2]);
                v[4 * r + 3] = fmaf(a.y, w1.w, v[4 * r + 3]);
                v[4 * r] = fmaf(a.z, w2.x, v[4 * r]);
                v[4 * r + 1] = fmaf(a.z, w2.y, v[4 * r + 1]);
                v[4 * r + 2] = fmaf(a.z, w2.z, v[4 * r + 2]);
                v[4 * r + 3] = fmaf(a.z, w2.w, v[4 * r + 3]);
                v[4 * r] = fmaf(a.w, w3.x, v[4 * r]);
                v[4 * r + 1] = fmaf(a.w, w3.y, v[4 * r + 1]);
                v[4 * r + 2] = fmaf(a.w, w3.z, v[4 * r + 2]);
                v[4 * r + 3] = fmaf(a.w, w3.w, v[4 * r + 3]);
              }
            }
          }
          if (resident) {
            ++ring.slot;
          } else {  // this warp is done with the slot
            __syncwarp();
            if (wl == 0) mbar_arrive(empty + slot);
            ring.advance(net.slots);
          }
        }
        const Epilogue ep = {net.out, nxt,   row0,  net.B, st.N, S,   col0,
                             bq.x,    bq.y,  bq.z,  bq.w,  head, on};
        const Split sp = {pin, kg, pout, (warp - kg * groups) * 32 + wl,
                          32 * groups, active};
        switch (lw) {
          case 0: finish<0>(v, sp, part, ep); break;
          case 1: finish<1>(v, sp, part, ep); break;
          case 2: finish<2>(v, sp, part, ep); break;
          case 3: finish<3>(v, sp, part, ep); break;
          case 4: finish<4>(v, sp, part, ep); break;
          default: finish<5>(v, sp, part, ep); break;
        }
        if (pout > 1 && c0 + cw < st.N4) consumers_sync();  // part is read
      }
      consumers_sync();  // h_{l+1} complete; h_l (or x) read by everyone
      if (l == 0 && tid == 0) mbar_arrive(xempty + xs);
    }
  }
}

int g_smem_set[kMaxDevices];  // the attribute's value, by device

}  // namespace

// The launch's arguments as int64, packed by kernels/mogd_mlp.py `_pack`:
//   B, n_layers, grid, slots, slot, stride, nbar, part, bias, smem,
//   dims[n_layers + 1], (column block, k chunk, log2 split, log2 split in a
//   warp) of each layer, then the pointers x, out, the n_layers weights and
//   the n_layers biases.
// x (B, dims[0]) and out (B, dims[n]) fp32 row-major, w_l (dims[l],
// dims[l+1]) and b_l (dims[l+1],) fp32 contiguous, all on the current
// device; the wrapper's `layout` fits the plan to shared memory.  Returns
// the CUDA error of the launch (0 on success).
extern "C" int mlp_forward(const long long* c, void* stream) {
  Net net;
  net.B = (int)c[0];
  net.n_layers = (int)c[1];
  const int grid = (int)c[2];
  net.slots = (int)c[3];
  net.slot = (int)c[4];
  net.stride = (int)c[5];
  net.nbar = (int)c[6];
  net.part = (int)c[7];
  net.bias = (int)c[8];
  const int smem = (int)c[9];
  const int L = net.n_layers;
  if (L < 1 || L > kMaxLayers || net.B < 1 || grid < 1 || net.nbar < 4 ||
      net.nbar % 2 || net.stride < 4 || net.stride % 4 || net.part < 0 ||
      net.part % 4 || net.bias < 4 || net.bias % 4)
    return (int)cudaErrorInvalidValue;
  const long long* dims = c + 10;
  const long long* plan = dims + L + 1;
  const long long* ptr = plan + 4 * L;
  net.x = reinterpret_cast<const float*>(ptr[0]);
  net.out = reinterpret_cast<float*>(ptr[1]);
  for (int l = 0; l <= L; ++l) net.dims[l] = (int)dims[l];
  for (int l = 0; l < L; ++l) {
    net.ncw[l] = (int)plan[4 * l];
    net.kc[l] = (int)plan[4 * l + 1];
    net.lp[l] = (int)plan[4 * l + 2];
    net.lw[l] = (int)plan[4 * l + 3];
    net.w[l] = reinterpret_cast<const float*>(ptr[2 + l]);
    net.b[l] = reinterpret_cast<const float*>(ptr[2 + L + l]);
    if (net.ncw[l] < 4 || net.ncw[l] % 4 || net.kc[l] < 4 || net.kc[l] % 4 ||
        net.lp[l] < 0 || net.lp[l] > 5 || net.lw[l] < 0 ||
        net.lw[l] > net.lp[l] || net.lp[l] - net.lw[l] > 3 ||
        (net.ncw[l] / 4 + (32 >> net.lw[l]) - 1) / (32 >> net.lw[l])
                << (net.lp[l] - net.lw[l]) > kConsumers / 32)
      return (int)cudaErrorInvalidValue;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || smem > g_smem_set[dev]) {
    err = cudaFuncSetAttribute(
        mlp_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) g_smem_set[dev] = smem;
  }
  mlp_forward_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(net);
  return (int)cudaGetLastError();
}
