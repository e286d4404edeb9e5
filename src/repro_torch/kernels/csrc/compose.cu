// All-pairs frontier composition for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/compose.py
// (pallas_call at :44, entry pairwise_compose_blocked :59).  For FA (N, k)
// and FB (M, k) it writes C (N*M, k) in row-major order:
//
//     C[i*M + j, o] = FA[i, o] + FB[j, o]      where bit o of add_mask is set
//                   = max(FA[i, o], FB[j, o])  otherwise
//
// fp32 add and max are correctly rounded, so the result equals the plain
// PyTorch version bit for bit.  The max propagates NaN as torch.maximum and
// jnp.maximum do (CUDA's fmaxf would return the other operand).
//
// What bounds it on this card.  It reads (N + M)*k*4 bytes and writes
// N*M*k*4, one add or max per output float: the writes bound it (3.35
// TB/s), 0.040 ms at 4096 x 4096 x 2.  On the DAG path a launch writes a
// few thousand floats (27 x 25 x 2 for the ETL job's first join), and the
// launch and the wrapper's host work are the floor.
//
// Design.  The first port wrote one float a thread over a (M*k/256, N)
// grid: 131,072 blocks at 4096 x 4096 x 2.  Here the output is one flat
// array of N*M*k floats and each thread stores 16 bytes (a float4) of it at
// a time, walking the array with a stride of the whole grid (a few CTAs an
// SM, from the wrapper).  Element e is (pair p, objective o) = divmod(e, k)
// and pair p is (i, j) = divmod(p, M); a thread divides once, at its first
// element, and then steps (i, j, o) forward: by one within its float4 and
// by the grid's stride between float4s, whose (i, j, o) the wrapper divides
// out on the host, so that a small output's launch, where no thread takes a
// second step, pays one thread's divisions and no more.  Row offsets are
// 64-bit.  The last N*M*k mod 4 floats are written by one thread, their
// loads issued together.  Outputs larger than L2 are written with
// streaming stores (__stcs), which do not keep the lines in L2; smaller
// ones with caching stores, since the DAG path reads them back at once.
// The add/max mask comes either as bits from the host or, when the caller
// holds it as a bool tensor on the card, as a pointer that each thread
// reads itself, so that no synchronisation brings it to the host.
//
// At the DAG path's 27 x 25 x 2 a launch still takes ~0.3 us longer on the
// device than the first port's (PERF.md): its thread's division by M and
// four elements' loads against one float's.  Trials there found no gain in
// CTAs of one warp spread over more SMs, nor in compiling the 64-bit
// division out of the kernels that fit L2; a compile-time objective step at
// k = 2 (below) took 4096 x 4096 x 2 from 65 back to 47 us.

#include <cuda_runtime.h>
#include <stdint.h>

// The launch's arguments, packed by the wrapper (compose._pack) as 14
// int64: FA (N, k) and FB (M, k) fp32 row-major and out (N*M, k) fp32
// (16-byte aligned) on the device; mptr: 0, or k bools on the device that
// replace the mask bits; n4 = N*M*k / 4 (floor), total = N*M*k; grid from
// compose.grid; stream: 1 for streaming stores; (di, dj, dk) the grid's
// stride of 4 * grid * 256 elements as (rows, columns, objectives).  N, M
// >= 1, 1 <= k <= 32 and M*k < 2^31 (the wrapper checks).
struct ComposeCall {
  long long FA, FB, out, mptr;
  long long M, k, mask, n4, total, grid, stream;
  long long di, dj, dk;
};

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float max_nan(float x, float y) {
  if (x != x) return x;
  if (y != y) return y;
  return x < y ? y : x;
}

// Position of a flat output element: pair row i, column j, objective o.
struct Pos {
  long long i, j;
  int o;
};

template <int K>
__device__ __forceinline__ float compose_at(const float* __restrict__ FA,
                                            const float* __restrict__ FB,
                                            int k, uint32_t mask,
                                            const Pos& p) {
  const int kk = K > 0 ? K : k;
  const float x = __ldg(FA + p.i * kk + p.o);
  const float y = __ldg(FB + p.j * kk + p.o);
  return ((mask >> p.o) & 1u) ? x + y : max_nan(x, y);
}

// One element forward: o, then j, then i.  Selects, not branches, so that
// the loads of a thread's four elements issue together.
template <int K>
__device__ __forceinline__ void step(Pos& p, int k, int M) {
  const int kk = K > 0 ? K : k;
  const bool next_j = p.o + 1 == kk;
  p.o = next_j ? 0 : p.o + 1;
  const bool next_i = next_j && p.j + 1 == M;
  p.j = next_i ? 0 : p.j + next_j;
  p.i += next_i;
}

// (i, j, o) of flat element e, in 32-bit divisions below 2^32 elements
// (64-bit ones are a long subroutine, and a small output's launch pays two)
template <int K>
__device__ __forceinline__ Pos position(long long e, int k, int M) {
  const int kk = K > 0 ? K : k;
  Pos q;
  if (e < (1ll << 32)) {
    const unsigned p = (unsigned)e / (unsigned)kk;
    const unsigned i = p / (unsigned)M;
    q.o = (int)((unsigned)e - p * (unsigned)kk);
    q.i = i;
    q.j = p - i * (unsigned)M;
  } else {
    const long long p = e / kk;
    q.o = (int)(e - p * kk);
    q.i = p / M;
    q.j = p - q.i * M;
  }
  return q;
}

// K > 0: k known at compile time (k = 2 and 3, the DAG path's); K == 0:
// any k up to 32.  STREAM: streaming stores (output larger than L2).
template <int K, bool STREAM>
__global__ void __launch_bounds__(kThreads)
pairwise_compose_kernel(const float* __restrict__ FA,
                        const float* __restrict__ FB, int M, int k,
                        uint32_t mask, const unsigned char* __restrict__ mptr,
                        long long n4, long long total, Pos d,
                        float* __restrict__ out) {
  const int kk = K > 0 ? K : k;
  if (mptr != nullptr) {  // the mask as k bools on the card
    mask = 0;
    for (int o = 0; o < kk; ++o) mask |= (uint32_t)(mptr[o] != 0) << o;
  }
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  if (first < n4) {
    Pos p = position<K>(4 * first, k, M);
    // where k divides 4 every float4 starts at objective 0: a compile-time
    // 0 here keeps the walk's objective arithmetic out of the loop
    d.o = K > 0 && 4 % K == 0 ? 0 : d.o;
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long q = first; q < n4; q += stride) {
      Pos e[4];
      e[0] = p;
#pragma unroll
      for (int c = 1; c < 4; ++c) {
        e[c] = e[c - 1];
        step<K>(e[c], k, M);
      }
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = compose_at<K>(FA, FB, k, mask, e[c]);
      const float4 r = make_float4(v[0], v[1], v[2], v[3]);
      if (STREAM)
        __stcs(out4 + q, r);
      else
        out4[q] = r;
      // p += the stride: objectives, then columns (one carry each), rows
      p.o += d.o;
      const bool carry = p.o >= kk;
      p.o -= carry ? kk : 0;
      p.j += d.j + carry;
      const bool carry_j = p.j >= M;
      p.j -= carry_j ? M : 0;
      p.i += d.i + carry_j;
    }
  }
  // the last total % 4 floats: by the first thread without a float4 when
  // the grid outnumbers them (a small output's launch then waits on no
  // second chain of loads), else by the first thread; their loads issue
  // together, as a float4's do
  const int rest = (int)(total - 4 * n4);
  if (first == (n4 < stride ? n4 : 0) && rest > 0) {
    Pos e[3];
    e[0] = position<K>(4 * n4, k, M);
#pragma unroll
    for (int c = 1; c < 3; ++c) {
      e[c] = e[c - 1];
      step<K>(e[c], k, M);
    }
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[c] = c < rest ? compose_at<K>(FA, FB, k, mask, e[c]) : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (c < rest) out[4 * n4 + c] = v[c];
  }
}

template <int K, bool STREAM>
cudaError_t launch(const ComposeCall& c, cudaStream_t s) {
  pairwise_compose_kernel<K, STREAM><<<(unsigned)c.grid, kThreads, 0, s>>>(
      reinterpret_cast<const float*>(c.FA),
      reinterpret_cast<const float*>(c.FB), (int)c.M, (int)c.k,
      (uint32_t)c.mask, reinterpret_cast<const unsigned char*>(c.mptr), c.n4,
      c.total, Pos{c.di, c.dj, (int)c.dk}, reinterpret_cast<float*>(c.out));
  return cudaGetLastError();
}

template <bool STREAM>
cudaError_t launch_k(const ComposeCall& c, cudaStream_t s) {
  switch (c.k) {
    case 2: return launch<2, STREAM>(c, s);
    case 3: return launch<3, STREAM>(c, s);
    default: return launch<0, STREAM>(c, s);
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).
extern "C" int pairwise_compose(const ComposeCall* c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c->stream ? (int)launch_k<true>(*c, s) : (int)launch_k<false>(*c, s);
}
