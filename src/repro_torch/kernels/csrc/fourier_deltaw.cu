// FourierFT ΔW materialization (K1) and its VJP with respect to the
// coefficients (K2) for Hopper, sm_90a, as FFT-structured kernels: each
// reads or writes ΔW (or g) once and does O(d1·d2·log d2) work per layer.
//
// K1 replaces the TPU kernel `deltaw_pallas` (src/repro/kernels/
// fourier_deltaw.py, body `_deltaw_kernel`). For every layer l of a stack
//
//   out[l, j, k] = scale * Re sum_e c[l, e] * exp(i(θ[j,e] + φ[k,e]))
//   θ[j,e] = 2π ((j·u_e) mod d1) / d1,   φ[k,e] = 2π ((k·v_e) mod d2) / d2
//
// K2 replaces `dc_pallas` (same file, body `_dc_kernel`):
//
//   dc[l, e] = scale * sum_jk g[l, j, k] * cos(θ[j,e] + φ[k,e])
//
// The functions split along the axes. Row j of ΔW is the inverse DFT of
// length d2 of the row spectrum G_j[v] = sum_{e: v_e = v} c_e exp(iθ[j,e])
// (at most n non-zeros), real part: out[j, :] = scale · Re T(G_j), with
// T(x)[t] = sum_k x[k] exp(+2πi t k / d2). K2 is its transpose:
// dc_e = scale · sum_j Re(exp(iθ[j,e]) · T(g_j)[v_e]). So both run one
// transform of length d2 per row, d1·d2·log d2 operations per layer
// instead of the direct sum's 4·d1·d2·n, and touch ΔW or g once.
//
// Two real rows per complex transform. Re T(G) = T(H) for H, the Hermitian
// part of G, H[v] = (G[v] + conj G[d2-v]) / 2, whose transform is real. So
// K1 builds Z = H_a + i·H_b for rows a = j, b = j+1 and writes Re T(Z) to
// row a and Im T(Z) to row b; K2 transforms Z = g_a + i·g_b and splits
// T(g_a)[v] = (Z[v] + conj Z[d2-v]) / 2 and
// T(g_b)[v] = (Z[v] - conj Z[d2-v]) / 2i.
//
// The transform is `fft_smem.cuh`: in place in shared memory, radix 8/4/2
// plus a generic odd radix, twiddles from a per-stage table gathered from
// the double-precision tables (coalesced reads), rows padded one word in 16
// where they fit (no bank conflicts in the strided stages). K1 runs it by
// decimation in time (the spectrum written at its digit-reversed positions,
// the output read in natural order), K2 by decimation in frequency (g read
// in natural order, T(g)[v] read at pos[v]). pos (d2,), the stage table,
// the radices and the blocking come from the host plan
// (kernels/fft_plan.py), built once per d2.
//
// K1 design. Pass 0, `scatter_plan_kernel` (one block of 1024 threads):
// entry e adds c_e·exp(iθ) at column v_e and its conjugate at d2 - v_e
// (the "mirror", which makes the Hermitian part); entries whose c is 0 in
// every layer (the zero padding) are dropped. The 2n virtual entries are
// binned by column (integer atomics, a block scan), each bin is put in
// virtual-index order (insertion sort; bins are short), and the slots are
// laid out in rounds: round r holds the r-th member of every bin larger
// than r, with its column's digit-reversed position, u mod d1 (bit 31: a
// mirror) and its c in every layer. Pass 1, `deltaw_kernel`, grid (row
// blocks of 2·pairs rows, L), 256 threads: zero the rows, add the rounds'
// slots one round at a time (within a round every column is distinct, so
// no two threads add to one word; the phase (j·u) mod d1 is one 32-bit
// product, + u for row j+1), run the transform, store scale/2 · (Re, Im)
// to rows j, j+1, coalesced along d2: the only pass over ΔW.
//
// K2 design. `entry_table_kernel` packs each entry's two places in a padded
// row and u mod d1. Pass 1, `dc_partial_kernel`, grid (row blocks, L), 256
// threads: a block walks `slabs` groups of `pairs` row pairs; for each it
// loads the rows coalesced (the only pass over g), runs the transform, and
// every thread adds, for each of its entries, Re(exp(iθ)·T(g_j)[v_e]) over
// the group's rows in order to partial[row block, l, e] (only that thread
// touches it). Pass 2, `dc_reduce_kernel`: one warp per (l, e) sums the row
// blocks' partials, lane-strided then a fixed shuffle tree, times scale/2.
//
// Determinism: no float atomics. Every word of K1's spectrum is summed in
// round order, which pass 0 fixes (the order of slots within a round, set
// by integer atomics, changes no sum); K2's partials and its reduction have
// a fixed order. A second launch gives the same bits.
//
// What bounds them: one pass over ΔW or g is the floor (bytes). Measured on
// an H100 the kernels sit a few times above it; the transform's shared-
// memory stages, K1's latency-bound scatter rounds and K2's entry gathers
// share the rest, and pass 0 costs about 20 µs per launch (one block).
// Generic odd radices are O(p) per point: 43 (d2 = 11008) and 19 (9728)
// make those shapes slower per byte.
//
// Limits (the wrapper raises before launching, naming the limit, and the
// entry points refuse with cudaErrorInvalidValue): d2 ≤ 29056 (one complex
// f32 row, 8·d2 bytes, in the 232,448 bytes of shared memory a block can
// have; rows of at most 4096 share a block, about 32 KB of buffers), every
// odd prime factor of d2 ≤ 63, d1 ≤ 65535 (j·u < 2^32), n ≤ 16384 (pass 0
// holds 2n ints in shared memory), n a multiple of 16 (the wrapper pads with
// zero entries and c = 0, and drops their dc). c and g are f32 and
// contiguous, g unpadded (L, d1, d2). No tensor cores.
#include <cuda_runtime.h>

#include "fft_smem.cuh"

namespace {

constexpr int NC = 16;              // n must be a multiple of this (wrapper pads)
constexpr int THREADS = 256;        // K1 and K2 blocks
constexpr int SORT_THREADS = 1024;  // K1's entry sort
constexpr int SMEM_MAX = 232448;    // shared memory one block can have
constexpr int SMEM_DEFAULT = 49152; // above this a kernel needs the attribute
constexpr int MAX_D1 = 65535;
constexpr int MAX_N = 16384;   // pass 0 holds 2n ints in shared memory

__global__ void twiddle_kernel(float* __restrict__ cosv,
                               float* __restrict__ sinv, int d) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < d) {
    double s, c;
    sincospi(2.0 * static_cast<double>(p) / static_cast<double>(d), &s, &c);
    cosv[p] = static_cast<float>(c);
    sinv[p] = static_cast<float>(s);
  }
}

__device__ __forceinline__ unsigned reduce_entry(int e, int d) {
  return static_cast<unsigned>(((e % d) + d) % d);
}

// plan ints (kernels/fft_plan.py::FftPlan.as_ints): stages, radices padded to
// FFT_MAX_STAGES, pairs, slabs, shift. False unless the radices multiply to
// d2 and each is 2, 4, 8 or an odd number ≤ 63. An odd stage's roots follow
// the N - 1 stage twiddles in the table (fft_plan.stage_twiddles).
bool read_plan(const int* ints, int d2, FftPlan* plan, int* pairs,
               int* slabs) {
  const int stages = ints[0];
  if (stages < 0 || stages > FFT_MAX_STAGES) return false;
  plan->n = d2;
  plan->stages = stages;
  long long span = 1;
  int roots = d2 - 1;
  for (int s = 0; s < FFT_MAX_STAGES; ++s) {
    const int r = s < stages ? ints[1 + s] : 1;
    const bool odd = r % 2 == 1 && r >= 3 && r < FFT_MAX_ODD;
    if (s < stages && !(r == 2 || r == 4 || r == 8 || odd)) return false;
    plan->radix[s] = r;
    plan->span[s] = static_cast<int>(span);
    plan->rootoff[s] = roots;
    if (s < stages && odd) roots += r;
    span *= r;
    if (span > d2) return false;
  }
  *pairs = ints[1 + FFT_MAX_STAGES];
  *slabs = ints[2 + FFT_MAX_STAGES];
  plan->shift = ints[3 + FFT_MAX_STAGES];
  if (plan->shift != 4 && plan->shift != 30) return false;
  plan->stride = d2 + ((d2 - 1) >> plan->shift);
  return span == d2 && *pairs >= 1 && *slabs >= 1;
}

// Raise a kernel's dynamic shared-memory limit once to what it needs.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, int* allowed) {
  if (bytes <= SMEM_DEFAULT || bytes <= *allowed) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return static_cast<int>(err);
}

namespace k1 {

// Pass 0's output and scratch, carved by the host from one int buffer.
struct Scatter {
  int* off;      // d2 + 1: bin starts (bins by target position w)
  int* cur;      // d2: placement cursors
  int* tmp;      // 2n: virtual entries by bin, index order within a bin
  int* hist;     // 2n + 1: bins of each size
  int* roff;     // 2n + 2: round starts in the slot arrays
  int* rcur;     // 2n + 1: placement cursors of the rounds
  int* spos;     // 2n: slot -> digit-reversed target position
  int* su;       // 2n: slot -> u mod d1, bit 31 set for a mirror
  int* rounds;   // 1: the number of rounds (the largest bin)
  float* cs;     // L × 2n: slot -> its entry's c in each layer
};

// Inclusive scan of a[0..len) by one block of SORT_THREADS threads (a is
// global; the caller synchronises before and after).
__device__ void block_scan(int* a, int len, int* part) {
  const int tid = threadIdx.x;
  const int chunk = (len + SORT_THREADS - 1) / SORT_THREADS;
  const int lo = min(tid * chunk, len);
  const int hi = min(lo + chunk, len);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += __ldcg(a + i);
  part[tid] = s;
  __syncthreads();
  for (int d = 1; d < SORT_THREADS; d <<= 1) {
    const int x = tid >= d ? part[tid - d] : 0;
    __syncthreads();
    part[tid] += x;
    __syncthreads();
  }
  s = tid ? part[tid - 1] : 0;
  for (int i = lo; i < hi; ++i) {
    s += __ldcg(a + i);
    a[i] = s;
  }
}

// Pass 0 (one block): the scatter plan of the row spectra. Entry e adds
// c_e·exp(iθ) at column v_e (its direct copy, virtual index e) and
// conj(c_e·exp(iθ)) at d2 - v_e (its mirror, virtual index n + e), which
// together give the Hermitian part. Entries whose c is 0 in every layer
// (the zero padding) add exactly nothing and are dropped. The virtual
// entries are binned by target column, ordered by virtual index within a
// bin, and laid out by rounds: round r holds the r-th member of every bin
// larger than r. Within a round every target is distinct, so pass 1 adds a
// round's slots without collisions and each column's sum has one fixed
// order. (The order of slots inside a round, set by integer atomics, does
// not change any sum.)
__global__ void __launch_bounds__(SORT_THREADS)
scatter_plan_kernel(const float* __restrict__ c, const int* __restrict__ u,
                    const int* __restrict__ v, const int* __restrict__ pos,
                    Scatter s, int L, int n, int d1, int d2) {
  extern __shared__ int key[];                // 2n: target column, or -1
  __shared__ int part[SORT_THREADS];
  const int tid = threadIdx.x;
  const int n2 = 2 * n;
  for (int i = tid; i <= d2; i += SORT_THREADS) s.off[i] = 0;
  for (int i = tid; i < d2; i += SORT_THREADS) s.cur[i] = 0;
  for (int i = tid; i <= n2; i += SORT_THREADS) s.hist[i] = s.rcur[i] = 0;
  if (tid == 0) *s.rounds = 0;
  __syncthreads();
  for (int e = tid; e < n; e += SORT_THREADS) {
    bool keep = false;
    for (int l = 0; l < L && !keep; ++l)
      keep = c[static_cast<size_t>(l) * n + e] != 0.f;
    const int w = static_cast<int>(reduce_entry(v[e], d2));
    const int wm = w ? d2 - w : 0;
    key[e] = keep ? w : -1;
    key[n + e] = keep ? wm : -1;
    if (keep) {
      atomicAdd(s.off + w + 1, 1);
      atomicAdd(s.off + wm + 1, 1);
    }
  }
  __syncthreads();
  block_scan(s.off, d2 + 1, part);
  __syncthreads();
  for (int i = tid; i < n2; i += SORT_THREADS) {
    const int w = key[i];
    if (w >= 0) s.tmp[__ldcg(s.off + w) + atomicAdd(s.cur + w, 1)] = i;
  }
  __syncthreads();
  for (int w = tid; w < d2; w += SORT_THREADS) {
    const int a = __ldcg(s.off + w), b = __ldcg(s.off + w + 1);
    for (int x = a + 1; x < b; ++x) {         // insertion sort: bins are short
      const int t = __ldcg(s.tmp + x);
      int y = x - 1;
      for (; y >= a && __ldcg(s.tmp + y) > t; --y)
        s.tmp[y + 1] = __ldcg(s.tmp + y);
      s.tmp[y + 1] = t;
    }
    if (b > a) {
      // one atomic per distinct size in the warp (most bins hold one)
      const unsigned active = __activemask();
      const unsigned peers = __match_any_sync(active, b - a);
      if ((threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(s.hist + (b - a), __popc(peers));
      const int most = __reduce_max_sync(active, b - a);
      if ((threadIdx.x & 31) == __ffs(active) - 1) atomicMax(s.rounds, most);
    }
  }
  __syncthreads();
  // round r has one slot per bin larger than r, so it starts at
  // roff[r] = sum over sizes z of hist[z]·min(z, r)
  const int R = __ldcg(s.rounds);
  for (int r = tid; r <= R; r += SORT_THREADS) {
    int start = 0;
    for (int z = 1; z <= R; ++z) start += __ldcg(s.hist + z) * min(z, r);
    s.roff[r] = start;
  }
  __syncthreads();
  const int total = __ldcg(s.off + d2);
  for (int x = tid; x < total; x += SORT_THREADS) {
    const int i = __ldcg(s.tmp + x);
    const int w = key[i];
    const int r = x - __ldcg(s.off + w);
    // one atomic per distinct round in the warp
    const unsigned active = __activemask();
    const unsigned peers = __match_any_sync(active, r);
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(peers) - 1;
    int first = 0;
    if (lane == leader) first = atomicAdd(s.rcur + r, __popc(peers));
    first = __shfl_sync(peers, first, leader);
    const int slot = __ldcg(s.roff + r) + first
                     + __popc(peers & ((1u << lane) - 1u));
    const int e = i < n ? i : i - n;
    s.spos[slot] = pos[w];
    s.su[slot] = static_cast<int>(reduce_entry(u[e], d1)
                                  | (i < n ? 0u : 0x80000000u));
    for (int l = 0; l < L; ++l)
      s.cs[static_cast<size_t>(l) * n2 + slot] =
          c[static_cast<size_t>(l) * n + e];
  }
}

// Pass 1: grid (row blocks of 2·P rows, L). Builds Z = 2·(H_j +
// i·H_{j+1}) for each of the block's P row pairs in shared memory, round by
// round, runs the inverse transform, stores scale/2 · (Re, Im) to rows j,
// j + 1. A slot reads its 2·P row phases' table entries at once.
template <int P>
__global__ void __launch_bounds__(THREADS, 4)
deltaw_kernel(const Scatter s,
              const float* __restrict__ cos1, const float* __restrict__ sin1,
              const float2* __restrict__ tw, float* __restrict__ out,
              const FftPlan plan, int n, int d1, float scale) {
  constexpr int pairs = P;
  extern __shared__ float2 buf[];             // P × plan.stride
  const int N = plan.n;
  const int layer = blockIdx.y;
  const unsigned j0 = blockIdx.x * 2u * pairs;
  const unsigned ud1 = static_cast<unsigned>(d1);
  const int* __restrict__ roff = s.roff;
  const int* __restrict__ spos = s.spos;
  const int* __restrict__ su = s.su;
  const float* __restrict__ cs = s.cs + static_cast<size_t>(layer) * 2 * n;

  for (int idx = threadIdx.x; idx < pairs * plan.stride; idx += blockDim.x)
    buf[idx] = make_float2(0.f, 0.f);
  const int rounds = *s.rounds;
  for (int r = 0; r < rounds; ++r) {
    __syncthreads();                          // the last round's adds are done
    const int hi = roff[r + 1];
#pragma unroll 2
    for (int x = roff[r] + threadIdx.x; x < hi; x += blockDim.x) {
      const unsigned us = static_cast<unsigned>(su[x]);
      const float ce = cs[x];
      const int px = fft_phys(plan, spos[x]);
      const float sg = us >> 31 ? -1.f : 1.f; // the mirror adds the conjugate
      const unsigned ue = us & 0x7fffffffu;
      // cos θ, sin θ of rows j0 .. j0 + 2P - 1 (0 past d1)
      float ct[2 * P], st[2 * P];
      unsigned p = (j0 * ue) % ud1;
#pragma unroll
      for (int t = 0; t < 2 * P; ++t) {
        const bool live = j0 + t < ud1;
        ct[t] = live ? cos1[p] : 0.f;
        st[t] = live ? sin1[p] : 0.f;
        p += ue;
        if (p >= ud1) p -= ud1;
      }
#pragma unroll
      for (int b = 0; b < P; ++b) {
        // c·e^{±iθa} + i·c·e^{±iθb} for rows a = j0 + 2b, b = a + 1
        float2& z = buf[b * plan.stride + px];
        z.x = fmaf(ce, ct[2 * b] - sg * st[2 * b + 1], z.x);
        z.y = fmaf(ce, sg * st[2 * b] + ct[2 * b + 1], z.y);
      }
    }
  }
  fft_smem_dit<1>(buf, pairs, plan, tw);

  const float half = 0.5f * scale;
  float* ol = out + static_cast<size_t>(layer) * d1 * N;
  for (int idx = threadIdx.x; idx < pairs * N; idx += blockDim.x) {
    const int b = idx / N;
    const int k = idx - b * N;
    const unsigned ja = j0 + 2u * b;
    const float2 z = buf[b * plan.stride + fft_phys(plan, k)];
    if (ja < ud1) ol[static_cast<size_t>(ja) * N + k] = half * z.x;
    if (ja + 1 < ud1) ol[static_cast<size_t>(ja + 1) * N + k] = half * z.y;
  }
}

}  // namespace k1

namespace k2 {

// Per entry, once per launch: the places of T(g)[v] and T(g)[d2 - v] in a
// padded row (16 bits each) and u mod d1.
__global__ void entry_table_kernel(const int* __restrict__ u,
                                   const int* __restrict__ v,
                                   const int* __restrict__ pos,
                                   unsigned* __restrict__ et,
                                   unsigned* __restrict__ eu,
                                   const FftPlan plan, int n, int d1) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) {
    const int N = plan.n;
    const int ve = static_cast<int>(reduce_entry(v[e], N));
    et[e] = static_cast<unsigned>(fft_phys(plan, pos[ve]))
            | static_cast<unsigned>(fft_phys(plan, pos[ve ? N - ve : 0])) << 16;
    eu[e] = reduce_entry(u[e], d1);
  }
}

__global__ void __launch_bounds__(THREADS, 4)
dc_partial_kernel(const float* __restrict__ g,
                  const unsigned* __restrict__ et,
                  const unsigned* __restrict__ eu,
                  const float* __restrict__ cos1,
                  const float* __restrict__ sin1,
                  const float2* __restrict__ tw,
                  float* __restrict__ partial, const FftPlan plan, int pairs,
                  int slabs, int L, int n, int d1) {
  extern __shared__ float2 buf[];             // pairs × plan.stride
  const int N = plan.n;
  const int layer = blockIdx.y;
  const unsigned ud1 = static_cast<unsigned>(d1);
  const float* gl = g + static_cast<size_t>(layer) * d1 * N;
  float* pl = partial + (static_cast<size_t>(blockIdx.x) * L + layer) * n;

  for (int slab = 0; slab < slabs; ++slab) {
    const unsigned j0 = (blockIdx.x * static_cast<unsigned>(slabs) + slab)
                        * 2u * pairs;
    if (j0 >= ud1) break;                     // the same for the whole block
    __syncthreads();                          // the last group's reads are done
    for (int idx = threadIdx.x; idx < pairs * N; idx += blockDim.x) {
      const int b = idx / N;
      const int k = idx - b * N;
      const unsigned ja = j0 + 2u * b;
      buf[b * plan.stride + fft_phys(plan, k)] = make_float2(
          ja < ud1 ? gl[static_cast<size_t>(ja) * N + k] : 0.f,
          ja + 1 < ud1 ? gl[static_cast<size_t>(ja + 1) * N + k] : 0.f);
    }
    fft_smem_dif<1>(buf, pairs, plan, tw);

    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const unsigned places = et[e];
      const unsigned ue = eu[e];
      const int pv = static_cast<int>(places & 0xffffu);
      const int pm = static_cast<int>(places >> 16);
      float acc = slab ? pl[e] : 0.f;
      for (int b = 0; b < pairs; ++b) {
        const unsigned ja = j0 + 2u * b;
        if (ja >= ud1) break;
        const float2 zv = buf[b * plan.stride + pv];
        const float2 zm = buf[b * plan.stride + pm];
        // 2·T(g_a)[v] = Z[v] + conj Z[d2-v]
        unsigned p = (ja * ue) % ud1;
        acc = fmaf(cos1[p], zv.x + zm.x, acc);
        acc = fmaf(-sin1[p], zv.y - zm.y, acc);
        if (ja + 1 < ud1) {
          // 2·T(g_b)[v] = -i·(Z[v] - conj Z[d2-v])
          p += ue;
          if (p >= ud1) p -= ud1;
          acc = fmaf(cos1[p], zv.y + zm.y, acc);
          acc = fmaf(-sin1[p], zm.x - zv.x, acc);
        }
      }
      pl[e] = acc;
    }
  }
}

// out[i] = scale · sum over row blocks of partial[rb, i], i = (l, e): one
// warp per i, lanes over rb, then a fixed shuffle tree.
__global__ void dc_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, int blocks, int ln,
                                 float scale) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= ln) return;
  float s = 0.f;
  for (int rb = lane; rb < blocks; rb += 32)
    s += partial[static_cast<size_t>(rb) * ln + warp];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (lane == 0) out[warp] = s * scale;
}

}  // namespace k2

int sort_smem_allowed = 0, k2_smem_allowed = 0;

// K1's pass 1 for P row pairs per block.
template <int P>
int launch_deltaw(const k1::Scatter& sc, const void* cos1, const void* sin1,
                  const void* tw, void* out, const FftPlan& plan, int L,
                  int n, int d1, float scale, int smem, cudaStream_t s) {
  static int allowed = 0;
  if (int err = allow_smem(k1::deltaw_kernel<P>, smem, &allowed)) return err;
  const int blocks = (d1 + 2 * P - 1) / (2 * P);
  k1::deltaw_kernel<P><<<dim3(blocks, L), THREADS, smem, s>>>(
      sc, static_cast<const float*>(cos1), static_cast<const float*>(sin1),
      static_cast<const float2*>(tw), static_cast<float*>(out), plan, n, d1,
      scale);
  return 0;
}

}  // namespace

// cos/sin (d,) f32: the twiddle table cos(2πp/d), sin(2πp/d) for p < d.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int fourier_twiddles_launch(void* cosv, void* sinv, int d,
                                       void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  twiddle_kernel<<<(d + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(cosv), static_cast<float*>(sinv), d);
  return static_cast<int>(cudaGetLastError());
}

// c (L, n) f32, u/v (n,) int32 with n % 16 == 0, twiddle tables cos1/sin1
// (d1,) f32, tw the stage twiddles of d2 (fft_plan.stage_twiddles, f32
// pairs), pos (d2,) int32 (fft_plan.digit_reverse), scratch
// (2·d2 + 12·n + 8 + 2·L·n,) int32, out (L, d1, d2) f32, plan (host) the
// ints of fft_plan.FftPlan.as_ints(). Returns the CUDA error code of the
// launches (0 = success).
extern "C" int fourier_deltaw_launch(const void* c, const void* u,
                                     const void* v, const void* cos1,
                                     const void* sin1, const void* tw,
                                     const void* pos, void* scratch,
                                     void* out, const int* plan_ints, int L,
                                     int n, int d1, int d2, float scale,
                                     void* stream) {
  FftPlan plan;
  int pairs, slabs;
  if (L < 1 || L > 65535 || n < NC || n % NC != 0 || n > MAX_N || d1 < 1 ||
      d1 > MAX_D1 || d2 < 1 || !read_plan(plan_ints, d2, &plan, &pairs, &slabs))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 8LL * plan.stride * pairs;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (pairs != 1 && pairs != 2 && pairs != 4 && pairs != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (int err = allow_smem(k1::scatter_plan_kernel, 8 * n,
                           &sort_smem_allowed))
    return err;
  const int n2 = 2 * n;
  k1::Scatter sc;
  sc.off = static_cast<int*>(scratch);
  sc.cur = sc.off + d2 + 1;
  sc.tmp = sc.cur + d2;
  sc.hist = sc.tmp + n2;
  sc.roff = sc.hist + n2 + 1;
  sc.rcur = sc.roff + n2 + 2;
  sc.spos = sc.rcur + n2 + 1;
  sc.su = sc.spos + n2;
  sc.rounds = sc.su + n2;
  sc.cs = reinterpret_cast<float*>(sc.rounds + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  k1::scatter_plan_kernel<<<1, SORT_THREADS, 8 * n, s>>>(
      static_cast<const float*>(c), static_cast<const int*>(u),
      static_cast<const int*>(v), static_cast<const int*>(pos), sc, L, n, d1,
      d2);
  const auto launch = pairs == 1 ? launch_deltaw<1>
                      : pairs == 2 ? launch_deltaw<2>
                      : pairs == 4 ? launch_deltaw<4> : launch_deltaw<8>;
  const int err = launch(sc, cos1, sin1, tw, out, plan, L, n, d1, scale,
                         static_cast<int>(smem), s);
  return err ? err : static_cast<int>(cudaGetLastError());
}

// g (L, d1, d2) f32, u/v (n,) int32 with n % 16 == 0, cos1/sin1 (d1,) f32,
// tw and pos as for fourier_deltaw_launch, partial (row_blocks·L·n + 2n,)
// f32 scratch with row_blocks = ceil(d1 / (2·pairs·slabs))
// (fft_plan.k2_row_blocks), out (L, n) f32, plan (host) as for
// fourier_deltaw_launch. Returns the CUDA error code of the launches
// (0 = success).
extern "C" int fourier_dc_launch(const void* g, const void* u, const void* v,
                                 const void* cos1, const void* sin1,
                                 const void* tw, const void* pos,
                                 void* partial, void* out,
                                 const int* plan_ints, int L, int n, int d1,
                                 int d2, float scale, void* stream) {
  FftPlan plan;
  int pairs, slabs;
  if (L < 1 || L > 65535 || n < NC || n % NC != 0 || d1 < 1 ||
      d1 > MAX_D1 || d2 < 1 || static_cast<long long>(L) * n > (1LL << 26) ||
      !read_plan(plan_ints, d2, &plan, &pairs, &slabs))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 8LL * plan.stride * pairs;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (int err = allow_smem(k2::dc_partial_kernel, static_cast<int>(smem),
                           &k2_smem_allowed))
    return err;
  const int rows = 2 * pairs * slabs;
  const int blocks = (d1 + rows - 1) / rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the entry table sits after the partial sums
  unsigned* et = reinterpret_cast<unsigned*>(
      static_cast<float*>(partial) + static_cast<size_t>(blocks) * L * n);
  unsigned* eu = et + n;
  k2::entry_table_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const int*>(u), static_cast<const int*>(v),
      static_cast<const int*>(pos), et, eu, plan, n, d1);
  k2::dc_partial_kernel<<<dim3(blocks, L), THREADS, smem, s>>>(
      static_cast<const float*>(g), et, eu, static_cast<const float*>(cos1),
      static_cast<const float*>(sin1), static_cast<const float2*>(tw),
      static_cast<float*>(partial), plan, pairs, slabs, L, n, d1);
  const int ln = L * n;
  const long long threads = 32LL * ln;
  k2::dc_reduce_kernel<<<static_cast<int>((threads + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), blocks,
      ln, 0.5f * scale);
  return static_cast<int>(cudaGetLastError());
}
