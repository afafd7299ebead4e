// The passes of the FFT-structured ΔW kernels and their VJPs, templated on
// the basis: the FourierFT pair (K1 ΔW, K2 dc; fourier_deltaw.cu) and the
// DCT pair (K4 ΔW, K5 dc; dct_deltaw.cu). Each source includes this header
// and instantiates it for its basis, so each library holds its own copy.
//
// Both ΔW kernels compute one row of ΔW as a transform of length d2 of a
// sparse row spectrum (at most n non-zeros), and both dc kernels the
// transpose: one transform per row of g, sampled at the n entries. With
// T(x)[t] = sum_k x[k] exp(+2πi t k / d2) (fft_smem.cuh):
//
//   Fourier  out[j, :]  = scale · Re T(G_j),  G_j[v] = sum_{v_e = v} c_e e^{iθ[j,e]}
//            dc_e       = scale · sum_j Re(e^{iθ[j,e]} · T(g_j)[v_e])
//   DCT      out[j, k]  = scale · T(H_j)[place(k)],  H_j the Hermitian part of
//                         V_j[v] = sum_{v_e = v} c_e C1[j,e] φ_v
//            dc_e       = scale · sum_j C1[j,e] · Re(φ_{v_e} · T(w_j)[v_e]),
//                         w_j[place(k)] = g[j, k]
//
// with θ[j,e] = 2π (j·u_e mod d1) / d1, C1[j,e] = cos(π ((2j+1)·u_e mod 4d1)
// / 2d1), φ_v = exp(iπ v / 2d2) and place(k) = k/2 for even k, d2 - 1 -
// (k-1)/2 for odd k (dct_deltaw.cu says why). So each runs one transform of
// length d2 per row, d1·d2·log d2 operations per layer instead of the direct
// sum's 2–4·d1·d2·n, and touches ΔW or g once.
//
// Two real rows per complex transform. Re T(V) = T(H) for H, the Hermitian
// part of V, H[v] = (V[v] + conj V[d2-v]) / 2, whose transform is real. So
// the ΔW kernels build Z = H_a + i·H_b for rows a = j, b = j+1 and write
// Re T(Z) to row a and Im T(Z) to row b; the dc kernels transform
// Z = x_a + i·x_b and split T(x_a)[v] = (Z[v] + conj Z[d2-v]) / 2 and
// T(x_b)[v] = (Z[v] - conj Z[d2-v]) / 2i.
//
// The ΔW kernels run the transform by decimation in time (the spectrum
// written at its digit-reversed positions, the output read in natural
// order), the dc kernels by decimation in frequency (the row read in natural
// order, T[v] read at pos[v]). pos (d2,), the stage table, the radices and
// the blocking come from the host plan (kernels/fft_plan.py), built once per
// d2 and shared by both bases.
//
// ΔW design. Pass 0, `scatter_plan_kernel` (one block of 1024 threads):
// entry e adds its weight at column v_e and the conjugate at d2 - v_e (the
// "mirror", which makes the Hermitian part); entries whose c is 0 in every
// layer (the zero padding), and DCT entries whose column adds nothing, are
// dropped. The 2n virtual entries are binned by column (integer atomics, a
// block scan), each bin is put in virtual-index order (insertion sort; bins
// are short), and the slots are laid out in rounds: round r holds the r-th
// member of every bin larger than r, with its column's digit-reversed
// position, its row phase's u and its weight in every layer (Fourier: c,
// the mirror flagged in bit 31 of u; DCT: s·c·φ_v, conjugated for the
// mirror, as one complex word). Pass 1, `deltaw_kernel`, grid (row blocks
// of 2·pairs rows, L), 256 threads: zero the rows, add the rounds' slots
// one round at a time (within a round every column is distinct, so no two
// threads add to one word; a slot reads its 2·pairs row factors from the
// twiddle table with one phase product and a running step), run the
// transform, store scale/2 · (Re, Im) to rows j, j+1, coalesced along d2:
// the only pass over ΔW.
//
// dc design. `entry_table_kernel` packs each entry's two places in a padded
// row and its u (DCT: and s·φ_v). Pass 1, `dc_partial_kernel`, grid (row
// blocks, L), 256 threads: a block walks `slabs` groups of `pairs` row
// pairs; for each it loads the rows coalesced (the only pass over g), runs
// the transform, and every thread adds, for each of its entries, the
// group's rows' terms in order to partial[row block, l, e] (only that
// thread touches it). Pass 2, `dc_reduce_kernel`: one warp per (l, e) sums
// the row blocks' partials, lane-strided then a fixed shuffle tree, times
// scale/2.
//
// Determinism: no float atomics. Every word of a ΔW spectrum is summed in
// round order, which pass 0 fixes (the order of slots within a round, set
// by integer atomics, changes no sum); the dc partials and their reduction
// have a fixed order. A second launch gives the same bits.
//
// Limits (the entry points refuse with cudaErrorInvalidValue; the wrappers
// raise first, naming the limit): d2 ≤ 29056 (one complex f32 row, 8·d2
// bytes, in the 232,448 bytes of shared memory a block can have; rows of at
// most 4096 share a block, about 32 KB of buffers), every odd prime factor
// of d2 ≤ 63, d1 ≤ 65535 (the Fourier row phase j·u is one 32-bit product;
// the DCT's is a 64-bit one), n ≤ 16384 for ΔW (pass 0 holds 2n ints in
// shared memory), n a multiple of 16 (the wrapper pads with zero entries
// and c = 0, and drops their dc). c and g are f32 and contiguous, g
// unpadded (L, d1, d2). No tensor cores.
#pragma once
#include <cuda_runtime.h>

#include "fft_smem.cuh"

enum class Basis { fourier, dct };

namespace {

constexpr int NC = 16;              // n must be a multiple of this (wrapper pads)
constexpr int THREADS = 256;        // row kernel blocks
constexpr int SORT_THREADS = 1024;  // pass 0's entry sort
constexpr int SMEM_MAX = 232448;    // shared memory one block can have
constexpr int SMEM_DEFAULT = 49152; // above this a kernel needs the attribute
constexpr int MAX_D1 = 65535;
constexpr int MAX_N = 16384;        // pass 0 holds 2n ints in shared memory

__device__ __forceinline__ unsigned reduce_entry(int e, int d) {
  return static_cast<unsigned>(((e % d) + d) % d);
}

// The DCT column of an entry v: cos(π(2k+1)v / 2N) = sign · cos(π(2k+1)v' /
// 2N) for v' in [0, N) (the cosine's period 4N in the integer phase, and
// its sign flips under v -> v + 2N and v -> 2N - v). False where
// v ≡ N (mod 2N): the cosine is 0 at every k and the entry adds nothing
// (column 0).
__device__ __forceinline__ bool dct_fold(int v, int N, int* col,
                                         float* sign) {
  int q = static_cast<int>(reduce_entry(v, 4 * N));
  float s = 1.f;
  if (q >= 2 * N) {
    q -= 2 * N;
    s = -1.f;
  }
  if (q > N) {
    q = 2 * N - q;
    s = -s;
  }
  *col = q == N ? 0 : q;
  *sign = s;
  return q != N;
}

// Where point k of a DCT row sits in the permuted row the transform runs on.
__device__ __forceinline__ int dct_place(int k, int N) {
  return k & 1 ? N - 1 - (k >> 1) : k >> 1;
}

// ((2i + 1)·u) mod q, one 64-bit product (u < q = 4·d1, i < d1).
__device__ __forceinline__ unsigned odd_phase(unsigned i, unsigned u,
                                              unsigned q) {
  return static_cast<unsigned>((2ull * i + 1ull) * u % q);
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

namespace rows {

// Pass 0's output and scratch, carved by the host from one int buffer.
struct Scatter {
  int* off;      // d2 + 1: bin starts (bins by target position w)
  int* cur;      // d2: placement cursors
  int* tmp;      // 2n: virtual entries by bin, index order within a bin
  int* hist;     // 2n + 1: bins of each size
  int* roff;     // 2n + 2: round starts in the slot arrays
  int* rcur;     // 2n + 1: placement cursors of the rounds
  int* spos;     // 2n: slot -> digit-reversed target position
  int* su;       // 2n: slot -> u mod d1, bit 31 set for a mirror (Fourier);
                 //     u mod 4·d1 (DCT)
  int* rounds;   // 1: the number of rounds (the largest bin)
  float* cs;     // L × 2n: slot -> its entry's c in each layer (Fourier);
                 // L × 2n float2: s·c·φ_v, conjugated for a mirror (DCT)
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

// Pass 0 (one block): the scatter plan of the row spectra. Entry e adds its
// weight at column v_e (its direct copy, virtual index e) and the conjugate
// at d2 - v_e (its mirror, virtual index n + e), which together give the
// Hermitian part. Entries whose c is 0 in every layer (the zero padding),
// and DCT entries that add nothing, are dropped. The virtual entries are
// binned by target column, ordered by virtual index within a bin, and laid
// out by rounds: round r holds the r-th member of every bin larger than r.
// Within a round every target is distinct, so pass 1 adds a round's slots
// without collisions and each column's sum has one fixed order. (The order
// of slots inside a round, set by integer atomics, does not change any
// sum.) phic/phis: the DCT's φ table cos, sin(2πp / 4·d2) (unused for
// Fourier).
template <Basis B>
__global__ void __launch_bounds__(SORT_THREADS)
scatter_plan_kernel(const float* __restrict__ c, const int* __restrict__ u,
                    const int* __restrict__ v, const int* __restrict__ pos,
                    const float* __restrict__ phic,
                    const float* __restrict__ phis, Scatter s, int L, int n,
                    int d1, int d2) {
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
    int w;
    if constexpr (B == Basis::dct) {
      float sign;
      keep = dct_fold(v[e], d2, &w, &sign) && keep;
    } else {
      w = static_cast<int>(reduce_entry(v[e], d2));
    }
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
    if constexpr (B == Basis::dct) {
      int col;
      float sign;
      dct_fold(v[e], d2, &col, &sign);
      const float px = sign * phic[col];
      const float py = (i < n ? sign : -sign) * phis[col];
      s.su[slot] = static_cast<int>(reduce_entry(u[e], 4 * d1));
      float2* cs = reinterpret_cast<float2*>(s.cs);
      for (int l = 0; l < L; ++l) {
        const float ce = c[static_cast<size_t>(l) * n + e];
        cs[static_cast<size_t>(l) * n2 + slot] = make_float2(ce * px,
                                                             ce * py);
      }
    } else {
      s.su[slot] = static_cast<int>(reduce_entry(u[e], d1)
                                    | (i < n ? 0u : 0x80000000u));
      for (int l = 0; l < L; ++l)
        s.cs[static_cast<size_t>(l) * n2 + slot] =
            c[static_cast<size_t>(l) * n + e];
    }
  }
}

// Pass 1: grid (row blocks of 2·P rows, L). Builds Z = 2·(H_j +
// i·H_{j+1}) for each of the block's P row pairs in shared memory, round by
// round, runs the inverse transform, stores scale/2 · (Re, Im) to rows j,
// j + 1. A slot reads its 2·P row factors' table entries at once: Fourier
// cos1/sin1 (d1,) at θ's phase j·u mod d1, DCT cos1 (4·d1,) at
// (2j+1)·u mod 4·d1 (sin1 unused).
template <Basis B, int P>
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
  // this layer's slot weights: 2n floats (Fourier) or 2n float2 (DCT)
  const float* __restrict__ cs =
      s.cs + static_cast<size_t>(layer) * 2 * n * (B == Basis::dct ? 2 : 1);

  for (int idx = threadIdx.x; idx < pairs * plan.stride; idx += blockDim.x)
    buf[idx] = make_float2(0.f, 0.f);
  const int rounds = *s.rounds;
  for (int r = 0; r < rounds; ++r) {
    __syncthreads();                          // the last round's adds are done
    const int hi = roff[r + 1];
#pragma unroll 2
    for (int x = roff[r] + threadIdx.x; x < hi; x += blockDim.x) {
      const unsigned us = static_cast<unsigned>(su[x]);
      const int px = fft_phys(plan, spos[x]);
      if constexpr (B == Basis::dct) {
        // s·c·φ (conjugated: a mirror)
        const float2 cf = reinterpret_cast<const float2*>(cs)[x];
        // C1 of rows j0 .. j0 + 2P - 1 (0 past d1)
        const unsigned q1 = 4u * ud1;
        float ct[2 * P];
        unsigned p = odd_phase(j0, us, q1);
        const unsigned step = 2u * us >= q1 ? 2u * us - q1 : 2u * us;
#pragma unroll
        for (int t = 0; t < 2 * P; ++t) {
          ct[t] = j0 + t < ud1 ? cos1[p] : 0.f;
          p += step;
          if (p >= q1) p -= q1;
        }
#pragma unroll
        for (int b = 0; b < P; ++b) {
          // cf·(C1a + i·C1b) for rows a = j0 + 2b, b = a + 1
          float2& z = buf[b * plan.stride + px];
          z.x = fmaf(cf.x, ct[2 * b], fmaf(-cf.y, ct[2 * b + 1], z.x));
          z.y = fmaf(cf.y, ct[2 * b], fmaf(cf.x, ct[2 * b + 1], z.y));
        }
      } else {
        const float ce = cs[x];
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
  }
  fft_smem_dit<1>(buf, pairs, plan, tw);

  const float half = 0.5f * scale;
  float* ol = out + static_cast<size_t>(layer) * d1 * N;
  for (int idx = threadIdx.x; idx < pairs * N; idx += blockDim.x) {
    const int b = idx / N;
    const int k = idx - b * N;
    const unsigned ja = j0 + 2u * b;
    const int src = B == Basis::dct ? dct_place(k, N) : k;
    const float2 z = buf[b * plan.stride + fft_phys(plan, src)];
    if (ja < ud1) ol[static_cast<size_t>(ja) * N + k] = half * z.x;
    if (ja + 1 < ud1) ol[static_cast<size_t>(ja + 1) * N + k] = half * z.y;
  }
}

// Per entry, once per launch: the places of T[v] and T[d2 - v] in a padded
// row (16 bits each) and u reduced by the row phase's period; for the DCT
// also s·φ_v (0 for an entry that adds nothing).
template <Basis B>
__global__ void entry_table_kernel(const int* __restrict__ u,
                                   const int* __restrict__ v,
                                   const int* __restrict__ pos,
                                   const float* __restrict__ phic,
                                   const float* __restrict__ phis,
                                   unsigned* __restrict__ et,
                                   unsigned* __restrict__ eu,
                                   float2* __restrict__ ephi,
                                   const FftPlan plan, int n, int d1) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) {
    const int N = plan.n;
    int ve;
    if constexpr (B == Basis::dct) {
      float sign;
      const float w = dct_fold(v[e], N, &ve, &sign) ? sign : 0.f;
      ephi[e] = make_float2(w * phic[ve], w * phis[ve]);
      eu[e] = reduce_entry(u[e], 4 * d1);
    } else {
      ve = static_cast<int>(reduce_entry(v[e], N));
      eu[e] = reduce_entry(u[e], d1);
    }
    et[e] = static_cast<unsigned>(fft_phys(plan, pos[ve]))
            | static_cast<unsigned>(fft_phys(plan, pos[ve ? N - ve : 0])) << 16;
  }
}

template <Basis B>
__global__ void __launch_bounds__(THREADS, 4)
dc_partial_kernel(const float* __restrict__ g,
                  const unsigned* __restrict__ et,
                  const unsigned* __restrict__ eu,
                  const float2* __restrict__ ephi,
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
      const int dst = B == Basis::dct ? dct_place(k, N) : k;
      buf[b * plan.stride + fft_phys(plan, dst)] = make_float2(
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
      if constexpr (B == Basis::dct) {
        // sum over the rows of C1·2T(w_j)[v], then Re(s·φ_v · sum)
        const unsigned q1 = 4u * ud1;
        float sx = 0.f, sy = 0.f;
        unsigned p = odd_phase(j0, ue, q1);
        const unsigned step = 2u * ue >= q1 ? 2u * ue - q1 : 2u * ue;
        for (int b = 0; b < pairs; ++b) {
          const unsigned ja = j0 + 2u * b;
          if (ja >= ud1) break;
          const float2 zv = buf[b * plan.stride + pv];
          const float2 zm = buf[b * plan.stride + pm];
          // 2·T(w_a)[v] = Z[v] + conj Z[d2-v]
          const float ca = cos1[p];
          p += step;
          if (p >= q1) p -= q1;
          sx = fmaf(ca, zv.x + zm.x, sx);
          sy = fmaf(ca, zv.y - zm.y, sy);
          // 2·T(w_b)[v] = -i·(Z[v] - conj Z[d2-v])
          const float cb = ja + 1 < ud1 ? cos1[p] : 0.f;
          p += step;
          if (p >= q1) p -= q1;
          sx = fmaf(cb, zv.y + zm.y, sx);
          sy = fmaf(cb, zm.x - zv.x, sy);
        }
        const float2 ph = ephi[e];
        acc = fmaf(ph.x, sx, fmaf(-ph.y, sy, acc));
      } else {
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

// The ΔW kernel's pass 1 for P row pairs per block.
template <Basis B, int P>
int launch_deltaw(const Scatter& sc, const void* cos1, const void* sin1,
                  const void* tw, void* out, const FftPlan& plan, int L,
                  int n, int d1, float scale, int smem, cudaStream_t s) {
  static int allowed = 0;
  if (int err = allow_smem(deltaw_kernel<B, P>, smem, &allowed)) return err;
  const int blocks = (d1 + 2 * P - 1) / (2 * P);
  deltaw_kernel<B, P><<<dim3(blocks, L), THREADS, smem, s>>>(
      sc, static_cast<const float*>(cos1), static_cast<const float*>(sin1),
      static_cast<const float2*>(tw), static_cast<float*>(out), plan, n, d1,
      scale);
  return 0;
}

// A ΔW launch of basis B (the entry points' arguments; phic/phis and sin1
// are null where the basis reads none). Returns the CUDA error code.
template <Basis B>
int deltaw_launch(const void* c, const void* u, const void* v,
                  const void* cos1, const void* sin1, const void* phic,
                  const void* phis, const void* tw, const void* pos,
                  void* scratch, void* out, const int* plan_ints, int L,
                  int n, int d1, int d2, float scale, void* stream) {
  FftPlan plan;
  int pairs, slabs;
  if (L < 1 || L > 65535 || n < NC || n % NC != 0 || n > MAX_N || d1 < 1 ||
      d1 > MAX_D1 || d2 < 1 || !read_plan(plan_ints, d2, &plan, &pairs, &slabs))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 8LL * plan.stride * pairs;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (pairs != 1 && pairs != 2 && pairs != 4 && pairs != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  static int sort_allowed = 0;
  if (int err = allow_smem(scatter_plan_kernel<B>, 8 * n, &sort_allowed))
    return err;
  const int n2 = 2 * n;
  Scatter sc;
  sc.off = static_cast<int*>(scratch);
  sc.cur = sc.off + d2 + 1;
  sc.tmp = sc.cur + d2;
  sc.hist = sc.tmp + n2;
  sc.roff = sc.hist + n2 + 1;
  sc.rcur = sc.roff + n2 + 2;
  sc.spos = sc.rcur + n2 + 1;
  sc.su = sc.spos + n2;
  sc.rounds = sc.su + n2;
  // 2·d2 + 12·n + 6 ints in: an even count, so cs is 8-byte aligned
  sc.cs = reinterpret_cast<float*>(sc.rounds + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  scatter_plan_kernel<B><<<1, SORT_THREADS, 8 * n, s>>>(
      static_cast<const float*>(c), static_cast<const int*>(u),
      static_cast<const int*>(v), static_cast<const int*>(pos),
      static_cast<const float*>(phic), static_cast<const float*>(phis), sc,
      L, n, d1, d2);
  const auto launch = pairs == 1 ? launch_deltaw<B, 1>
                      : pairs == 2 ? launch_deltaw<B, 2>
                      : pairs == 4 ? launch_deltaw<B, 4> : launch_deltaw<B, 8>;
  const int err = launch(sc, cos1, sin1, tw, out, plan, L, n, d1, scale,
                         static_cast<int>(smem), s);
  return err ? err : static_cast<int>(cudaGetLastError());
}

// A dc launch of basis B (the entry points' arguments, as deltaw_launch).
template <Basis B>
int dc_launch(const void* g, const void* u, const void* v, const void* cos1,
              const void* sin1, const void* phic, const void* phis,
              const void* tw, const void* pos, void* partial, void* out,
              const int* plan_ints, int L, int n, int d1, int d2, float scale,
              void* stream) {
  FftPlan plan;
  int pairs, slabs;
  if (L < 1 || L > 65535 || n < NC || n % NC != 0 || d1 < 1 ||
      d1 > MAX_D1 || d2 < 1 || static_cast<long long>(L) * n > (1LL << 26) ||
      !read_plan(plan_ints, d2, &plan, &pairs, &slabs))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 8LL * plan.stride * pairs;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed = 0;
  if (int err = allow_smem(dc_partial_kernel<B>, static_cast<int>(smem),
                           &allowed))
    return err;
  const int rows = 2 * pairs * slabs;
  const int blocks = (d1 + rows - 1) / rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the entry table sits after the partial sums (n is even, so ephi is
  // 8-byte aligned)
  unsigned* et = reinterpret_cast<unsigned*>(
      static_cast<float*>(partial) + static_cast<size_t>(blocks) * L * n);
  unsigned* eu = et + n;
  float2* ephi = reinterpret_cast<float2*>(eu + n);
  entry_table_kernel<B><<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const int*>(u), static_cast<const int*>(v),
      static_cast<const int*>(pos), static_cast<const float*>(phic),
      static_cast<const float*>(phis), et, eu, ephi, plan, n, d1);
  dc_partial_kernel<B><<<dim3(blocks, L), THREADS, smem, s>>>(
      static_cast<const float*>(g), et, eu, ephi,
      static_cast<const float*>(cos1), static_cast<const float*>(sin1),
      static_cast<const float2*>(tw), static_cast<float*>(partial), plan,
      pairs, slabs, L, n, d1);
  const int ln = L * n;
  const long long threads = 32LL * ln;
  dc_reduce_kernel<<<static_cast<int>((threads + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), blocks,
      ln, 0.5f * scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rows

}  // namespace
