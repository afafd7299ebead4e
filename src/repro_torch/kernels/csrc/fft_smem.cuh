// In-place mixed-radix FFT of complex f32 rows held in shared memory, for
// one thread block (sm_90a). Used by the FFT-structured ΔW and dc kernels
// of both bases (fft_rows.cuh: FourierFT's K1/K2 and the dct method's K4/K5,
// whose DCTs are complex transforms of the same length with a permutation
// and a twiddle).
//
//   X[t] = sum_k x[k] * exp(sign * 2πi t k / N)        (no normalisation)
//
// Stages. N = r_0 · r_1 ··· r_{S-1}; stage s combines blocks of span
// m_s = r_0···r_{s-1}: for every block and every k < m_s one radix-r_s
// butterfly on the r_s points base + k + q·m_s (q < r_s), done by one
// thread in registers and written back to the same points, so the stages
// need one row of shared memory and a barrier between them.
// - decimation in time (`fft_smem_dit`): stages 0..S-1, twiddle then
//   butterfly. Input at the digit-reversed positions `pos[t]`
//   (kernels/fft_plan.py::digit_reverse), output in natural order.
// - decimation in frequency (`fft_smem_dif`): the transpose, stages
//   S-1..0, butterfly then twiddle. Input in natural order, X[t] left at
//   pos[t].
// Radices 2, 4 and 8 have written-out butterflies; any odd radix p ≤ 63 is
// the direct p-point sum (O(p) per point, from a local array of 64).
// Twiddles come from a per-stage table `tw` (kernels/fft_plan.py::
// stage_twiddles, gathered once per N from the length-N tables that
// `fourier_twiddles_launch` builds in double precision — never the fast
// __sinf/__cosf): stage s keeps exp(+2πi q·k / m_{s+1}) at
// tw[m_s - 1 + (q-1)·m_s + k] (q < r_s, k < m_s; N - 1 entries in all), so
// the threads of a warp, which take consecutive k, read consecutive words;
// an odd stage's roots exp(+2πi j / p) follow at tw[rootoff_s + j]. Sign -1
// conjugates them.
//
// Shared-memory banks: point i of a row lives at i + (i >> shift). With
// shift 4 (one pad word per 16 points) the strided first stages, whose
// butterflies lie r·m_s points apart across a warp, read without bank
// conflicts; shift 30 (no padding) is for rows that fill the shared memory.
//
// Every thread of the block must call the routines (they hold barriers).
#pragma once
#include <cuda_runtime.h>

constexpr int FFT_MAX_STAGES = 16;
constexpr int FFT_MAX_ODD = 64;

struct FftPlan {
  int n;                           // transform length N
  int stages;                      // S
  int shift;                       // padding: point i at i + (i >> shift)
  int stride;                      // words per row: N + ((N - 1) >> shift) + 1
  int radix[FFT_MAX_STAGES];       // r_s
  int span[FFT_MAX_STAGES];        // m_s = r_0···r_{s-1}
  int rootoff[FFT_MAX_STAGES];     // where an odd stage's roots start in tw
};

// Where point i of a row lives in shared memory.
__device__ __forceinline__ int fft_phys(const FftPlan& p, int i) {
  return i + (i >> p.shift);
}

namespace fft_detail {

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
// a · (sign·i)
template <int SIGN>
__device__ __forceinline__ float2 mul_i(float2 a) {
  return SIGN > 0 ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}
// tw[idx], conjugated for SIGN -1
template <int SIGN>
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw,
                                          int idx) {
  const float2 w = __ldg(tw + idx);
  return SIGN > 0 ? w : make_float2(w.x, -w.y);
}

__device__ __forceinline__ void dft2(float2* x) {
  const float2 a = x[0];
  x[0] = cadd(a, x[1]);
  x[1] = csub(a, x[1]);
}

template <int SIGN>
__device__ __forceinline__ void dft4(float2& x0, float2& x1, float2& x2,
                                     float2& x3) {
  const float2 a = cadd(x0, x2), b = csub(x0, x2);
  const float2 c = cadd(x1, x3), d = mul_i<SIGN>(csub(x1, x3));
  x0 = cadd(a, c);
  x2 = csub(a, c);
  x1 = cadd(b, d);
  x3 = csub(b, d);
}

template <int SIGN>
__device__ __forceinline__ void dft8(float2* x) {
  constexpr float H = 0.70710678118654752440f;      // cos(π/4)
  float2 e0 = x[0], e1 = x[2], e2 = x[4], e3 = x[6];
  float2 o0 = x[1], o1 = x[3], o2 = x[5], o3 = x[7];
  dft4<SIGN>(e0, e1, e2, e3);
  dft4<SIGN>(o0, o1, o2, o3);
  // o_k · w8^k, w8 = exp(SIGN·2πi/8)
  o1 = make_float2(H * (o1.x - SIGN * o1.y), H * (o1.y + SIGN * o1.x));
  o2 = mul_i<SIGN>(o2);
  o3 = make_float2(-H * (o3.x + SIGN * o3.y), H * (SIGN * o3.x - o3.y));
  x[0] = cadd(e0, o0); x[4] = csub(e0, o0);
  x[1] = cadd(e1, o1); x[5] = csub(e1, o1);
  x[2] = cadd(e2, o2); x[6] = csub(e2, o2);
  x[3] = cadd(e3, o3); x[7] = csub(e3, o3);
}

// One stage of a power-of-two radix R on `nbuf` rows.
template <int R, int SIGN, bool DIF>
__device__ void stage_pow2(float2* __restrict__ buf, int nbuf,
                           const FftPlan& p, int m,
                           const float2* __restrict__ tw) {
  const int per_buf = p.n / R;
  const float2* __restrict__ ts = tw + (m - 1);   // this stage's twiddles
  for (int idx = threadIdx.x; idx < nbuf * per_buf; idx += blockDim.x) {
    const int b = idx / per_buf;
    const int w = idx - b * per_buf;
    const int blk = w / m;
    const int k = w - blk * m;
    float2* row = buf + static_cast<size_t>(b) * p.stride;
    const int base = blk * m * R + k;
    float2 x[R];
#pragma unroll
    for (int q = 0; q < R; ++q) x[q] = row[fft_phys(p, base + q * m)];
    if (!DIF && k > 0) {
#pragma unroll
      for (int q = 1; q < R; ++q)
        x[q] = cmul(x[q], twiddle<SIGN>(ts, (q - 1) * m + k));
    }
    if constexpr (R == 2) dft2(x);
    if constexpr (R == 4) dft4<SIGN>(x[0], x[1], x[2], x[3]);
    if constexpr (R == 8) dft8<SIGN>(x);
    if (DIF && k > 0) {
#pragma unroll
      for (int q = 1; q < R; ++q)
        x[q] = cmul(x[q], twiddle<SIGN>(ts, (q - 1) * m + k));
    }
#pragma unroll
    for (int q = 0; q < R; ++q) row[fft_phys(p, base + q * m)] = x[q];
  }
}

// One stage of an odd radix r ≤ 63: the direct r-point sum.
template <int SIGN, bool DIF>
__device__ void stage_odd(float2* __restrict__ buf, int nbuf,
                          const FftPlan& p, int m, int r, int rootoff,
                          const float2* __restrict__ tw) {
  const int per_buf = p.n / r;
  const float2* __restrict__ ts = tw + (m - 1);
  const float2* __restrict__ roots = tw + rootoff;
  for (int idx = threadIdx.x; idx < nbuf * per_buf; idx += blockDim.x) {
    const int b = idx / per_buf;
    const int w = idx - b * per_buf;
    const int blk = w / m;
    const int k = w - blk * m;
    float2* row = buf + static_cast<size_t>(b) * p.stride;
    const int base = blk * m * r + k;
    float2 x[FFT_MAX_ODD];
    for (int q = 0; q < r; ++q) {
      x[q] = row[fft_phys(p, base + q * m)];
      if (!DIF && q > 0 && k > 0)
        x[q] = cmul(x[q], twiddle<SIGN>(ts, (q - 1) * m + k));
    }
    for (int o = 0; o < r; ++o) {
      float2 y = x[0];
      int e = 0;                             // (o·q) mod r
      for (int q = 1; q < r; ++q) {
        e += o;
        if (e >= r) e -= r;
        y = cadd(y, cmul(x[q], twiddle<SIGN>(roots, e)));
      }
      if (DIF && o > 0 && k > 0)
        y = cmul(y, twiddle<SIGN>(ts, (o - 1) * m + k));
      row[fft_phys(p, base + o * m)] = y;
    }
  }
}

template <int SIGN, bool DIF>
__device__ void run_stage(float2* buf, int nbuf, const FftPlan& p, int s,
                          const float2* tw) {
  const int r = p.radix[s], m = p.span[s];
  if (r == 8) stage_pow2<8, SIGN, DIF>(buf, nbuf, p, m, tw);
  else if (r == 4) stage_pow2<4, SIGN, DIF>(buf, nbuf, p, m, tw);
  else if (r == 2) stage_pow2<2, SIGN, DIF>(buf, nbuf, p, m, tw);
  else stage_odd<SIGN, DIF>(buf, nbuf, p, m, r, p.rootoff[s], tw);
}

}  // namespace fft_detail

// Decimation in time on `nbuf` rows of p.stride words: input at the
// digit-reversed positions, output in natural order (point i of row b at
// buf[b·stride + fft_phys(i)]). Barrier before every stage and after the
// last.
template <int SIGN>
__device__ void fft_smem_dit(float2* buf, int nbuf, const FftPlan& p,
                             const float2* tw) {
  for (int s = 0; s < p.stages; ++s) {
    __syncthreads();
    fft_detail::run_stage<SIGN, false>(buf, nbuf, p, s, tw);
  }
  __syncthreads();
}

// Decimation in frequency: input in natural order, X[t] left at the
// digit-reversed position of t. Barriers as `fft_smem_dit`.
template <int SIGN>
__device__ void fft_smem_dif(float2* buf, int nbuf, const FftPlan& p,
                             const float2* tw) {
  for (int s = p.stages - 1; s >= 0; --s) {
    __syncthreads();
    fft_detail::run_stage<SIGN, true>(buf, nbuf, p, s, tw);
  }
  __syncthreads();
}
