// FourierFT ΔW materialization (K1) and its VJP with respect to the
// coefficients (K2) for Hopper, sm_90a. The two share their phase code: the
// twiddle tables and the exact integer phase walk.
//
// K1 replaces the TPU kernel `deltaw_pallas` (src/repro/kernels/
// fourier_deltaw.py, body `_deltaw_kernel`, basis `_phase_block`). It
// computes, for every layer l of a stack and every output element,
//
//   out[l, j, k] = scale * sum_e c[l, e] * (cos θ[j,e] cos φ[k,e] - sin θ[j,e] sin φ[k,e])
//   θ[j,e] = 2π ((j·u_e) mod d1) / d1,   φ[k,e] = 2π ((k·v_e) mod d2) / d2
//
// K2 replaces `dc_pallas` (same file, body `_dc_kernel`). It computes
//
//   dc[l, e] = scale * sum_j sum_k g[l, j, k] * cos(θ[j,e] + φ[k,e])
//            = scale * sum_j (cos θ[j,e] A[j,e] - sin θ[j,e] B[j,e]),
//   A = g[l] @ cos φ,  B = g[l] @ sin φ      (contraction over k < d2)
//
// What bounds them. Both kernels evaluate the direct sum: 4·d1·d2·n FP32
// FLOP per layer against one d1·d2·4-byte pass over ΔW or g (yi-6b wq at
// n = 1000: ~67 GFLOP for 64 MiB), so as written they are bound by the FP32
// FMA rate (about 1.0 ms per such layer at 67 TFLOP/s). The functions
// themselves need far less: they are a 2-D inverse FFT of a sparse spectrum
// and a 2-D FFT sampled at n points, about 2.5·d1·d2·log2(d1·d2) operations
// per layer, so their floor is the one pass over memory (~0.02 ms per wq
// layer at 3.35 TB/s) and `torch.fft` beats both kernels. Reaching that
// floor is a redesign (FFT-structured or tensor-core) left to later work.
//
// Shared by both:
// - the phase is exact integer arithmetic: one 64-bit product and modulo per
//   run of rows or columns, then a running `p += u; if (p >= d) p -= d`, so
//   there is no dimension bound (the TPU kernels' int32 product needed
//   d ≤ 46336); entries are reduced into [0, d) on load, so any integer
//   entry is exact and the wrapper reads nothing back to the host;
// - cos/sin come from per-axis twiddle tables of length d, built by
//   `twiddle_kernel` in double precision (sincospi) and rounded to f32 —
//   accurate trig, never the fast `__cosf` intrinsics. The wrapper builds a
//   table once per (d, device) and reuses it.
//
// K1 design: one block per 128×128 output tile of one layer, grid
// (d2/128, d1/128, L); n is walked in chunks of 16 entries; each chunk's
// c·cosθ, c·sinθ rows and cosφ, sinφ columns for the tile are built in shared
// memory, and each of the 256 threads accumulates an 8×8 register tile with
// FP32 FMAs (16 FMAs per 16-byte shared-memory read). Rows/columns past
// d1/d2 are masked at the store.
//
// K2 design, two passes with a fixed sum order:
// - pass 1, `dc_partial_kernel`: one block per (128 rows j) × (64 entries)
//   × layer, grid (n/64, d1/128, L). k is walked in chunks of 32: the g tile
//   is read coalesced along k and stored transposed in shared memory, and
//   the chunk's cos φ / sin φ columns are built in shared memory. Each of
//   the 256 threads holds an 8-row × 4-entry register tile of A and of B
//   (64 FMAs per four 16-byte shared-memory reads). The epilogue weights
//   each row by cos θ / sin θ and sums the block's 128 rows (per thread, then
//   across the 16 threads of an entry column in a fixed order) into
//   partial[row block, l, e].
// - pass 2, `dc_reduce_kernel`: dc[l, e] = scale * sum over row blocks of
//   partial[rb, l, e], rb ascending. The TPU kernel accumulated into one (n,)
//   block across its sequential grid; GPU blocks run in no order, and float
//   atomics would make the f32 sum order vary from run to run, so the
//   partials are summed in a second pass instead: the result is the same
//   bits on every run.
//
// No tensor cores. c and g are f32 and contiguous, g unpadded (L, d1, d2);
// n must be a multiple of 16 (the wrapper pads with zero entries and c = 0,
// and drops their dc).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NC = 16;        // n must be a multiple of this (wrapper pads)
constexpr int PAD = 4;        // row padding: 16-byte aligned, fewer conflicts

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

namespace k1 {

constexpr int BM = 128;       // tile rows (d1 axis)
constexpr int BN = 128;       // tile cols (d2 axis)
constexpr int TM = 8;         // rows per thread: two runs of 4, BM/2 apart
constexpr int TN = 8;         // cols per thread: two runs of 4, BN/2 apart
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int GROUPS = THREADS / NC;             // 16 fill groups
constexpr int RPG = BM / GROUPS;                 // rows filled per group
constexpr int CPG = BN / GROUPS;                 // cols filled per group

__global__ void __launch_bounds__(THREADS)
deltaw_kernel(const float* __restrict__ c, const int* __restrict__ u,
              const int* __restrict__ v, const float* __restrict__ cos1,
              const float* __restrict__ sin1, const float* __restrict__ cos2,
              const float* __restrict__ sin2, float* __restrict__ out,
              int n, int d1, int d2, float scale) {
  __shared__ __align__(16) float ct[NC][BM + PAD];   // c · cos θ
  __shared__ __align__(16) float st[NC][BM + PAD];   // c · sin θ
  __shared__ __align__(16) float cp[NC][BN + PAD];   // cos φ
  __shared__ __align__(16) float sp[NC][BN + PAD];   // sin φ

  const int layer = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int fe = tid % NC;          // entry this thread fills
  const int fg = tid / NC;          // its run of rows / cols
  const float* cl = c + static_cast<size_t>(layer) * n;
  const unsigned ud1 = static_cast<unsigned>(d1);
  const unsigned ud2 = static_cast<unsigned>(d2);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int e0 = 0; e0 < n; e0 += NC) {
    const int e = e0 + fe;
    const float ce = cl[e];
    const unsigned ue = reduce_entry(u[e], d1);
    const unsigned ve = reduce_entry(v[e], d2);
    {
      const int r = fg * RPG;
      unsigned p = static_cast<unsigned>(
          (static_cast<unsigned long long>(row0 + r) * ue) % ud1);
#pragma unroll
      for (int i = 0; i < RPG; ++i) {
        ct[fe][r + i] = ce * cos1[p];
        st[fe][r + i] = ce * sin1[p];
        p += ue;
        if (p >= ud1) p -= ud1;
      }
    }
    {
      const int k = fg * CPG;
      unsigned p = static_cast<unsigned>(
          (static_cast<unsigned long long>(col0 + k) * ve) % ud2);
#pragma unroll
      for (int i = 0; i < CPG; ++i) {
        cp[fe][k + i] = cos2[p];
        sp[fe][k + i] = sin2[p];
        p += ve;
        if (p >= ud2) p -= ud2;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < NC; ++k) {
      // each thread's rows are ty*4 + {0..3} and BM/2 + ty*4 + {0..3} (and
      // likewise for columns), so a warp's float4 reads are contiguous
      float a_c[TM], a_s[TM], b_c[TN], b_s[TN];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 ac = *reinterpret_cast<const float4*>(&ct[k][h * BM / 2 + ty * 4]);
        const float4 as = *reinterpret_cast<const float4*>(&st[k][h * BM / 2 + ty * 4]);
        const float4 bc = *reinterpret_cast<const float4*>(&cp[k][h * BN / 2 + tx * 4]);
        const float4 bs = *reinterpret_cast<const float4*>(&sp[k][h * BN / 2 + tx * 4]);
        a_c[4 * h] = ac.x; a_c[4 * h + 1] = ac.y; a_c[4 * h + 2] = ac.z; a_c[4 * h + 3] = ac.w;
        a_s[4 * h] = as.x; a_s[4 * h + 1] = as.y; a_s[4 * h + 2] = as.z; a_s[4 * h + 3] = as.w;
        b_c[4 * h] = bc.x; b_c[4 * h + 1] = bc.y; b_c[4 * h + 2] = bc.z; b_c[4 * h + 3] = bc.w;
        b_s[4 * h] = bs.x; b_s[4 * h + 1] = bs.y; b_s[4 * h + 2] = bs.z; b_s[4 * h + 3] = bs.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a_c[i], b_c[j], acc[i][j]);
          acc[i][j] = fmaf(-a_s[i], b_s[j], acc[i][j]);
        }
    }
    __syncthreads();
  }

  float* ol = out + static_cast<size_t>(layer) * d1 * d2;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + (i / 4) * (BM / 2) + ty * 4 + i % 4;
    if (row >= d1) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + (j / 4) * (BN / 2) + tx * 4 + j % 4;
      if (col < d2) ol[static_cast<size_t>(row) * d2 + col] = acc[i][j] * scale;
    }
  }
}

}  // namespace k1

namespace k2 {

constexpr int BM = 128;       // rows j per block
constexpr int BN = 64;        // entries per block
constexpr int BK = 32;        // columns k per shared-memory chunk
constexpr int TM = 8;         // rows per thread: two runs of 4, BM/2 apart
constexpr int TN = 4;         // entries per thread
constexpr int TX = BN / TN;   // 16 entry groups
constexpr int TY = BM / TM;   // 16 row groups
constexpr int THREADS = TX * TY;                 // 256
constexpr int FG = THREADS / BN;                 // 4 φ fill groups
constexpr int KPG = BK / FG;                     // 8 columns filled per group

__global__ void __launch_bounds__(THREADS)
dc_partial_kernel(const float* __restrict__ g, const int* __restrict__ u,
                  const int* __restrict__ v, const float* __restrict__ cos1,
                  const float* __restrict__ sin1,
                  const float* __restrict__ cos2,
                  const float* __restrict__ sin2,
                  float* __restrict__ partial, int L, int n, int d1, int d2) {
  __shared__ __align__(16) float gs[BK][BM + PAD];   // g tile, transposed
  __shared__ __align__(16) float cp[BK][BN + PAD];   // cos φ
  __shared__ __align__(16) float sp[BK][BN + PAD];   // sin φ
  __shared__ float red[TY][BN];                      // epilogue reduction

  const int layer = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;                  // first entry
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const unsigned ud1 = static_cast<unsigned>(d1);
  const unsigned ud2 = static_cast<unsigned>(d2);
  const float* gl = g + static_cast<size_t>(layer) * d1 * d2;

  // this thread fills φ for entry fe at columns fg*KPG .. fg*KPG+KPG-1 of
  // every chunk; p is the phase of its first column, stepped chunk by chunk
  const int fe = tid % BN;
  const int fg = tid / BN;
  const unsigned ve = (col0 + fe < n) ? reduce_entry(v[col0 + fe], d2) : 0u;
  unsigned p = static_cast<unsigned>(
      (static_cast<unsigned long long>(fg * KPG) * ve) % ud2);
  const unsigned pstep = static_cast<unsigned>(
      (static_cast<unsigned long long>(BK) * ve) % ud2);

  float acc_a[TM][TN], acc_b[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc_a[i][j] = 0.f;
      acc_b[i][j] = 0.f;
    }

  for (int k0 = 0; k0 < d2; k0 += BK) {
    // g tile: a warp reads 32 consecutive k of one row (128 bytes)
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int row = e / BK;
      const int col = e % BK;
      const int gj = row0 + row;
      const int gk = k0 + col;
      gs[col][row] = (gj < d1 && gk < d2)
                         ? gl[static_cast<size_t>(gj) * d2 + gk] : 0.f;
    }
    {
      unsigned q = p;
#pragma unroll
      for (int i = 0; i < KPG; ++i) {
        cp[fg * KPG + i][fe] = cos2[q];
        sp[fg * KPG + i][fe] = sin2[q];
        q += ve;
        if (q >= ud2) q -= ud2;
      }
      p += pstep;
      if (p >= ud2) p -= ud2;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      // rows ty*4 + {0..3} and BM/2 + ty*4 + {0..3}; entries tx*4 + {0..3}
      const float4 a0 = *reinterpret_cast<const float4*>(&gs[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&gs[k][BM / 2 + ty * 4]);
      const float4 bc = *reinterpret_cast<const float4*>(&cp[k][tx * 4]);
      const float4 bs = *reinterpret_cast<const float4*>(&sp[k][tx * 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b_c[TN] = {bc.x, bc.y, bc.z, bc.w};
      const float b_s[TN] = {bs.x, bs.y, bs.z, bs.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_a[i][j] = fmaf(a[i], b_c[j], acc_a[i][j]);
          acc_b[i][j] = fmaf(a[i], b_s[j], acc_b[i][j]);
        }
    }
    __syncthreads();
  }

  // epilogue: weight each row by cos θ / sin θ and sum this thread's rows
  // (rows past d1 hold 0 in acc, and their table index stays in range)
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int ei = col0 + tx * 4 + j;
    const unsigned ue = (ei < n) ? reduce_entry(u[ei], d1) : 0u;
    float s = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned q = static_cast<unsigned>(
          (static_cast<unsigned long long>(row0 + h * (BM / 2) + ty * 4) * ue)
          % ud1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s = fmaf(cos1[q], acc_a[h * 4 + i][j], s);
        s = fmaf(-sin1[q], acc_b[h * 4 + i][j], s);
        q += ue;
        if (q >= ud1) q -= ud1;
      }
    }
    red[ty][tx * 4 + j] = s;
  }
  __syncthreads();
  if (tid < BN && col0 + tid < n) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < TY; ++t) s += red[t][tid];
    partial[(static_cast<size_t>(blockIdx.y) * L + layer) * n + col0 + tid] = s;
  }
}

__global__ void dc_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, int blocks, int ln,
                                 float scale) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < ln) {
    float s = 0.f;
    for (int rb = 0; rb < blocks; ++rb)
      s += partial[static_cast<size_t>(rb) * ln + idx];
    out[idx] = s * scale;
  }
}

}  // namespace k2

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
// (d1,) and cos2/sin2 (d2,) f32, out (L, d1, d2) f32. Returns the CUDA error
// code of the launch (0 = success).
extern "C" int fourier_deltaw_launch(const void* c, const void* u,
                                     const void* v, const void* cos1,
                                     const void* sin1, const void* cos2,
                                     const void* sin2, void* out, int L,
                                     int n, int d1, int d2, float scale,
                                     void* stream) {
  if (L < 1 || n < NC || n % NC != 0 || d1 < 1 || d2 < 1 || L > 65535 ||
      (d1 + k1::BM - 1) / k1::BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((d2 + k1::BN - 1) / k1::BN, (d1 + k1::BM - 1) / k1::BM, L);
  k1::deltaw_kernel<<<grid, k1::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c), static_cast<const int*>(u),
      static_cast<const int*>(v), static_cast<const float*>(cos1),
      static_cast<const float*>(sin1), static_cast<const float*>(cos2),
      static_cast<const float*>(sin2), static_cast<float*>(out), n, d1, d2,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// g (L, d1, d2) f32, u/v (n,) int32 with n % 16 == 0, twiddle tables
// cos1/sin1 (d1,) and cos2/sin2 (d2,) f32, partial (ceil(d1/128), L, n) f32
// scratch, out (L, n) f32. Returns the CUDA error code of the launches
// (0 = success).
extern "C" int fourier_dc_launch(const void* g, const void* u, const void* v,
                                 const void* cos1, const void* sin1,
                                 const void* cos2, const void* sin2,
                                 void* partial, void* out, int L, int n,
                                 int d1, int d2, float scale, void* stream) {
  const int blocks = (d1 + k2::BM - 1) / k2::BM;
  if (L < 1 || n < NC || n % NC != 0 || d1 < 1 || d2 < 1 || L > 65535 ||
      blocks > 65535 || static_cast<long long>(L) * n > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((n + k2::BN - 1) / k2::BN, blocks, L);
  k2::dc_partial_kernel<<<grid, k2::THREADS, 0, s>>>(
      static_cast<const float*>(g), static_cast<const int*>(u),
      static_cast<const int*>(v), static_cast<const float*>(cos1),
      static_cast<const float*>(sin1), static_cast<const float*>(cos2),
      static_cast<const float*>(sin2), static_cast<float*>(partial), L, n, d1,
      d2);
  const int ln = L * n;
  k2::dc_reduce_kernel<<<(ln + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), blocks,
      ln, scale);
  return static_cast<int>(cudaGetLastError());
}
