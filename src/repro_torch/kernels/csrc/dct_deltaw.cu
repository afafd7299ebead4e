// DCT ΔW materialization (K4) and its VJP with respect to the coefficients
// (K5) for Hopper, sm_90a: the cosine-only sibling of fourier_deltaw.cu.
//
// K4 replaces the TPU kernel `deltaw_pallas` (src/repro/kernels/
// dct_deltaw.py, body `_deltaw_kernel`, basis `_cos_block`). For every
// layer l of a stack and every output element it computes
//
//   out[l, j, k] = scale * sum_e c[l, e] * C1[j, e] * C2[k, e]
//   C1[j, e] = cos(π ((2j+1)·u_e mod 4d1) / (2 d1)),  C2 likewise with k, v, d2
//
// K5 replaces `dc_pallas` (same file, body `_dc_kernel`):
//
//   dc[l, e] = scale * sum_j C1[j, e] * A[j, e],   A = g[l] @ C2  (over k < d2)
//
// What bounds them. Both evaluate the direct sum: 2·d1·d2·n FP32 FLOP per
// layer (half of K1's, there is no sine term) against one d1·d2·4-byte pass
// over ΔW or g (yi-6b wq at n = 1000: ~34 GFLOP for 64 MiB), so as written
// they are bound by the FP32 FMA rate (about 0.5 ms per such layer at 67
// TFLOP/s). The functions need less: a 2-D DCT of a sparse spectrum and a
// 2-D DCT sampled at n points cost about as much as a real FFT of d1·d2
// points, so their floor is the one pass over memory (~0.02 ms per wq
// layer at 3.35 TB/s). Reaching it is a redesign left to later work.
//
// Shared by both:
// - the phase is exact integer arithmetic: cos(π(2j+1)u/2d) has period 4d
//   in the product (2j+1)·u, so each run of rows or columns takes one
//   64-bit product and modulo, then a running `p += 2u; if (p >= 4d) p -= 4d`.
//   Entries are reduced into [0, 4d) on load, so any integer entry is exact
//   and the wrapper reads nothing back to the host. The TPU kernel's int32
//   product bounded d at 32500; here d ≤ 2^28 (so that p + 2u < 2^32), which
//   the entry points check;
// - cos comes from a twiddle table of length 4d, cos(2π p / 4d) =
//   cos(π p / 2d), which is K1's table at length 4d (built by
//   `fourier_twiddles_launch` in double precision and rounded to f32; the
//   wrapper builds it once per (d, device)) — accurate trig, never the fast
//   `__cosf` intrinsic.
//
// K4 design: K1's tiling without the sine term. One block per 128×128
// output tile of one layer, grid (d2/128, d1/128, L); n is walked in chunks
// of 16 entries; each chunk's c·C1 rows and C2 columns for the tile are built
// in shared memory, and each of the 256 threads accumulates an 8×8 register
// tile with FP32 FMAs (64 FMAs per four 16-byte shared-memory reads). Rows
// and columns past d1/d2 are masked at the store, so nothing is sliced.
//
// K5 design, K2's two passes with a fixed sum order:
// - pass 1, `dc_partial_kernel`: one block per (128 rows j) × (128 entries)
//   × layer, grid (n/128, d1/128, L). k is walked in chunks of 32: the g tile
//   is read coalesced along k and stored transposed in shared memory, and the
//   chunk's C2 columns are built in shared memory. Each of the 256 threads
//   holds an 8-row × 8-entry register tile of A (64 FMAs per four 16-byte
//   shared-memory reads). The epilogue weights each row by C1 and sums the
//   block's 128 rows (per thread, then across the 16 row groups of an entry
//   in a fixed order) into partial[row block, l, e].
// - pass 2, `dc_reduce_kernel`: dc[l, e] = scale * sum over row blocks of
//   partial[rb, l, e], rb ascending. The TPU kernel accumulated into one (n,)
//   block across its sequential grid; GPU blocks run in no order, and float
//   atomics would make the f32 sum order vary from run to run, so the
//   partials are summed in a second pass: the same bits on every run.
//
// No tensor cores. c and g are f32 and contiguous, g unpadded (L, d1, d2);
// n must be a multiple of 16 (the wrapper pads with zero entries and c = 0,
// and drops their dc).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NC = 16;          // n must be a multiple of this (wrapper pads)
constexpr int PAD = 4;          // row padding: 16-byte aligned, fewer conflicts
constexpr int MAX_DIM = 1 << 28;

__device__ __forceinline__ unsigned reduce_entry(int e, int period) {
  return static_cast<unsigned>(((e % period) + period) % period);
}

// phase of index i for entry e (in [0, q)): ((2i+1)·e) mod q
__device__ __forceinline__ unsigned first_phase(int i, unsigned e,
                                                unsigned q) {
  return static_cast<unsigned>(
      ((2ull * static_cast<unsigned long long>(i) + 1ull) * e) % q);
}

namespace k4 {

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
              const float* __restrict__ cos2, float* __restrict__ out, int n,
              int d1, int d2, float scale) {
  __shared__ __align__(16) float ct[NC][BM + PAD];   // c · C1
  __shared__ __align__(16) float cp[NC][BN + PAD];   // C2

  const int layer = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int fe = tid % NC;          // entry this thread fills
  const int fg = tid / NC;          // its run of rows / cols
  const float* cl = c + static_cast<size_t>(layer) * n;
  const unsigned q1 = 4u * static_cast<unsigned>(d1);
  const unsigned q2 = 4u * static_cast<unsigned>(d2);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int e0 = 0; e0 < n; e0 += NC) {
    const int e = e0 + fe;
    const float ce = cl[e];
    const unsigned ue = reduce_entry(u[e], static_cast<int>(q1));
    const unsigned ve = reduce_entry(v[e], static_cast<int>(q2));
    {
      const int r = fg * RPG;
      const unsigned step = (2u * ue) % q1;
      unsigned p = first_phase(row0 + r, ue, q1);
#pragma unroll
      for (int i = 0; i < RPG; ++i) {
        ct[fe][r + i] = ce * cos1[p];
        p += step;
        if (p >= q1) p -= q1;
      }
    }
    {
      const int k = fg * CPG;
      const unsigned step = (2u * ve) % q2;
      unsigned p = first_phase(col0 + k, ve, q2);
#pragma unroll
      for (int i = 0; i < CPG; ++i) {
        cp[fe][k + i] = cos2[p];
        p += step;
        if (p >= q2) p -= q2;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < NC; ++k) {
      // each thread's rows are ty*4 + {0..3} and BM/2 + ty*4 + {0..3} (and
      // likewise for columns), so a warp's float4 reads are contiguous
      float a[TM], b[TN];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 av = *reinterpret_cast<const float4*>(&ct[k][h * BM / 2 + ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&cp[k][h * BN / 2 + tx * 4]);
        a[4 * h] = av.x; a[4 * h + 1] = av.y; a[4 * h + 2] = av.z; a[4 * h + 3] = av.w;
        b[4 * h] = bv.x; b[4 * h + 1] = bv.y; b[4 * h + 2] = bv.z; b[4 * h + 3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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

}  // namespace k4

namespace k5 {

constexpr int BM = 128;       // rows j per block
constexpr int BN = 128;       // entries per block
constexpr int BK = 32;        // columns k per shared-memory chunk
constexpr int TM = 8;         // rows per thread: two runs of 4, BM/2 apart
constexpr int TN = 8;         // entries per thread: two runs of 4, BN/2 apart
constexpr int TX = BN / TN;   // 16 entry groups
constexpr int TY = BM / TM;   // 16 row groups
constexpr int THREADS = TX * TY;                 // 256
constexpr int FG = THREADS / BN;                 // 2 C2 fill groups
constexpr int KPG = BK / FG;                     // 16 columns filled per group

// entry of this thread's register column j (two runs of 4, BN/2 apart)
__device__ __forceinline__ int entry_of(int tx, int j) {
  return (j / 4) * (BN / 2) + tx * 4 + j % 4;
}

__global__ void __launch_bounds__(THREADS)
dc_partial_kernel(const float* __restrict__ g, const int* __restrict__ u,
                  const int* __restrict__ v, const float* __restrict__ cos1,
                  const float* __restrict__ cos2,
                  float* __restrict__ partial, int L, int n, int d1, int d2) {
  __shared__ __align__(16) float gs[BK][BM + PAD];   // g tile, transposed
  __shared__ __align__(16) float cp[BK][BN + PAD];   // C2
  __shared__ float red[TY][BN];                      // epilogue reduction

  const int layer = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;                  // first entry
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const unsigned q1 = 4u * static_cast<unsigned>(d1);
  const unsigned q2 = 4u * static_cast<unsigned>(d2);
  const float* gl = g + static_cast<size_t>(layer) * d1 * d2;

  // this thread fills C2 for entry fe at columns fg*KPG .. fg*KPG+KPG-1 of
  // every chunk; p is the phase of its first column, stepped chunk by chunk
  const int fe = tid % BN;
  const int fg = tid / BN;
  const unsigned ve = (col0 + fe < n)
                          ? reduce_entry(v[col0 + fe], static_cast<int>(q2)) : 0u;
  const unsigned step = (2u * ve) % q2;
  const unsigned pstep = static_cast<unsigned>(
      (2ull * BK * static_cast<unsigned long long>(ve)) % q2);
  unsigned p = first_phase(fg * KPG, ve, q2);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

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
        q += step;
        if (q >= q2) q -= q2;
      }
      p += pstep;
      if (p >= q2) p -= q2;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      // rows ty*4 + {0..3} and BM/2 + ty*4 + {0..3}; entries likewise
      const float4 a0 = *reinterpret_cast<const float4*>(&gs[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&gs[k][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&cp[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&cp[k][BN / 2 + tx * 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: weight each row by C1 and sum this thread's rows (rows past
  // d1 hold 0 in acc, and their table index stays in range)
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int ei = col0 + entry_of(tx, j);
    const unsigned ue = (ei < n) ? reduce_entry(u[ei], static_cast<int>(q1)) : 0u;
    const unsigned rstep = (2u * ue) % q1;
    float s = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned q = first_phase(row0 + h * (BM / 2) + ty * 4, ue, q1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s = fmaf(cos1[q], acc[h * 4 + i][j], s);
        q += rstep;
        if (q >= q1) q -= q1;
      }
    }
    red[ty][entry_of(tx, j)] = s;
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

}  // namespace k5

}  // namespace

// c (L, n) f32, u/v (n,) int32 with n % 16 == 0, cos tables cos1 (4·d1,)
// and cos2 (4·d2,) f32, out (L, d1, d2) f32. Returns the CUDA error code of
// the launch (0 = success).
extern "C" int dct_deltaw_launch(const void* c, const void* u, const void* v,
                                 const void* cos1, const void* cos2,
                                 void* out, int L, int n, int d1, int d2,
                                 float scale, void* stream) {
  if (L < 1 || n < NC || n % NC != 0 || d1 < 1 || d2 < 1 || d1 > MAX_DIM ||
      d2 > MAX_DIM || L > 65535 || (d1 + k4::BM - 1) / k4::BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((d2 + k4::BN - 1) / k4::BN, (d1 + k4::BM - 1) / k4::BM, L);
  k4::deltaw_kernel<<<grid, k4::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c), static_cast<const int*>(u),
      static_cast<const int*>(v), static_cast<const float*>(cos1),
      static_cast<const float*>(cos2), static_cast<float*>(out), n, d1, d2,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// g (L, d1, d2) f32, u/v (n,) int32 with n % 16 == 0, cos tables cos1
// (4·d1,) and cos2 (4·d2,) f32, partial (ceil(d1/128), L, n) f32 scratch,
// out (L, n) f32. Returns the CUDA error code of the launches (0 = success).
extern "C" int dct_dc_launch(const void* g, const void* u, const void* v,
                             const void* cos1, const void* cos2,
                             void* partial, void* out, int L, int n, int d1,
                             int d2, float scale, void* stream) {
  const int blocks = (d1 + k5::BM - 1) / k5::BM;
  if (L < 1 || n < NC || n % NC != 0 || d1 < 1 || d2 < 1 || d1 > MAX_DIM ||
      d2 > MAX_DIM || L > 65535 || blocks > 65535 ||
      static_cast<long long>(L) * n > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((n + k5::BN - 1) / k5::BN, blocks, L);
  k5::dc_partial_kernel<<<grid, k5::THREADS, 0, s>>>(
      static_cast<const float*>(g), static_cast<const int*>(u),
      static_cast<const int*>(v), static_cast<const float*>(cos1),
      static_cast<const float*>(cos2), static_cast<float*>(partial), L, n, d1,
      d2);
  const int ln = L * n;
  k5::dc_reduce_kernel<<<(ln + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), blocks,
      ln, scale);
  return static_cast<int>(cudaGetLastError());
}
