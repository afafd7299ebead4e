// FourierFT ΔW materialization (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel `deltaw_pallas` (src/repro/kernels/fourier_deltaw.py,
// body `_deltaw_kernel`, basis `_phase_block`). Computes, for every layer l of
// a stack and every output element,
//
//   out[l, j, k] = scale * sum_e c[l, e] * (cos θ[j,e] cos φ[k,e] - sin θ[j,e] sin φ[k,e])
//   θ[j,e] = 2π ((j·u_e) mod d1) / d1,   φ[k,e] = 2π ((k·v_e) mod d2) / d2
//
// What bounds it on the card: operations. 4·d1·d2·n FP32 FLOP against a
// d1·d2·4-byte write per layer (yi-6b wq at n = 1000: ~67 GFLOP for 64 MiB),
// far above the card's FLOP-per-byte ridge, so the FP32 FMA rate is the
// limit. The design therefore keeps every basis value out of device memory:
//
// - one block per 128×128 output tile of one layer, grid (d2/128, d1/128, L);
// - n is walked in chunks of 16 entries; each chunk's c·cosθ, c·sinθ rows and
//   cosφ, sinφ columns for the tile are built in shared memory, and each of
//   the 256 threads accumulates an 8×8 register tile with FP32 FMAs (16 FMAs
//   per 16-byte shared-memory read);
// - the phase is exact integer arithmetic: one 64-bit product and modulo per
//   (entry, 8-row run), then a running `p += u; if (p >= d) p -= d`, so there
//   is no dimension bound (the TPU kernel's int32 product needed d ≤ 46336);
// - cos/sin come from per-axis twiddle tables of length d1 and d2, built once
//   per call by `twiddle_kernel` in double precision (sincospi) and rounded
//   to f32 — accurate trig, never the fast `__cosf` intrinsics.
//
// No tensor cores: a wgmma or 3xTF32 version is later work. Output is f32
// (L, d1, d2), rows/columns past d1/d2 masked at the store; n must be a
// multiple of 16 (the wrapper pads with zero entries and c = 0).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // tile rows (d1 axis)
constexpr int BN = 128;       // tile cols (d2 axis)
constexpr int NC = 16;        // entries per shared-memory chunk
constexpr int TM = 8;         // rows per thread: two runs of 4, BM/2 apart
constexpr int TN = 8;         // cols per thread: two runs of 4, BN/2 apart
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int GROUPS = THREADS / NC;             // 16 fill groups
constexpr int RPG = BM / GROUPS;                 // rows filled per group
constexpr int CPG = BN / GROUPS;                 // cols filled per group
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
    const unsigned ue = static_cast<unsigned>(u[e]);   // 0 <= u < d1
    const unsigned ve = static_cast<unsigned>(v[e]);   // 0 <= v < d2
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

}  // namespace

// c (L, n) f32, u/v (n,) int32 with n % 16 == 0, twiddle scratch cos1/sin1
// (d1,) and cos2/sin2 (d2,) f32, out (L, d1, d2) f32. Returns the CUDA error
// code of the launches (0 = success).
extern "C" int fourier_deltaw_launch(const void* c, const void* u,
                                     const void* v, void* cos1, void* sin1,
                                     void* cos2, void* sin2, void* out, int L,
                                     int n, int d1, int d2, float scale,
                                     void* stream) {
  if (L < 1 || n < NC || n % NC != 0 || d1 < 1 || d2 < 1 || L > 65535 ||
      (d1 + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  twiddle_kernel<<<(d1 + 255) / 256, 256, 0, s>>>(
      static_cast<float*>(cos1), static_cast<float*>(sin1), d1);
  twiddle_kernel<<<(d2 + 255) / 256, 256, 0, s>>>(
      static_cast<float*>(cos2), static_cast<float*>(sin2), d2);
  dim3 grid((d2 + BN - 1) / BN, (d1 + BM - 1) / BM, L);
  deltaw_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(c), static_cast<const int*>(u),
      static_cast<const int*>(v), static_cast<const float*>(cos1),
      static_cast<const float*>(sin1), static_cast<const float*>(cos2),
      static_cast<const float*>(sin2), static_cast<float*>(out), n, d1, d2,
      scale);
  return static_cast<int>(cudaGetLastError());
}
