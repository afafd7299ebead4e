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
// The passes (scatter plan, row transforms, entry table, reduction), their
// determinism and their limits are `fft_rows.cuh`'s, shared with the DCT
// pair (dct_deltaw.cu); the transform is `fft_smem.cuh`. Here they run with
// the Fourier basis: the row factor e^{iθ} from the twiddle table at length
// d1 (θ's phase j·u mod d1 one 32-bit product per slot or entry, then
// + u per row), the mirror slot adding the conjugate.
//
// What bounds them: one pass over ΔW or g is the floor (bytes). Measured on
// an H100 the kernels sit a few times above it; the transform's shared-
// memory stages, K1's latency-bound scatter rounds and K2's entry gathers
// share the rest, and pass 0 costs about 20 µs per launch (one block).
// Generic odd radices are O(p) per point: 43 (d2 = 11008) and 19 (9728)
// make those shapes slower per byte.
//
// This source also holds the twiddle-table kernel every FFT-structured
// kernel reads its tables from (`fourier_twiddles_launch`).
#include <cuda_runtime.h>

#include "fft_rows.cuh"

namespace {

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
  return rows::deltaw_launch<Basis::fourier>(
      c, u, v, cos1, sin1, nullptr, nullptr, tw, pos, scratch, out,
      plan_ints, L, n, d1, d2, scale, stream);
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
  return rows::dc_launch<Basis::fourier>(
      g, u, v, cos1, sin1, nullptr, nullptr, tw, pos, partial, out,
      plan_ints, L, n, d1, d2, scale, stream);
}
