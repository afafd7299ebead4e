// DCT ΔW materialization (K4) and its VJP with respect to the coefficients
// (K5) for Hopper, sm_90a: the dct method's pair, FFT-structured like the
// FourierFT pair (fourier_deltaw.cu), whose passes they share
// (`fft_rows.cuh`, instantiated here for the DCT basis).
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
//   dc[l, e] = scale * sum_jk g[l, j, k] * C1[j, e] * C2[k, e]
//
// A DCT of length N = d2 is a complex transform of length N with a
// permutation and a twiddle (Makhoul, 1980), for odd N too. With
// T(x)[t] = sum_k x[k] exp(+2πi t k / N) (the transform K1 and K2 run),
// φ_v = exp(iπ v / 2N) and place(k) = k/2 for even k, N - 1 - (k-1)/2 for
// odd k:
//
// - K4: row j of ΔW is a DCT-III of its sparse row spectrum X_j[v] =
//   sum_{e: v_e = v} c_e·C1[j,e]. Let V = X_j·φ and H its Hermitian part;
//   then w = T(H) is real, out[j, 2m] = scale·w[m] and out[j, 2m+1] =
//   scale·w[N-1-m], i.e. out[j, k] = scale·w[place(k)]. So K4 is K1's pass 0
//   and pass 1 with the real row factor C1 (from the cos table at length
//   4·d1) in place of e^{iθ}, each entry weighted by φ_{v_e} (its mirror by
//   the conjugate), and the store reading point k from place(k).
// - K5: with the permuted row w_j[place(k)] = g[j, k], Y_j[v] = sum_k
//   g[j,k]·cos(π(2k+1)v / 2N) = Re(φ_v · T(w_j)[v]) (a DCT-II), and
//   dc_e = scale · sum_j C1[j,e]·Y_j[v_e]. So K5 is K2's passes with the
//   load writing point k to place(k) and each entry's term
//   C1[j,e]·Re(φ_{v_e}·T(w_j)[v_e]); the sum over the rows is taken before
//   the (per-entry constant) φ is applied.
//
// Entries. cos(π(2k+1)v / 2N) has period 4N in the integer product and
// flips sign under v -> v + 2N and v -> 2N - v, so any integer v folds
// exactly to a column v' in [0, N) and a sign; v ≡ N (mod 2N) gives 0 at
// every k and the entry is dropped (`dct_fold`). The row phase (2j+1)·u mod
// 4d1 is exact integer arithmetic: one 64-bit product per slot or entry and
// row block, then a running `p += 2u; if (p >= 4d1) p -= 4d1`. The cosines
// and φ come from K1's twiddle table at length 4d1 and 4d2 (built by
// `fourier_twiddles_launch` in double precision and rounded to f32) —
// accurate trig, never the fast `__cosf` intrinsic.
//
// What bounds them: one pass over ΔW or g is the floor (bytes), as for K1
// and K2; their earlier design evaluated the direct sum, 2·d1·d2·n FP32
// FMAs per layer, about 60× that floor at yi-6b's wq. The passes,
// determinism (no float atomics: the same bits on a second launch) and
// limits are fft_rows.cuh's: d2 ≤ 29056 with odd prime factors ≤ 63,
// d1 ≤ 65535, n ≤ 16384 for K4, n a multiple of 16 (the wrapper pads with
// zero entries and c = 0, and drops their dc).
#include <cuda_runtime.h>

#include "fft_rows.cuh"

// c (L, n) f32, u/v (n,) int32 with n % 16 == 0, cos1 (4·d1,) and phic/phis
// (4·d2,) f32 (the cos table at length 4·d1, the cos and sin tables at
// length 4·d2), tw and pos as for fourier_deltaw_launch, scratch
// (2·d2 + 12·n + 8 + 4·L·n,) int32, out (L, d1, d2) f32, plan (host) the ints
// of fft_plan.FftPlan.as_ints(). Returns the CUDA error code of the launches
// (0 = success).
extern "C" int dct_deltaw_launch(const void* c, const void* u, const void* v,
                                 const void* cos1, const void* phic,
                                 const void* phis, const void* tw,
                                 const void* pos, void* scratch, void* out,
                                 const int* plan_ints, int L, int n, int d1,
                                 int d2, float scale, void* stream) {
  return rows::deltaw_launch<Basis::dct>(
      c, u, v, cos1, nullptr, phic, phis, tw, pos, scratch, out, plan_ints,
      L, n, d1, d2, scale, stream);
}

// g (L, d1, d2) f32, u/v (n,) int32 with n % 16 == 0, cos1, phic, phis, tw
// and pos as for dct_deltaw_launch, partial (row_blocks·L·n + 4n,) f32
// scratch with row_blocks = fft_plan.k2_row_blocks, out (L, n) f32, plan
// (host) as for dct_deltaw_launch. Returns the CUDA error code of the
// launches (0 = success).
extern "C" int dct_dc_launch(const void* g, const void* u, const void* v,
                             const void* cos1, const void* phic,
                             const void* phis, const void* tw,
                             const void* pos, void* partial, void* out,
                             const int* plan_ints, int L, int n, int d1,
                             int d2, float scale, void* stream) {
  return rows::dc_launch<Basis::dct>(
      g, u, v, cos1, nullptr, phic, phis, tw, pos, partial, out, plan_ints,
      L, n, d1, d2, scale, stream);
}
