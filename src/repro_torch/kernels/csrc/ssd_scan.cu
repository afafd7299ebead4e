// The chunked SSD scan (Mamba2's state-space duality, arXiv:2405.21060 §6)
// for Hopper, sm_90a: forward and backward in f32 on the CUDA cores, no
// chunk's (Q, Q) scores, decay matrix or their gradients in device memory.
//
// Replaces no TPU kernel: XLA computes the JAX package's `ssd_chunked`
// (`src/repro/models/mamba2.py`, einsums and a `lax.scan` over chunks),
// and the port's plain version (`models/mamba2.py::ssd_chunked`, the CPU
// path and the tests' reference) builds every (b, nc, H, Q, Q) f32 score,
// decay and product in device memory: 470 MB a tensor at Zamba2-7B's 112
// heads and 4096 tokens, as much again for each gradient.
//
//   x (b, S, H, 64), B/C (b, S, G, N) in T (bf16 or f32); dt (b, S, H),
//   A (H,), D (H,) f32. Head h reads group h / (H / G). N 64 or 128.
//   Q <= 64 is the length of the kernel's chunks (below), S a multiple
//   (the wrapper pads a sequence with zero rows to one).
//   forward -> y (b, S, H, 64) T, the final state (b, H, 64, N) f32, and
//   for the backward cum (b, H, S) f32 (dt·A summed within each chunk)
//   and the state entering each chunk (b, S/Q, H, 64, N) f32.
//
// Numerics (`ssd_chunked`'s contract: the scan computes in f32): every
// input is promoted to f32 as it is loaded; every product and sum is an
// f32 FFMA on the CUDA cores (no TF32, no bf16 operand); exp is expf. The
// decay exp(cum_t − cum_s) is formed from the difference of the chunk's
// cumulative sums, as `_segsum` does, and only where s <= t. Sums run in
// another order than the plain version's, so results agree to f32
// rounding, not bit for bit.
//
// What bounds it on the card: operations. A Zamba2-7B layer at 4096
// tokens requires 15.2 GFLOP forward at the model's chunk of 256 (the
// benchmark's `ssd_ops`) against 121 MB of inputs and outputs
// (`ssd_bytes`): 0.23 ms at the 67 TFLOP/s of f32 FFMA, 36 µs at 3.35
// TB/s. What the design does about it:
//
// - Shorter chunks. The scan's result does not depend on the chunk: the
//   quadratic form within a chunk and the states passed between chunks
//   are two exact parts of one sum. The wrapper (`kernels/ssd_scan.py`)
//   runs the kernel on chunks of 64 rows whatever the model's chunk (S
//   rows below 64), padding the sequence at its end with zero rows (dt 0:
//   the state passes them unchanged) to a multiple of 64, so that no
//   length falls back to short chunks. Within a chunk of 256, 6
//   of the 10 pairs of 64-row tiles lie below the diagonal; passing the
//   state over 64-row chunks replaces their quadratic products (64 x 64
//   x (N + 64) a pair) by nothing more than the state updates each row
//   makes anyway, at the price of 4x the passed states (117 MB a layer in
//   f32 at Zamba2-7B's 4096 tokens, written once and read twice). On f32
//   FFMA, with no tensor cores, that is the cheaper side of the SSD
//   paper's trade-off: ~35 % fewer operations forward and backward.
// - Forward, three launches. (1) chunk_state: a block per (chunk, head)
//   forms the chunk's cumulative dt·A (a block scan) and its P x N state
//   Σ_s exp(cum_end − cum_s)·dt_s·x_s·B_sᵀ. (2) state_pass: the
//   recurrence over the chunks, in place, per head and 1024 state entries
//   a block: the state entering each chunk, kept for the backward, and the
//   final one. (3) chunk_out: a block per (chunk, group, up to 8 heads of
//   the group) forms the chunk's C·Bᵀ once (a group's scores) and keeps it
//   in registers; for each of its heads it forms exp(cum_t − cum_s)·dt_s
//   times those scores in shared memory, multiplies by x, and adds
//   exp(cum_t)·C·(entering state)ᵀ and D·x. y is written once.
// - Backward, four launches. (1) chunk_state again, on dy and C with
//   weights exp(cum_t): each chunk's Σ_t exp(cum_t)·dy_tᵀ·C_t. (2)
//   dstate_pass: the state gradients backward over the chunks, and each
//   chunk's gradient of its total decay. (3) chunk_grad: a block per
//   (chunk, group, up to 8 heads) recomputes C·Bᵀ once; for each head it
//   forms dy·xᵀ, the decay and its gradient terms, the state's terms, and
//   gives dx, ddt (the cumulative decay's gradient summed back along the
//   chunk in the block), dA's and dD's parts, while the scores' gradient
//   summed over its heads stays in registers; the group products
//   dC = dScore·B and dB = dScoreᵀ·C run once a block. (4) finish_bc: dB
//   and dC summed over the blocks of heads. Partials, not atomics, each
//   summed in a fixed order: every launch gives the same bits.
// - Tiles are 64 x 64 f32 in shared memory, rows padded by 16 bytes; 256
//   threads each hold a 4 x 4 block of a product (4 x 8 where the output
//   is N = 128 wide) and read one float4 of each operand a step. Loads are
//   synchronous (global -> registers -> shared, bf16 converted on the
//   way), overlapped by the other blocks on the SM; cp.async cannot
//   convert bf16 to f32 on the way and TMA would add a second layout of
//   every tile, so neither is used here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int P = 64;         // head dim
constexpr int TILE = 64;      // the longest chunk, and rows of a tile
constexpr int THREADS = 256;
constexpr int LD = TILE + 4;  // a padded 64-float row of shared memory

struct Dims {
  int b, S, H, G, N, Q, nc, hb;  // hb: heads a block of chunk_out/grad
};

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

// dst[r * ldd + c] = src[r * lds + c] (· scale[r]) for the 64 rows r of a
// tile and COLS columns; rows from nvalid on are zero
template <typename T, int COLS>
__device__ __forceinline__ void load_nat(float* dst, int ldd, const T* src,
                                         long lds, int nvalid,
                                         const float* scale) {
  constexpr int U = COLS / 4;
  for (int u = threadIdx.x; u < TILE * U; u += THREADS) {
    const int r = u / U, c4 = (u % U) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nvalid) {
      v = load4(src + r * lds + c4);
      if (scale) {
        const float s = scale[r];
        v.x *= s; v.y *= s; v.z *= s; v.w *= s;
      }
    }
    store4(dst + r * ldd + c4, v);
  }
}

// dst[c * ldd + r] = src[r * lds + c]: the tile transposed, four rows a
// thread (a float4 store), neighbouring threads on neighbouring columns
template <typename T, int COLS>
__device__ __forceinline__ void load_tr(float* dst, int ldd, const T* src,
                                        long lds, int nvalid) {
  for (int u = threadIdx.x; u < COLS * (TILE / 4); u += THREADS) {
    const int c = u % COLS, r0 = (u / COLS) * 4;
    float4 v;
    v.x = r0 < nvalid ? load1(src + r0 * lds + c) : 0.f;
    v.y = r0 + 1 < nvalid ? load1(src + (r0 + 1) * lds + c) : 0.f;
    v.z = r0 + 2 < nvalid ? load1(src + (r0 + 2) * lds + c) : 0.f;
    v.w = r0 + 3 < nvalid ? load1(src + (r0 + 3) * lds + c) : 0.f;
    store4(dst + c * ldd + r0, v);
  }
}

// a 64 x 64 tile of `src` into nat[r][c] and tr[c][r] (both ld LD)
template <typename T>
__device__ __forceinline__ void load_both(float* nat, float* tr,
                                          const T* src, long lds,
                                          int nvalid) {
  for (int u = threadIdx.x; u < TILE * (TILE / 4); u += THREADS) {
    const int c = u % TILE, r0 = (u / TILE) * 4;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = r0 + k < nvalid ? load1(src + (r0 + k) * lds + c) : 0.f;
      nat[(r0 + k) * LD + c] = v[k];
    }
    store4(tr + c * LD + r0, make_float4(v[0], v[1], v[2], v[3]));
  }
}

// acc[i][4 cc + j] += Σ_k At[k][4 ty + i] · Bm[k][64 cc + 4 tx + j]: the
// thread's 4 x 4 NC block of a (64 x 64 NC) product over KD steps
template <int KD, int NC>
__device__ __forceinline__ void gemm(float (&acc)[4][4 * NC],
                                     const float* At, int lda,
                                     const float* Bm, int ldb, int ty,
                                     int tx) {
  const float* ap = At + 4 * ty;
  const float* bp = Bm + 4 * tx;
#pragma unroll 8
  for (int k = 0; k < KD; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(ap + k * lda);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const float4 b =
          *reinterpret_cast<const float4*>(bp + k * ldb + 64 * cc);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][4 * cc + j] = fmaf(av[i], bv[j], acc[i][4 * cc + j]);
    }
  }
}

template <int W>
__device__ __forceinline__ void zero(float (&a)[4][W]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) a[i][j] = 0.f;
}

// the sum over the 16 lanes that share a row of 4 x 4 blocks (tx)
__device__ __forceinline__ float sum16(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

// inclusive scan of v over the first two warps (64 threads), in thread
// order; every thread of the block calls it
__device__ __forceinline__ float scan64(float v, float* w0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (threadIdx.x == 31) *w0 = v;
  __syncthreads();
  if (threadIdx.x >= 32 && threadIdx.x < 64) v += *w0;
  __syncthreads();
  return v;
}

// the sum of v over the block, in a fixed order; valid in thread 0
__device__ __forceinline__ float block_sum(float v, float* wsum) {
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  v = sum16(v);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < THREADS / 32; ++i) s += wsum[i];
  __syncthreads();
  return s;
}

// ---------------------------------------------------------------------------
// chunk_state: out[p][n] = Σ_s w_s · X[s][p] · Y[s][n] over one chunk of
// one head. Forward (FWD): X = x, Y = B, w_s = exp(cum_end − cum_s)·dt_s,
// and the block first computes and writes cum. Backward: X = dy, Y = C,
// w_s = exp(cum_s), cum read.
// grid (nc, H, b)
template <typename T, int NS, bool FWD>
__global__ void __launch_bounds__(THREADS, 2)
    chunk_state_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                       const float* __restrict__ dt,
                       const float* __restrict__ A, float* __restrict__ cum,
                       float* __restrict__ out, Dims d) {
  constexpr int NC = NS / 64;
  extern __shared__ float sm[];
  float* xs = sm;                        // [64][LD]: X rows s, weighted
  float* ys = xs + TILE * LD;            // [64][NS + 4]: Y rows s
  float* wt = ys + TILE * (NS + 4);      // [64]
  float* cs = wt + TILE;                 // [64]
  float* w0 = cs + TILE;                 // [1]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (d.H / d.G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long row0 = (long)b * d.S + (long)c * d.Q;
  float* cum_h = cum + ((long)b * d.H + h) * d.S + (long)c * d.Q;
  const bool row = tid < d.Q;
  float dts = 0.f;
  if (FWD) {
    dts = row ? dt[(row0 + tid) * d.H + h] : 0.f;
    const float v = scan64(dts * A[h], w0);
    if (row) cum_h[tid] = v;
    if (tid < TILE) cs[tid] = v;
  } else if (tid < TILE) {
    cs[tid] = row ? cum_h[tid] : 0.f;
  }
  __syncthreads();
  if (tid < TILE) {
    if (FWD)
      wt[tid] = row ? expf(cs[d.Q - 1] - cs[tid]) * dts : 0.f;
    else
      wt[tid] = row ? expf(cs[tid]) : 0.f;
  }
  __syncthreads();
  const long xst = (long)d.H * P, yst = (long)d.G * NS;
  load_nat<T, P>(xs, LD, X + (row0 * d.H + h) * P, xst, d.Q, wt);
  load_nat<T, NS>(ys, NS + 4, Y + (row0 * d.G + g) * NS, yst, d.Q, nullptr);
  __syncthreads();
  float acc[4][4 * NC];
  zero(acc);
  gemm<TILE, NC>(acc, xs, LD, ys, NS + 4, ty, tx);
  float* o = out + (((long)b * d.nc + c) * d.H + h) * P * NS;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
      store4(o + (4 * ty + i) * NS + 64 * cc + 4 * tx,
             make_float4(acc[i][4 * cc], acc[i][4 * cc + 1],
                         acc[i][4 * cc + 2], acc[i][4 * cc + 3]));
}

constexpr int PASS_AHEAD = 8;   // chunks whose loads a pass keeps in flight

// state_pass: st holds each chunk's own state; it is replaced by the
// state entering the chunk, h_{c+1} = exp(cum_end,c)·h_c + s_c, h_0 = 0;
// fin gets h_nc. grid (b·H, P·N / 1024), four entries a thread
__global__ void __launch_bounds__(THREADS)
    state_pass_kernel(float* __restrict__ st, const float* __restrict__ cum,
                      float* __restrict__ fin, Dims d) {
  const int bh = blockIdx.x, b = bh / d.H, h = bh % d.H;
  const int PN = P * d.N;
  const int e = (blockIdx.y * THREADS + threadIdx.x) * 4;
  if (e >= PN) return;
  const long step = (long)d.H * PN;
  float* base = st + ((long)b * d.nc * d.H + h) * PN + e;
  const float* cum_h = cum + (long)bh * d.S + d.Q - 1;
  float4 cur = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < d.nc; c0 += PASS_AHEAD) {
    float4 s[PASS_AHEAD];
    float eT[PASS_AHEAD];
#pragma unroll
    for (int k = 0; k < PASS_AHEAD; ++k)
      if (c0 + k < d.nc) {
        s[k] = load4(base + (c0 + k) * step);
        eT[k] = expf(cum_h[(long)(c0 + k) * d.Q]);
      }
#pragma unroll
    for (int k = 0; k < PASS_AHEAD; ++k)
      if (c0 + k < d.nc) {
        store4(base + (c0 + k) * step, cur);
        cur = fma4(eT[k], cur, s[k]);
      }
  }
  store4(fin + (long)bh * PN + e, cur);
}

// dstate_pass: gs holds each chunk's Σ_t exp(cum_t)·dy_tᵀ·C_t; it is
// replaced by the gradient of the chunk's own state, dh_{c+1}, where
// dh_c = exp(cum_end,c)·dh_{c+1} + gs_c and dh_nc = dfin (or 0). dT_part
// gets each chunk's Σ dh_{c+1}·exp(cum_end,c)·h_c over the block's
// entries. grid (b·H, P·N / 1024); shared memory 8·nc floats
__global__ void __launch_bounds__(THREADS)
    dstate_pass_kernel(float* __restrict__ gs, const float* __restrict__ hst,
                       const float* __restrict__ dfin,
                       const float* __restrict__ cum,
                       float* __restrict__ dT_part, Dims d) {
  extern __shared__ float part[];   // [nc][8]: a warp's sum of each chunk
  const int bh = blockIdx.x, b = bh / d.H, h = bh % d.H;
  const int PN = P * d.N;
  const int e = (blockIdx.y * THREADS + threadIdx.x) * 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool ok = e < PN;
  const long step = (long)d.H * PN;
  const long at0 = ((long)b * d.nc * d.H + h) * PN + e;
  const float* cum_h = cum + (long)bh * d.S + d.Q - 1;
  float4 dh = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok && dfin) dh = load4(dfin + (long)bh * PN + e);
  for (int c1 = d.nc; c1 > 0; c1 -= PASS_AHEAD) {
    float4 g4[PASS_AHEAD], hc[PASS_AHEAD];
    float eT[PASS_AHEAD];
#pragma unroll
    for (int k = 0; k < PASS_AHEAD; ++k) {
      const int c = c1 - 1 - k;
      if (c >= 0) {
        eT[k] = expf(cum_h[(long)c * d.Q]);
        if (ok) {
          g4[k] = load4(gs + at0 + c * step);
          hc[k] = load4(hst + at0 + c * step);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PASS_AHEAD; ++k) {
      const int c = c1 - 1 - k;
      if (c < 0) break;
      float v = 0.f;
      if (ok) {
        v = eT[k] * (dh.x * hc[k].x + dh.y * hc[k].y + dh.z * hc[k].z +
                     dh.w * hc[k].w);
        store4(gs + at0 + c * step, dh);
        dh = fma4(eT[k], dh, g4[k]);
      }
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      v = sum16(v);
      if (lane == 0) part[c * 8 + warp] = v;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d.nc; c += THREADS) {
    float v = 0.f;
    for (int w = 0; w < 8; ++w) v += part[c * 8 + w];
    dT_part[((long)bh * d.nc + c) * gridDim.y + blockIdx.y] = v;
  }
}

// ---------------------------------------------------------------------------
// chunk_out: y of one chunk for up to d.hb heads of one group.
// grid (ceil((H/G) / hb), nc · G, b)
template <typename T, int NS>
__global__ void __launch_bounds__(THREADS, NS == 64 ? 3 : 2)
    chunk_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const T* __restrict__ Bm, const T* __restrict__ Cm,
                     const float* __restrict__ D,
                     const float* __restrict__ cum,
                     const float* __restrict__ hst, T* __restrict__ y,
                     Dims d) {
  extern __shared__ float sm[];
  float* ct = sm;                // [NS][LD]: C of the chunk, [n][t]
  float* bt = ct + NS * LD;      // [NS][LD]: B [n][s]; then the entering
                                 // state [n][p]
  float* xs = bt + NS * LD;      // [64][LD]: x [s][p]
  float* mt = xs + TILE * LD;    // [64][LD]: x's multiplier [s][t]
  float* cq = mt + TILE * LD;    // [64]: cum
  float* dk = cq + TILE;         // [64]: dt
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int hb = blockIdx.x;
  const int c = blockIdx.y / d.G, g = blockIdx.y % d.G, b = blockIdx.z;
  const int rep = d.H / d.G;
  const int h0 = g * rep + hb * d.hb, nh = min(d.hb, rep - hb * d.hb);
  const int Q = d.Q;
  const long row0 = (long)b * d.S + (long)c * Q;
  const long bcs = (long)d.G * NS, xst = (long)d.H * P;

  load_tr<T, NS>(ct, LD, Cm + (row0 * d.G + g) * NS, bcs, Q);
  load_tr<T, NS>(bt, LD, Bm + (row0 * d.G + g) * NS, bcs, Q);
  __syncthreads();
  // cb[i][j] = Σ_n B[s = 4ty + i]·C[t = 4tx + j]
  float cb[4][4];
  zero(cb);
  gemm<NS, 1>(cb, bt, LD, ct, LD, ty, tx);

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const float* cum_h = cum + ((long)b * d.H + h) * d.S + (long)c * Q;
    __syncthreads();
    load_tr<float, NS>(bt, LD, hst + (((long)b * d.nc + c) * d.H + h) * P * NS,
                       NS, P);
    load_nat<T, P>(xs, LD, x + (row0 * d.H + h) * P, xst, Q, nullptr);
    if (tid < TILE) {
      cq[tid] = tid < Q ? cum_h[tid] : 0.f;
      dk[tid] = tid < Q ? dt[(row0 + tid) * d.H + h] : 0.f;
    }
    __syncthreads();
    // x's multiplier: (C_t·B_s)·exp(cum_t − cum_s)·dt_s where s <= t
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * ty + i;
      float m[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = 4 * tx + j;
        m[j] = s <= t && t < Q ? cb[i][j] * expf(cq[t] - cq[s]) * dk[s]
                               : 0.f;
      }
      store4(mt + s * LD + 4 * tx, make_float4(m[0], m[1], m[2], m[3]));
    }
    // exp(cum_t)·C_t·h_cᵀ (rows t, columns p), then + M·x and D·x
    float acc[4][4];
    zero(acc);
    gemm<NS, 1>(acc, ct, LD, bt, LD, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e = expf(cq[4 * ty + i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= e;
    }
    __syncthreads();
    gemm<TILE, 1>(acc, mt, LD, xs, LD, ty, tx);
    const float Dh = D[h];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * ty + i;
      if (t >= Q) continue;
      const float4 xv = load4(xs + t * LD + 4 * tx);
      store4(y + ((row0 + t) * d.H + h) * P + 4 * tx,
             make_float4(fmaf(Dh, xv.x, acc[i][0]), fmaf(Dh, xv.y, acc[i][1]),
                         fmaf(Dh, xv.z, acc[i][2]),
                         fmaf(Dh, xv.w, acc[i][3])));
    }
  }
}

// ---------------------------------------------------------------------------
// chunk_grad: the gradients of one chunk for up to d.hb heads of one group
// (module comment). Writes dx, ddt, dA_part and dD_part for its rows and
// heads, and its blocks' parts of dB and dC.
// grid (ceil((H/G) / hb), nc · G, b)
template <typename T, int NS>
__global__ void __launch_bounds__(THREADS, NS == 64 ? 2 : 1)
    chunk_grad_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ D, const T* __restrict__ dy,
                      const float* __restrict__ cum,
                      const float* __restrict__ hst,
                      const float* __restrict__ dst,
                      const float* __restrict__ dT_part, int nsl,
                      T* __restrict__ dx, float* __restrict__ ddt,
                      float* __restrict__ dA_part,
                      float* __restrict__ dD_part,
                      float* __restrict__ dB_part,
                      float* __restrict__ dC_part, Dims d) {
  constexpr int NC = NS / 64;
  constexpr int SB = NS * LD > TILE * (NS + 4) ? NS * LD : TILE * (NS + 4);
  extern __shared__ float sm[];
  float* ya = sm;                    // [64][LD]: dy [t][p] (ya, yb: C
  float* yb = ya + TILE * LD;        // [64][LD]: dy [p][t]  at the ends)
  float* kk = yb + TILE * LD;        // [64][LD]: the scores' decay product
  float* xt = kk + TILE * LD;        // [64][LD]: x [p][s]
  float* bt = xt + TILE * LD;        // [NS][LD]: B [n][s]; at the end [s][n]
  float* sb = bt + NS * LD;          // [SB]: dS [n][p], dS [p][n], h [p][n]
  float* cs = sb + SB;               // [64]: cum
  float* ds = cs + TILE;             // [64]: dt
  float* wv = ds + TILE;             // [64]: the state terms' dcum_s
  float* dc = wv + TILE;             // [64]: the head's dcum
  float* dxx = dc + TILE;            // [64]: ddt's dtx term
  float* red = dxx + TILE;           // [8][64]
  float* red2 = red + 8 * TILE;      // [8]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int hb = blockIdx.x;
  const int c = blockIdx.y / d.G, g = blockIdx.y % d.G, b = blockIdx.z;
  const int rep = d.H / d.G;
  const int h0 = g * rep + hb * d.hb, nh = min(d.hb, rep - hb * d.hb);
  const int Q = d.Q;
  const long row0 = (long)b * d.S + (long)c * Q;
  const long bcs = (long)d.G * NS, xst = (long)d.H * P;
  const long nrows = (long)d.b * d.S;

  load_tr<T, NS>(bt, LD, Bm + (row0 * d.G + g) * NS, bcs, Q);
  load_tr<T, NS>(ya, LD, Cm + (row0 * d.G + g) * NS, bcs, Q);   // [n][t]
  __syncthreads();
  // cb[i][j] = Σ_n C[t = 4ty + i]·B[s = 4tx + j]
  float cb[4][4];
  zero(cb);
  gemm<NS, 1>(cb, ya, LD, bt, LD, ty, tx);
  float sg[4][4];           // the scores' gradient over the block's heads
  float dbacc[4][4 * NC];   // dB's state terms: rows s, columns n
  float dcacc[4][4 * NC];   // dC's state-output terms: rows t, columns n
  zero(sg);
  zero(dbacc);
  zero(dcacc);

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const float* cum_h = cum + ((long)b * d.H + h) * d.S + (long)c * Q;
    const long st_at = (((long)b * d.nc + c) * d.H + h) * P * NS;
    const float Tc = cum_h[Q - 1];
    __syncthreads();
    if (tid < TILE) {
      cs[tid] = tid < Q ? cum_h[tid] : 0.f;
      ds[tid] = tid < Q ? dt[(row0 + tid) * d.H + h] : 0.f;
      dc[tid] = 0.f;
    }
    load_tr<T, P>(xt, LD, x + (row0 * d.H + h) * P, xst, Q);
    load_tr<float, NS>(sb, LD, dst + st_at, NS, P);
    load_both<T>(ya, yb, dy + (row0 * d.H + h) * P, xst, Q);
    __syncthreads();
    // dtx's state term: exp(cum_end − cum_s)·Σ_n B[s][n]·dS[p][n]
    float acc[4][4];
    zero(acc);
    gemm<NS, 1>(acc, bt, LD, sb, LD, ty, tx);
    float es[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * ty + i;
      es[i] = s < Q ? expf(Tc - cs[s]) : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= es[i];
    }
    __syncthreads();
    load_nat<float, NS>(sb, NS + 4, dst + st_at, NS, P, nullptr);
    __syncthreads();
    {
      // dB's state term: exp(cum_end − cum_s)·dt_s·Σ_p x[s][p]·dS[p][n];
      // w_s = Σ_n B[s][n]·that, the state's share of dcum_s (and dT)
      float tmp[4][4 * NC];
      zero(tmp);
      gemm<TILE, NC>(tmp, xt, LD, sb, NS + 4, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = 4 * ty + i;
        const float f = es[i] * ds[s];
        float w = 0.f;
#pragma unroll
        for (int q = 0; q < 4 * NC; ++q) {
          const int n = 64 * (q / 4) + 4 * tx + q % 4;
          tmp[i][q] *= f;
          w = fmaf(tmp[i][q], bt[n * LD + s], w);
          dbacc[i][q] += tmp[i][q];
        }
        w = sum16(w);
        if (tx == 0) wv[s] = w;
      }
    }
    __syncthreads();
    load_nat<float, NS>(sb, NS + 4, hst + st_at, NS, P, nullptr);
    __syncthreads();
    {
      // the state output's terms: dC_t += exp(cum_t)·Σ_p dy[t][p]·h[p][n]
      // and dcum_t += Σ_n C[t][n]·that
      float oc[4][4 * NC];
      zero(oc);
      gemm<TILE, NC>(oc, yb, LD, sb, NS + 4, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
        const bool okt = t < Q;
        const float et = okt ? expf(cs[t]) : 0.f;
        const T* crow = Cm + ((row0 + t) * d.G + g) * NS;
        float r = 0.f;
#pragma unroll
        for (int q = 0; q < 4 * NC; ++q) {
          oc[i][q] *= et;
          if (okt)
            r = fmaf(oc[i][q], load1(crow + 64 * (q / 4) + 4 * tx + q % 4), r);
          dcacc[i][q] += oc[i][q];
        }
        r = sum16(r);
        if (tx == 0 && okt) dc[t] += r;
      }
    }
    float dd = 0.f;
    for (int e = tid; e < Q * TILE; e += THREADS) {
      const int t = e / TILE, p = e % TILE;
      dd = fmaf(ya[t * LD + p], xt[p * LD + t], dd);
    }
    {
      // u[t][s] = Σ_p dy[t][p]·x[s][p]; the decay L, the scores' product
      // K = cb·L (dtx's multiplier), its gradient dK = dt_s·u
      float u[4][4];
      zero(u);
      gemm<TILE, 1>(u, yb, LD, xt, LD, ty, tx);
      float rrow[4] = {0.f, 0.f, 0.f, 0.f}, rcol[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
        float kv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = 4 * tx + j;
          const bool ok = s <= t && t < Q;
          const float L = ok ? expf(cs[t] - cs[s]) : 0.f;
          const float K = cb[i][j] * L;
          const float dK = ds[s] * u[i][j];
          const float r = dK * K;                // cum_t's, −cum_s's
          sg[i][j] = fmaf(dK, L, sg[i][j]);      // the scores' gradient
          rrow[i] += r;
          rcol[j] += r;
          kv[j] = K;
        }
        store4(kk + t * LD + 4 * tx, make_float4(kv[0], kv[1], kv[2], kv[3]));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = sum16(rrow[i]);
        if (tx == 0 && 4 * ty + i < Q) dc[4 * ty + i] += v;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = rcol[j] + __shfl_xor_sync(0xffffffffu, rcol[j], 16);
        if (lane < 16) red[warp * TILE + 4 * tx + j] = v;
      }
    }
    __syncthreads();
    // dtx += Σ_t K[t][s]·dy[t][p]
    gemm<TILE, 1>(acc, kk, LD, ya, LD, ty, tx);
    // dx = dtx·dt + D·dy; ddt's dtx term Σ_p dtx·x
    const float Dh = D[h];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * ty + i;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v = fmaf(acc[i][j], xt[(4 * tx + j) * LD + s], v);
      v = sum16(v);
      if (s >= Q) continue;
      if (tx == 0) dxx[s] = v;
      const float4 yv = load4(ya + s * LD + 4 * tx);
      const float sdt = ds[s];
      store4(dx + ((row0 + s) * d.H + h) * P + 4 * tx,
             make_float4(fmaf(acc[i][0], sdt, Dh * yv.x),
                         fmaf(acc[i][1], sdt, Dh * yv.y),
                         fmaf(acc[i][2], sdt, Dh * yv.z),
                         fmaf(acc[i][3], sdt, Dh * yv.w)));
    }
    const float ddh = block_sum(dd, red2);   // (synchronises)
    // the head's dcum: the scores' column sums, the state terms, and at the
    // chunk's end their sum and the recurrence's dT
    float dcum = 0.f;
    if (tid < Q) {
      float v = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) v += red[w * TILE + tid];
      dcum = dc[tid] - v - wv[tid];
      if (tid == Q - 1) {
        for (int s = 0; s < Q; ++s) dcum += wv[s];
        const float* dT = dT_part + (((long)b * d.H + h) * d.nc + c) * nsl;
        for (int k = 0; k < nsl; ++k) dcum += dT[k];
      }
    }
    // da_s = Σ_{r >= s} dcum_r: a scan over the reversed rows
    const int r = Q - 1 - tid;
    if (tid < TILE) dc[tid] = dcum;
    __syncthreads();
    const float da = scan64(tid < Q ? dc[r] : 0.f, red2);
    float part = 0.f;
    if (tid < Q) {
      const long at = (row0 + r) * d.H + h;
      ddt[at] = fmaf(da, A[h], dxx[r]);
      part = da * ds[r];
    }
    const float dah = block_sum(part, red2);
    if (tid == 0) {
      dA_part[((long)b * d.nc + c) * d.H + h] = dah;
      dD_part[((long)b * d.nc + c) * d.H + h] = ddh;
    }
  }

  // dB = its state terms + Σ_t dScore[t][s]·C[t][n]
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
    store4(kk + (4 * ty + i) * LD + 4 * tx,
           make_float4(sg[i][0], sg[i][1], sg[i][2], sg[i][3]));
  load_nat<T, NS>(ya, NS + 4, Cm + (row0 * d.G + g) * NS, bcs, Q, nullptr);
  __syncthreads();
  gemm<TILE, NC>(dbacc, kk, LD, ya, NS + 4, ty, tx);
  {
    float* o = dB_part + ((long)hb * nrows + row0) * bcs + (long)g * NS;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * ty + i;
      if (s >= Q) continue;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
        store4(o + s * bcs + 64 * cc + 4 * tx,
               make_float4(dbacc[i][4 * cc], dbacc[i][4 * cc + 1],
                           dbacc[i][4 * cc + 2], dbacc[i][4 * cc + 3]));
    }
  }
  // dC = its state terms + Σ_s dScore[t][s]·B[s][n]
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) kk[(4 * tx + j) * LD + 4 * ty + i] = sg[i][j];
  load_nat<T, NS>(bt, NS + 4, Bm + (row0 * d.G + g) * NS, bcs, Q, nullptr);
  __syncthreads();
  gemm<TILE, NC>(dcacc, kk, LD, bt, NS + 4, ty, tx);
  {
    float* o = dC_part + ((long)hb * nrows + row0) * bcs + (long)g * NS;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * ty + i;
      if (t >= Q) continue;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
        store4(o + t * bcs + 64 * cc + 4 * tx,
               make_float4(dcacc[i][4 * cc], dcacc[i][4 * cc + 1],
                           dcacc[i][4 * cc + 2], dcacc[i][4 * cc + 3]));
    }
  }
}

// finish_bc: dB and dC, each the sum over the blocks of heads
__global__ void __launch_bounds__(THREADS)
    finish_bc_kernel(const float* __restrict__ dB_part,
                     const float* __restrict__ dC_part, int nhb,
                     float* __restrict__ dB, float* __restrict__ dC,
                     long total) {
  const long e = (long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < nhb; ++k) {
    sb += dB_part[k * total + e];
    sc += dC_part[k * total + e];
  }
  dB[e] = sb;
  dC[e] = sc;
}

// ---------------------------------------------------------------------------
// host side

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename K>
cudaError_t smem_attr(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int NS>
size_t state_smem() {
  return sizeof(float) * (TILE * LD + TILE * (NS + 4) + 2 * TILE + 4);
}
template <int NS>
size_t out_smem() {
  return sizeof(float) * (2 * NS * LD + 2 * TILE * LD + 2 * TILE);
}
template <int NS>
size_t grad_smem() {
  constexpr int SB = NS * LD > TILE * (NS + 4) ? NS * LD : TILE * (NS + 4);
  return sizeof(float) *
         (4 * TILE * LD + NS * LD + SB + 5 * TILE + 8 * TILE + 8);
}

template <typename T, int NS>
int fwd(const void* const* p, const Dims& d, cudaStream_t st) {
  const T* x = static_cast<const T*>(p[0]);
  const float* dt = static_cast<const float*>(p[1]);
  const float* A = static_cast<const float*>(p[2]);
  const T* B = static_cast<const T*>(p[3]);
  const T* C = static_cast<const T*>(p[4]);
  const float* D = static_cast<const float*>(p[5]);
  T* y = static_cast<T*>(const_cast<void*>(p[6]));
  float* fin = static_cast<float*>(const_cast<void*>(p[7]));
  float* cum = static_cast<float*>(const_cast<void*>(p[8]));
  float* hst = static_cast<float*>(const_cast<void*>(p[9]));
  cudaError_t e;
  const size_t s1 = state_smem<NS>(), s3 = out_smem<NS>();
  if ((e = smem_attr(chunk_state_kernel<T, NS, true>, s1))) return e;
  if ((e = smem_attr(chunk_out_kernel<T, NS>, s3))) return e;
  chunk_state_kernel<T, NS, true><<<dim3(d.nc, d.H, d.b), THREADS, s1, st>>>(
      x, B, dt, A, cum, hst, d);
  if ((e = cudaGetLastError())) return e;
  state_pass_kernel<<<dim3(d.b * d.H, ceil_div(P * NS, 4 * THREADS)),
                      THREADS, 0, st>>>(hst, cum, fin, d);
  if ((e = cudaGetLastError())) return e;
  const int nhb = ceil_div(d.H / d.G, d.hb);
  chunk_out_kernel<T, NS><<<dim3(nhb, d.nc * d.G, d.b), THREADS, s3, st>>>(
      x, dt, B, C, D, cum, hst, y, d);
  return cudaGetLastError();
}

template <typename T, int NS>
int bwd(const void* const* p, const Dims& d, cudaStream_t st) {
  const T* x = static_cast<const T*>(p[0]);
  const float* dt = static_cast<const float*>(p[1]);
  const float* A = static_cast<const float*>(p[2]);
  const T* B = static_cast<const T*>(p[3]);
  const T* C = static_cast<const T*>(p[4]);
  const float* D = static_cast<const float*>(p[5]);
  const T* dy = static_cast<const T*>(p[6]);
  const float* dfin = static_cast<const float*>(p[7]);   // may be null
  float* cum = static_cast<float*>(const_cast<void*>(p[8]));
  const float* hst = static_cast<const float*>(p[9]);
  float* dst = static_cast<float*>(const_cast<void*>(p[10]));
  float* dT_part = static_cast<float*>(const_cast<void*>(p[11]));
  float* dA_part = static_cast<float*>(const_cast<void*>(p[12]));
  float* dD_part = static_cast<float*>(const_cast<void*>(p[13]));
  float* dB_part = static_cast<float*>(const_cast<void*>(p[14]));
  float* dC_part = static_cast<float*>(const_cast<void*>(p[15]));
  T* dx = static_cast<T*>(const_cast<void*>(p[16]));
  float* ddt = static_cast<float*>(const_cast<void*>(p[17]));
  float* dB = static_cast<float*>(const_cast<void*>(p[18]));
  float* dC = static_cast<float*>(const_cast<void*>(p[19]));
  cudaError_t e;
  const size_t s1 = state_smem<NS>(), s3 = grad_smem<NS>();
  const size_t s2 = sizeof(float) * 8 * d.nc;
  if ((e = smem_attr(chunk_state_kernel<T, NS, false>, s1))) return e;
  if ((e = smem_attr(dstate_pass_kernel, s2))) return e;
  if ((e = smem_attr(chunk_grad_kernel<T, NS>, s3))) return e;
  chunk_state_kernel<T, NS, false><<<dim3(d.nc, d.H, d.b), THREADS, s1,
                                     st>>>(dy, C, dt, A, cum, dst, d);
  if ((e = cudaGetLastError())) return e;
  const int nsl = ceil_div(P * NS, 4 * THREADS);
  dstate_pass_kernel<<<dim3(d.b * d.H, nsl), THREADS, s2, st>>>(
      dst, hst, dfin, cum, dT_part, d);
  if ((e = cudaGetLastError())) return e;
  const int nhb = ceil_div(d.H / d.G, d.hb);
  chunk_grad_kernel<T, NS><<<dim3(nhb, d.nc * d.G, d.b), THREADS, s3, st>>>(
      x, dt, A, B, C, D, dy, cum, hst, dst, dT_part, nsl, dx, ddt, dA_part,
      dD_part, dB_part, dC_part, d);
  if ((e = cudaGetLastError())) return e;
  const long total = (long)d.b * d.S * d.G * d.N;
  finish_bc_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0,
                     st>>>(dB_part, dC_part, nhb, dB, dC, total);
  return cudaGetLastError();
}

Dims dims_of(const int* v) {
  // b, S, H, G, N, Q, hb
  Dims d;
  d.b = v[0]; d.S = v[1]; d.H = v[2]; d.G = v[3]; d.N = v[4]; d.Q = v[5];
  d.hb = v[6];
  d.nc = d.Q > 0 ? d.S / d.Q : 0;
  return d;
}

bool dims_ok(const Dims& d) {
  return d.b > 0 && d.Q > 0 && d.Q <= TILE && d.S % d.Q == 0 && d.G > 0 &&
         d.H % d.G == 0 && (d.N == 64 || d.N == 128) && d.hb > 0 &&
         8 * d.nc <= 200 * 1024 / 4;   // dstate_pass's shared memory
}

}  // namespace

// ptrs: x, dt, A, B, C, D, y, final, cum, entering states;
// dims: b, S, H, G, N, Q (the kernel's chunk, <= 64), heads a block, is_bf16
extern "C" int ssd_scan_fwd_launch(const void* const* ptrs, const int* dims,
                                   void* stream) {
  const Dims d = dims_of(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dims[7])
    return d.N == 64 ? fwd<bf16, 64>(ptrs, d, st) : fwd<bf16, 128>(ptrs, d, st);
  return d.N == 64 ? fwd<float, 64>(ptrs, d, st) : fwd<float, 128>(ptrs, d, st);
}

// ptrs: x, dt, A, B, C, D, dy, dfinal (or null), cum, entering states;
// scratch: dS (b, nc, H, P, N), dT_part, dA_part, dD_part, dB_part,
// dC_part; outputs: dx, ddt, dB, dC (f32)
extern "C" int ssd_scan_bwd_launch(const void* const* ptrs, const int* dims,
                                   void* stream) {
  const Dims d = dims_of(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dims[7])
    return d.N == 64 ? bwd<bf16, 64>(ptrs, d, st) : bwd<bf16, 128>(ptrs, d, st);
  return d.N == 64 ? bwd<float, 64>(ptrs, d, st) : bwd<float, 128>(ptrs, d, st);
}
