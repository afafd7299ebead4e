// Fused causal (and non-causal) GQA attention for Hopper, sm_90a: the
// forward and its recomputing backward, bf16 on the tensor cores, no
// (S, S) tensor in device memory.
//
// Replaces no TPU kernel. The JAX package computes this attention with
// einsums (`src/repro/models/attention.py`, the direct path up to 1024
// rows), and the port's plain form of it (`models/attention.py`
// `direct_attention`) builds every (B, K, G, S, S) score, probability and
// gradient in f32 in device memory: 1 GiB a tensor at 8 x 1024 rows, 32
// heads, three times a layer with remat. This kernel does the same
// arithmetic tile by tile:
//
//   q (B, S, H, dh), k/v (B, S, K, dh) bf16, head h reads kv head h / G
//   -> out (B, S, H, dh) bf16, lse (B, H, S) f32 (the row log-sum-exp)
//   backward: + out, dout, lse -> dq, dk, dv bf16 (and D (B, H, S) f32,
//   rowsum(dout * out), written by the dq pass for the dk/dv pass)
//
// Numerics (the direct path's are the contract; nothing is computed in
// less precision than there):
// - scores: bf16 q and k on mma.sync with f32 accumulation (the products
//   of bf16 values are exact in f32, as in the f32 einsum of bf16-exact
//   values), the scale dh^-0.5 applied to the f32 scores; running row max
//   and sum in f32; P cast to bf16 before P·V (as `_softmax_value` casts
//   to v's dtype), O accumulated in f32 and divided by the f32 sum.
// - backward: S and P recomputed from q, k and lse; dV = Pᵀ·dO with P in
//   bf16; dP = dO·Vᵀ in f32; D = rowsum(dO ∘ O) in f32; dS = P ∘ (dP − D)
//   in f32. dQ = dS·K and dK = dSᵀ·Q take dS as two bf16 terms, hi =
//   bf16(dS) and lo = bf16(dS − hi), in two MMAs each: 16 significant bits
//   of dS against bf16's 8 (the direct path multiplies an f32 dS by f32 k
//   and q). dq, dk, dv are rounded to bf16 once, at the end.
//
// What bounds it on the card: operations. At 8 x 1024 rows, 32 q heads of
// 128 and 4 kv heads, a causal layer is 68.7 GFLOP forward (2·2·dh per
// visible (row, column) pair and head) against 0.1 GB of q/k/v/out: 660
// FLOP a byte, above the H100's ridge (~295 in bf16). K and V of one
// batch row (0.5 MiB a kv head) stay in the 50 MB L2 while the G heads
// that read them run. The design (FlashAttention-2's, on mma.sync):
//
// - Forward: a block of 4 warps per (q head, batch row, 64-row q tile),
//   each warp 16 rows; q's fragments stay in registers; K/V tiles of 64
//   rows are staged by cp.async (16 bytes a lane) into two stages, the
//   next tile in flight while this one is computed; S = QKᵀ and O += PV
//   on `mma.sync.m16n8k16` (bf16 in, f32 accumulate), P going from the
//   score accumulators to the A fragments of P·V without shared memory.
//   Causal: only kv tiles up to the diagonal are visited, and only the
//   diagonal tile and a ragged last tile are masked. Grid (H, B, q tiles)
//   with the q tiles longest first and the G heads of a kv head adjacent.
// - Backward, two passes, no atomics (the same bits on every launch):
//   the dq pass (a block per q tile, as the forward; it first computes D
//   for its rows and writes it) walks the kv tiles it sees; the dk/dv
//   pass (a block per 64-row kv tile of one kv head) walks its G q heads
//   and their q tiles from the diagonal on, with dK and dV in registers.
//   Each pass recomputes S and dP: 9 tile products a visible tile pair
//   (hi/lo counted) against 7 for a pass with dq atomics.
// - Shared-memory rows are padded by 16 bytes (conflict-free ldmatrix).
//   Head dims: an instance for 64 and one for 128 columns; a narrower
//   head (any multiple of 8) is zero-padded by the copies, so dh 112 runs
//   on the 128 instance. Rows past S are zero-filled and masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BM = 64;   // q rows of a forward / dq block (16 a warp)
constexpr int BN = 64;   // kv rows of a tile, and of a dk/dv block
constexpr int BQ = 64;   // q rows of a tile in the dk/dv pass
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Dims {
  int B, S, H, K, dh, causal;
  float scale;   // dh^-0.5, on the f32 scores
};

template <int DH>
struct Tile {
  static constexpr int STRIDE = DH + 8;            // elements a smem row
  static constexpr int ELEMS = 64 * STRIDE;        // one 64-row tile
  static constexpr int BYTES = ELEMS * 2;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// D += A·B, m16n8k16, bf16 in, f32 accumulate (A row-major, B col-major)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as the bf16 pair of a fragment (the lower column low)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) as hi = bf16(x) and lo = bf16(x - hi), each a packed pair
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Per-lane offsets (elements) of the ldmatrix addresses inside a tile:
// A fragment of rows [m0, m0+16) x cols [k0, k0+16) of a [m][k] tile;
// B fragments of two n8 tiles [n0, n0+16) x [k0, k0+16) of a [n][k] tile;
// the same of a [k][n] tile, transposed by ldmatrix.
template <int DH>
struct Lanes {
  int a, b, bt;
  __device__ Lanes(int lane) {
    constexpr int S = Tile<DH>::STRIDE;
    a = (lane % 16) * S + (lane / 16) * 8;
    b = ((lane % 8) + (lane / 16) * 8) * S + ((lane / 8) % 2) * 8;
    bt = ((lane % 8) + ((lane / 8) % 2) * 8) * S + (lane / 16) * 8;
  }
};

// Stage 64 rows [r0, r0 + 64) of head `head` of x (B, S, NH, dh) into a
// tile, 16 bytes a copy (neighbouring lanes on neighbouring addresses);
// rows at or past S and columns at or past dh are zero-filled by the copy.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* x, int b,
                                          int r0, int head, int NH,
                                          const Dims& d) {
  constexpr int SEGS = DH / 8;
  const int valid = d.dh / 8;
  for (int i = threadIdx.x; i < 64 * SEGS; i += THREADS) {
    const int r = i / SEGS, sg = i % SEGS;
    const int row = r0 + r;
    const bool ok = row < d.S && sg < valid;
    const bf16* src =
        ok ? x + ((static_cast<size_t>(b) * d.S + row) * NH + head) * d.dh +
                 sg * 8
           : x;
    cp_async16(dst + r * Tile<DH>::STRIDE + sg * 8, src, ok ? 16 : 0);
  }
}

// 64 f32 values [r0, r0 + 64) of row (b, head) of x (B, NH, S); zeros past S
__device__ __forceinline__ void load_row(float* dst, const float* x, int b,
                                         int r0, int head, int NH,
                                         const Dims& d) {
  if (threadIdx.x < 64) {
    const int row = r0 + threadIdx.x;
    const bool ok = row < d.S;
    const float* src =
        ok ? x + (static_cast<size_t>(b) * NH + head) * d.S + row : x;
    cp_async4(dst + threadIdx.x, src, ok ? 4 : 0);
  }
}

// acc (16 x 64 per warp, 8 n8 tiles) = A (16 x DH, rows m0 of `as`) ·
// Bᵀ, B the 64 rows of `bs` ([n][k])
template <int DH>
__device__ __forceinline__ void rows_by_tile(float (&acc)[8][4],
                                             const bf16* as, int m0,
                                             const bf16* bs,
                                             const Lanes<DH>& ln) {
  constexpr int S = Tile<DH>::STRIDE;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, as + m0 * S + kk * 16 + ln.a);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bb[4];
      ldsm_x4(bb, bs + np * 16 * S + kk * 16 + ln.b);
      mma(acc[2 * np], a, bb[0], bb[1]);
      mma(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// out (16 x DH per warp) += P (16 x 64, fragments from accumulators) · X,
// X the 64 rows of `xs` ([k][n]); with `LO`, P is split into hi and lo
// and both are multiplied.
template <int DH, bool LO>
__device__ __forceinline__ void tile_by_rows(float (&out)[DH / 8][4],
                                             const float (&p)[8][4],
                                             const bf16* xs,
                                             const Lanes<DH>& ln) {
  constexpr int S = Tile<DH>::STRIDE;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    uint32_t hi[4], lo[4];
    if (LO) {
      split(p[2 * t][0], p[2 * t][1], hi[0], lo[0]);
      split(p[2 * t][2], p[2 * t][3], hi[1], lo[1]);
      split(p[2 * t + 1][0], p[2 * t + 1][1], hi[2], lo[2]);
      split(p[2 * t + 1][2], p[2 * t + 1][3], hi[3], lo[3]);
    } else {
      hi[0] = pack(p[2 * t][0], p[2 * t][1]);
      hi[1] = pack(p[2 * t][2], p[2 * t][3]);
      hi[2] = pack(p[2 * t + 1][0], p[2 * t + 1][1]);
      hi[3] = pack(p[2 * t + 1][2], p[2 * t + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t bb[4];
      ldsm_x4_t(bb, xs + t * 16 * S + dp * 16 + ln.bt);
      mma(out[2 * dp], hi, bb[0], bb[1]);
      mma(out[2 * dp + 1], hi, bb[2], bb[3]);
      if (LO) {
        mma(out[2 * dp], lo, bb[0], bb[1]);
        mma(out[2 * dp + 1], lo, bb[2], bb[3]);
      }
    }
  }
}

// Store a warp's 16 x DH f32 accumulator, times `mul`, as bf16 rows of
// x (B, S, NH, dh): rows row0 + {0, 8} of each lane, past S dropped
template <int DH>
__device__ __forceinline__ void store_rows(bf16* x,
                                           const float (&acc)[DH / 8][4],
                                           int b, int row0, int head, int NH,
                                           const Dims& d, float mul) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= d.S) continue;
    bf16* dst = x + ((static_cast<size_t>(b) * d.S + row) * NH + head) * d.dh;
#pragma unroll
    for (int t = 0; t < DH / 8; ++t) {
      const int col = t * 8 + 2 * (lane % 4);
      if (col < d.dh)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            acc[t][2 * r] * mul, acc[t][2 * r + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ lse, Dims d) {
  constexpr int S = Tile<DH>::STRIDE, T = Tile<DH>::ELEMS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kvs = qs + T;   // stage s: K at kvs + 2sT, V at kvs + (2s+1)T
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_q = (d.S + BM - 1) / BM;
  const int qt = n_q - 1 - blockIdx.z;   // the longest q tiles first
  const int kh = h / (d.H / d.K);
  const int q0 = qt * BM;
  const int n_kv = d.causal ? qt + 1 : (d.S + BN - 1) / BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Lanes<DH> ln(lane);

  load_tile<DH>(qs, q, b, q0, h, d.H, d);
  load_tile<DH>(kvs, k, b, 0, kh, d.K, d);
  load_tile<DH>(kvs + T, v, b, 0, kh, d.K, d);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldsm_x4(qf[kk], qs + warp * 16 * S + kk * 16 + ln.a);

  float o[DH / 8][4];
#pragma unroll
  for (int t = 0; t < DH / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = d.scale * LOG2E;
  const int row0 = q0 + warp * 16 + lane / 4;

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait_all();
    __syncthreads();   // tile j landed; every warp is done with tile j-1
    if (j + 1 < n_kv) {
      bf16* nk = kvs + ((j + 1) & 1) * 2 * T;
      load_tile<DH>(nk, k, b, (j + 1) * BN, kh, d.K, d);
      load_tile<DH>(nk + T, v, b, (j + 1) * BN, kh, d.K, d);
    }
    cp_async_commit();
    const bf16* ks = kvs + (j & 1) * 2 * T;
    const bf16* vs = ks + T;

    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, ks + np * 16 * S + kk * 16 + ln.b);
        mma(s[2 * np], qf[kk], bb[0], bb[1]);
        mma(s[2 * np + 1], qf[kk], bb[2], bb[3]);
      }

    // scaled scores in log2 units; masked columns -inf
    const int c0 = j * BN;
    const bool edge = (d.causal && j == qt) || c0 + BN > d.S;
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * sl2;
        if (edge) {
          const int col = c0 + t * 8 + 2 * (lane % 4) + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (col >= d.S || (d.causal && col > row)) x = -INFINITY;
        }
        s[t][e] = x;
      }

    // online softmax, one kv tile (two rows a lane, a row over a quad)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      mx[0] = fmaxf(mx[0], fmaxf(s[t][0], s[t][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[t][2], s[t][3]));
    }
    float base[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      corr[r] = exp2f(m[r] - base[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      s[t][0] = exp2f(s[t][0] - base[0]);
      s[t][1] = exp2f(s[t][1] - base[0]);
      s[t][2] = exp2f(s[t][2] - base[1]);
      s[t][3] = exp2f(s[t][3] - base[1]);
      rs[0] += s[t][0] + s[t][1];
      rs[1] += s[t][2] + s[t][3];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int t = 0; t < DH / 8; ++t) {
      o[t][0] *= corr[0];
      o[t][1] *= corr[0];
      o[t][2] *= corr[1];
      o[t][3] *= corr[1];
    }
    tile_by_rows<DH, false>(o, s, vs, ln);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // O / l in f32 (every row sees at least one column: l > 0)
#pragma unroll
  for (int t = 0; t < DH / 8; ++t) {
    o[t][0] /= l[0];
    o[t][1] /= l[0];
    o[t][2] /= l[1];
    o[t][3] /= l[1];
  }
  store_rows<DH>(out, o, b, row0, h, d.H, d, 1.f);
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row < d.S)
        lse[(static_cast<size_t>(b) * d.H + h) * d.S + row] =
            (m[r] + log2f(l[r])) * LN2;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, pass 1: D and dq. A block per (q head, batch row, q tile).
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
    bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ out,
                  const bf16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  bf16* __restrict__ dq, Dims d) {
  constexpr int S = Tile<DH>::STRIDE, T = Tile<DH>::ELEMS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + T;
  bf16* kvs = dos + T;   // stage s: K at kvs + 2sT, V at kvs + (2s+1)T
  float* lse_s = reinterpret_cast<float*>(kvs + 4 * T);
  float* d_s = lse_s + BM;
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_q = (d.S + BM - 1) / BM;
  const int qt = n_q - 1 - blockIdx.z;
  const int kh = h / (d.H / d.K);
  const int q0 = qt * BM;
  const int n_kv = d.causal ? qt + 1 : (d.S + BN - 1) / BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Lanes<DH> ln(lane);

  // q, dout, out (in stage 1's K slot, free until tile 1 is issued), tile 0
  bf16* os = kvs + 2 * T;
  load_tile<DH>(qs, q, b, q0, h, d.H, d);
  load_tile<DH>(dos, dout, b, q0, h, d.H, d);
  load_tile<DH>(os, out, b, q0, h, d.H, d);
  load_tile<DH>(kvs, k, b, 0, kh, d.K, d);
  load_tile<DH>(kvs + T, v, b, 0, kh, d.K, d);
  load_row(lse_s, lse, b, q0, h, d.H, d);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  {
    // D = rowsum(dout * out) in f32: two lanes a row, half the columns each
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    float acc = 0.f;
#pragma unroll 8
    for (int c = half * (DH / 2); c < (half + 1) * (DH / 2); ++c)
      acc += __bfloat162float(dos[r * S + c]) * __bfloat162float(os[r * S + c]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      d_s[r] = acc;
      if (q0 + r < d.S)
        delta[(static_cast<size_t>(b) * d.H + h) * d.S + q0 + r] = acc;
    }
  }
  __syncthreads();
  const int row0 = q0 + warp * 16 + lane / 4;
  const int lr = warp * 16 + lane / 4;
  const float lse2[2] = {lse_s[lr] * LOG2E, lse_s[lr + 8] * LOG2E};
  const float dr[2] = {d_s[lr], d_s[lr + 8]};
  const float sl2 = d.scale * LOG2E;

  float acc[DH / 8][4];
#pragma unroll
  for (int t = 0; t < DH / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < n_kv) {
      bf16* nk = kvs + ((j + 1) & 1) * 2 * T;
      load_tile<DH>(nk, k, b, (j + 1) * BN, kh, d.K, d);
      load_tile<DH>(nk + T, v, b, (j + 1) * BN, kh, d.K, d);
    }
    cp_async_commit();
    const bf16* ks = kvs + (j & 1) * 2 * T;
    const bf16* vs = ks + T;

    float p[8][4], ds[8][4];
    rows_by_tile<DH>(p, qs, warp * 16, ks, ln);
    const int c0 = j * BN;
    const bool edge = (d.causal && j == qt) || c0 + BN > d.S;
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (edge) {
          const int col = c0 + t * 8 + 2 * (lane % 4) + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          ok = col < d.S && !(d.causal && col > row);
        }
        p[t][e] = ok ? exp2f(fmaf(p[t][e], sl2, -lse2[e >> 1])) : 0.f;
      }
    rows_by_tile<DH>(ds, dos, warp * 16, vs, ln);   // dP
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[t][e] = p[t][e] * (ds[t][e] - dr[e >> 1]);
    tile_by_rows<DH, true>(acc, ds, ks, ln);   // dQ += dS·K, hi and lo
  }
  store_rows<DH>(dq, acc, b, row0, h, d.H, d, d.scale);
}

// ---------------------------------------------------------------------------
// Backward, pass 2: dk and dv. A block per (kv head, batch row, kv tile):
// the G q heads of the kv head, their q tiles from the diagonal on.
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
    bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, Dims d) {
  constexpr int T = Tile<DH>::ELEMS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + T;
  bf16* qds = vs + T;   // stage s: Q at qds + 2sT, dO at qds + (2s+1)T
  float* rows = reinterpret_cast<float*>(qds + 4 * T);   // stage s: lse, D
  const int kh = blockIdx.x, b = blockIdx.y, jt = blockIdx.z;
  const int G = d.H / d.K;
  const int k0 = jt * BN;
  const int n_q = (d.S + BQ - 1) / BQ;
  const int i0 = d.causal ? k0 / BQ : 0;
  const int cnt = n_q - i0, total = G * cnt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Lanes<DH> ln(lane);

  auto issue = [&](int it, int stage) {
    const int g = it / cnt, i = i0 + it - g * cnt;
    const int h = kh * G + g;
    bf16* dst = qds + stage * 2 * T;
    load_tile<DH>(dst, q, b, i * BQ, h, d.H, d);
    load_tile<DH>(dst + T, dout, b, i * BQ, h, d.H, d);
    load_row(rows + stage * 2 * BQ, lse, b, i * BQ, h, d.H, d);
    load_row(rows + stage * 2 * BQ + BQ, delta, b, i * BQ, h, d.H, d);
  };
  load_tile<DH>(ks, k, b, k0, kh, d.K, d);
  load_tile<DH>(vs, v, b, k0, kh, d.K, d);
  issue(0, 0);
  cp_async_commit();

  float dka[DH / 8][4], dva[DH / 8][4];
#pragma unroll
  for (int t = 0; t < DH / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[t][e] = dva[t][e] = 0.f;
  const float sl2 = d.scale * LOG2E;
  const int krow0 = k0 + warp * 16 + lane / 4;

  for (int it = 0; it < total; ++it) {
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < total) issue(it + 1, (it + 1) & 1);
    cp_async_commit();
    const int c0 = (i0 + it % cnt) * BQ;   // the tile's first q row
    const bf16* qs = qds + (it & 1) * 2 * T;
    const bf16* dos = qs + T;
    const float* lse_s = rows + (it & 1) * 2 * BQ;
    const float* d_s = lse_s + BQ;

    // Pᵀ: kv rows of this warp x the tile's q rows
    float p[8][4], ds[8][4];
    rows_by_tile<DH>(p, ks, warp * 16, qs, ln);
    const bool edge = (d.causal && c0 < k0 + BN) || c0 + BQ > d.S ||
                      k0 + BN > d.S;
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = t * 8 + 2 * (lane % 4) + (e & 1);
        bool ok = true;
        if (edge) {
          const int col = c0 + cl, row = krow0 + (e >> 1) * 8;
          ok = col < d.S && row < d.S && !(d.causal && col < row);
        }
        p[t][e] = ok ? exp2f(fmaf(p[t][e], sl2, -lse_s[cl] * LOG2E)) : 0.f;
      }
    tile_by_rows<DH, false>(dva, p, dos, ln);   // dV += Pᵀ·dO
    rows_by_tile<DH>(ds, vs, warp * 16, dos, ln);   // dPᵀ
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = t * 8 + 2 * (lane % 4) + (e & 1);
        ds[t][e] = p[t][e] * (ds[t][e] - d_s[cl]);
      }
    tile_by_rows<DH, true>(dka, ds, qs, ln);   // dK += dSᵀ·Q, hi and lo
  }
  store_rows<DH>(dk, dka, b, krow0, kh, d.K, d, d.scale);
  store_rows<DH>(dv, dva, b, krow0, kh, d.K, d, 1.f);
}

template <int DH>
constexpr size_t fwd_smem() { return 5 * static_cast<size_t>(Tile<DH>::BYTES); }
template <int DH>
constexpr size_t bwd_smem() {
  return 6 * static_cast<size_t>(Tile<DH>::BYTES) + 4 * 64 * sizeof(float);
}

template <int DH>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, const Dims& d, cudaStream_t st) {
  const size_t smem = fwd_smem<DH>();
  cudaFuncSetAttribute(fwd_kernel<DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const dim3 grid(d.H, d.B, (d.S + BM - 1) / BM);
  fwd_kernel<DH><<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, d);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, const Dims& d, cudaStream_t st) {
  const size_t smem = bwd_smem<DH>();
  cudaFuncSetAttribute(bwd_dq_kernel<DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  cudaFuncSetAttribute(bwd_dkdv_kernel<DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const dim3 gq(d.H, d.B, (d.S + BM - 1) / BM);
  bwd_dq_kernel<DH><<<gq, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), d);
  int code = static_cast<int>(cudaGetLastError());
  if (code) return code;
  const dim3 gk(d.K, d.B, (d.S + BN - 1) / BN);
  bwd_dkdv_kernel<DH><<<gk, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), d);
  return static_cast<int>(cudaGetLastError());
}

Dims dims(int B, int S, int H, int K, int dh, int causal, float scale) {
  Dims d;
  d.B = B;
  d.S = S;
  d.H = H;
  d.K = K;
  d.dh = dh;
  d.causal = causal;
  d.scale = scale;
  return d;
}

}  // namespace

// The wrapper (kernels/fused_attention.py) checks shapes, dtypes and
// contiguity: bf16, dh a multiple of 8 up to 128, H a multiple of K.
extern "C" int fused_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* out,
                                          void* lse, int B, int S, int H,
                                          int K, int dh, int causal,
                                          float scale, void* stream) {
  const Dims d = dims(B, S, H, K, dh, causal, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return dh <= 64 ? launch_fwd<64>(q, k, v, out, l, d, st)
                  : launch_fwd<128>(q, k, v, out, l, d, st);
}

// delta: (B, H, S) f32 scratch, written by the dq pass
extern "C" int fused_attention_bwd_launch(const void* q, const void* k,
                                          const void* v, const void* out,
                                          const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk,
                                          void* dv, int B, int S, int H,
                                          int K, int dh, int causal,
                                          float scale, void* stream) {
  const Dims d = dims(B, S, H, K, dh, causal, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  return dh <= 64
             ? launch_bwd<64>(q, k, v, out, dout, l, dl, dq, dk, dv, d, st)
             : launch_bwd<128>(q, k, v, out, dout, l, dl, dq, dk, dv, d, st);
}
