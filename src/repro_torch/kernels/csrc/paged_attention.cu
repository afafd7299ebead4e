// Paged GQA decode attention (K3) for Hopper, sm_90a.
//
// Replaces the TPU kernel `paged_attention_pallas`
// (src/repro/kernels/paged_attention.py, body `_paged_attn_kernel`).
// Computes, for each slot b, window row w and query head h of kv-head
// kh = h / G, softmax attention of q[b, w, h] over the keys/values the slot's
// block table maps, row w seeing the columns < kv_len[b] + w:
//
//   q (B, W, H, dh); k/v pages (P, ps, K, dh); block_table (B, pps) int32;
//   kv_len (B,) int32 -> out (B, W, H, dh) in the pages' dtype.
//
// What bounds it on the card: bytes. Each K/V row is read once and used for
// G·W queries with 2·dh FLOP each — a handful of FLOP per byte, far below the
// card's ridge. The design reads each page exactly once per (slot, kv-head)
// and never more pages than the slot's rows need:
//
// - one block per (slot, kv-head), grid (B, K): the G query heads of the
//   group (and the W window rows) share every page load;
// - the block reads its own block-table row and kv_len (no scalar prefetch)
//   and loops over pages only up to kv_len + W - 1 columns; the TPU kernel's
//   walk over every page is skipped because a fully masked page adds exactly 0;
// - a page of K and V is staged in shared memory as f32; each warp owns whole
//   query rows, each lane dh/32 of their dimensions, so scores are a warp
//   reduction and the online-softmax state (max, denominator, accumulator) is
//   carried in f32 in shared memory that only the owning warp touches;
// - masked columns get probability exactly 0 and the final division guards
//   the denominator with max(l, 1e-30), so a fully masked row yields 0, not NaN.
//
// With B = 8 and K = 4 this launches only 32 blocks: at decode lengths the
// kernel is launch-bound. Splitting long contexts over pages (with a combine
// step) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;   // the JAX package's mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int DPL>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int* __restrict__ bt,
                  const int* __restrict__ kv_len, T* __restrict__ out, int W,
                  int H, int K, int ps, int pps, float scale) {
  constexpr int DH = DPL * 32;
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / K;
  const int R = G * W;                       // query rows: r = w * G + g
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = THREADS / 32;
  float* ks = smem;                          // (ps, DH)
  float* vs = ks + ps * DH;                  // (ps, DH)
  float* qs = vs + ps * DH;                  // (R, DH) scaled q
  float* acc = qs + R * DH;                  // (R, DH)
  float* ms = acc + R * DH;                  // (R,) running max
  float* ls = ms + R;                        // (R,) running denominator
  float* sbuf = ls + R + warp * ps;          // (ps,) this warp's scores

  for (int i = tid; i < R * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    const int w = r / G, g = r % G;
    qs[i] = to_f(q[(static_cast<size_t>(b) * W + w) * H * DH +
                   static_cast<size_t>(kh * G + g) * DH + d]) * scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    ms[r] = NEG_INF;
    ls[r] = 0.f;
  }
  const int len = kv_len[b];
  const int cols = len + W - 1;              // widest row's column limit
  int npages = cols > 0 ? (cols + ps - 1) / ps : 0;
  if (npages > pps) npages = pps;
  __syncthreads();

  for (int p = 0; p < npages; ++p) {
    const size_t page = static_cast<size_t>(bt[b * pps + p]);
    const T* kpage = kp + page * ps * K * DH + static_cast<size_t>(kh) * DH;
    const T* vpage = vp + page * ps * K * DH + static_cast<size_t>(kh) * DH;
    for (int i = tid; i < ps * DH; i += THREADS) {
      const int t = i / DH, d = i % DH;
      ks[i] = to_f(kpage[static_cast<size_t>(t) * K * DH + d]);
      vs[i] = to_f(vpage[static_cast<size_t>(t) * K * DH + d]);
    }
    __syncthreads();
    for (int r = warp; r < R; r += nwarps) {
      const int lim = len + r / G;           // row sees columns < lim
      float qr[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) qr[i] = qs[r * DH + lane + 32 * i];
      const float m_prev = ms[r];
      float m_new = m_prev;
      for (int t = 0; t < ps; ++t) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) s = fmaf(qr[i], ks[t * DH + lane + 32 * i], s);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (p * ps + t >= lim) s = NEG_INF;
        if (lane == 0) sbuf[t] = s;
        m_new = fmaxf(m_new, s);
      }
      __syncwarp();
      const float corr = expf(m_prev - m_new);
      float l = ls[r] * corr;
      float a[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) a[i] = acc[r * DH + lane + 32 * i] * corr;
      for (int t = 0; t < ps; ++t) {
        const float pe = (p * ps + t < lim) ? expf(sbuf[t] - m_new) : 0.f;
        l += pe;
#pragma unroll
        for (int i = 0; i < DPL; ++i) a[i] = fmaf(pe, vs[t * DH + lane + 32 * i], a[i]);
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r * DH + lane + 32 * i] = a[i];
      __syncwarp();
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = l;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  for (int i = tid; i < R * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    const int w = r / G, g = r % G;
    out[(static_cast<size_t>(b) * W + w) * H * DH +
        static_cast<size_t>(kh * G + g) * DH + d] =
        from_f<T>(acc[i] / fmaxf(ls[r], 1e-30f));
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* kv_len, void* out, int B, int W, int H, int K, int ps,
           int pps, float scale, cudaStream_t s) {
  const int R = (H / K) * W;
  const size_t bytes = sizeof(float) *
      (2 * static_cast<size_t>(ps) * DPL * 32 + 2 * static_cast<size_t>(R) * DPL * 32 +
       2 * static_cast<size_t>(R) + static_cast<size_t>(THREADS / 32) * ps);
  if (bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = paged_attn_kernel<T, DPL>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(B, K), THREADS, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, kv_len, static_cast<T*>(out), W, H, K,
      ps, pps, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* kp, const void* vp,
                const int* bt, const int* kv_len, void* out, int B, int W,
                int H, int K, int ps, int pps, float scale, cudaStream_t s) {
  switch (dh) {
    case 32: return launch<T, 1>(q, kp, vp, bt, kv_len, out, B, W, H, K, ps, pps, scale, s);
    case 64: return launch<T, 2>(q, kp, vp, bt, kv_len, out, B, W, H, K, ps, pps, scale, s);
    case 128: return launch<T, 4>(q, kp, vp, bt, kv_len, out, B, W, H, K, ps, pps, scale, s);
    case 256: return launch<T, 8>(q, kp, vp, bt, kv_len, out, B, W, H, K, ps, pps, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, W, H, dh), k/v pages (P, ps, K, dh), out (B, W, H, dh): all f32
// (is_bf16 = 0) or all bf16 (is_bf16 = 1); block_table (B, pps) and kv_len
// (B,) int32. dh in {32, 64, 128, 256}, H % K == 0. Returns the CUDA error
// code of the launch (0 = success).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_table,
                                      const void* kv_len, void* out, int B,
                                      int W, int H, int K, int dh, int ps,
                                      int pps, int is_bf16, void* stream) {
  if (B < 1 || W < 1 || K < 1 || H % K != 0 || ps < 1 || pps < 1 ||
      K > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_table);
  const int* kl = static_cast<const int*>(kv_len);
  if (is_bf16)
    return dispatch_dh<__nv_bfloat16>(dh, q, k_pages, v_pages, bt, kl, out,
                                      B, W, H, K, ps, pps, scale, s);
  return dispatch_dh<float>(dh, q, k_pages, v_pages, bt, kl, out, B, W, H, K,
                            ps, pps, scale, s);
}
