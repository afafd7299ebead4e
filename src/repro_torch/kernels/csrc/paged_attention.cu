// Paged GQA decode attention (K3) for Hopper, sm_90a: split over pages
// (flash-decoding), bf16 on the tensor cores.
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
// What bounds it on the card: bytes. Each K/V row (2·dh bytes in bf16) is
// read once and used by the G·W query rows of its kv-head: G·W FLOP per
// byte (8 at G 8, W 1; 40 at W 5), far below the ridge of the tensor cores
// but, at W 5, 40 % of the FP32 CUDA-core peak at full memory rate. The
// design:
//
// - Split over pages (flash-decoding). One block per (split, kv-head x row
//   group, slot): split s walks a contiguous run of the slot's pages with
//   an online softmax in f32 and writes its partial (max, denominator,
//   accumulator) to a workspace; a second small kernel combines the
//   splits of each row in split order (the same bits on every launch, no
//   atomics). The host planner (kernels/paged_attention.py, `split_plan`)
//   sizes the splits so that the blocks fill every SM once (the blocks an
//   SM holds from `paged_attention_occupancy`), from the block table's
//   capacity (kv_len stays on the card); with one split the block
//   writes the output itself and no combine runs. Blocks past a slot's
//   kv_len + W - 1 columns exit at once.
// - Bytes. Key rows are staged CHUNK at a time, in their own dtype, by
//   cp.async of 16 bytes per lane (neighbouring lanes on neighbouring
//   addresses), into two stages: the next chunk's copies fly while this
//   chunk's math runs. The key rows' pool offsets come from the block table
//   two chunks ahead, so no copy waits on a block-table read. Rows past the
//   split's end are zero-filled by the copy itself. Head dims whose rows
//   are not 16-byte pieces take plain loads (the same layout).
// - Math, bf16. S = QKᵀ and O += PV on `mma.sync.m16n8k16` (bf16 in, f32
//   accumulate), FlashAttention-2 style with everything in registers: the
//   G·W rows of the kv-head are M tiles of 16 (zero rows past the last), q's
//   fragments are loaded once, and each warp takes one M tile and a slice
//   of every chunk's keys (all four warps on one tile at W 1), keeping its
//   own running max, denominator and accumulator; the probabilities go
//   from the score fragments to the A fragments of P·V as bf16 without
//   touching shared memory, and the slices merge once at the end. One
//   barrier per chunk. head_dim is zero-padded to a multiple of 16 in
//   shared memory, which is how any head_dim <= 256 is taken.
// - Math, f32: exact FP32 FMAs (its tolerance is 1e-5), float4
//   shared-memory reads, scores and probabilities through shared memory.
// - Masking. A masked column gets probability exactly 0; a row that sees no
//   column keeps max -1e30, denominator 0 and accumulator 0, and both the
//   single-split epilogue and the combine divide by max(l, 1e-30), so a
//   fully masked row (kv_len 0) yields 0, not NaN, also when every split of
//   the row is empty.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;   // the JAX package's mask value

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const int* bt;
  const int* kv_len;
  void* out;
  float* ml;      // (splits, B, W, H, 2) partial max and denominator
  float* pacc;    // (splits, B, W, H, dh) partial accumulator, 16-byte
                  // aligned (the combine reads it as float4)
  int B, W, H, K, dh, ps, pps, splits, pps_split, rows, groups;
  int vec, qvec;   // K/V rows and q rows in 16-byte pieces: cp.async
  float scale;
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared-memory layout of one block, in bytes (the host planner does not
// restate it: it asks `paged_attention_occupancy`): K and V of two chunks (for
// bf16 at least the size of the final merge of the warps' key slices,
// which reuses them), q, for f32 the scores (the probabilities overwrite
// them in place, each row by the one warp that reads it) and the per-row
// max, denominator and rescale factor, then OFF_SLOTS chunks' key-row
// offsets into the page pool. The row strides (K/V/q rows 4 mod 8 words
// apart in bf16, scores CHUNK + 4 words) keep the fragment and float4
// loads free of bank conflicts.
constexpr int OFF_SLOTS = 4;   // chunks' key-row offsets kept at once

template <typename T, int CHUNK>
struct Layout {
  static constexpr bool BF16 = sizeof(T) == 2;
  int stride, sstride, rows, kd;
  size_t kv, q, s, m, l, c, offs, total;
  __host__ __device__ Layout(int dh, int nrows) {
    kd = BF16 ? round_up(dh, 16) : round_up(dh, 4);
    stride = kd + (BF16 ? 8 : 4);
    sstride = CHUNK + 4;                      // f32 scores
    rows = BF16 ? round_up(nrows, 16) : round_up(nrows, 4);
    kv = 0;
    size_t ring = 4 * static_cast<size_t>(CHUNK) * stride * sizeof(T);
    if (BF16) {
      const size_t merge = (WARPS * 16 * (kd + 1) + 2 * WARPS * 16) * 4;
      ring = ring > merge ? ring : round_up(static_cast<int>(merge), 16);
    }
    q = kv + ring;
    s = q + static_cast<size_t>(rows) * stride * sizeof(T);
    const size_t srows = BF16 ? 0 : rows;
    m = s + srows * sstride * sizeof(float);
    l = m + srows * sizeof(float);
    c = l + srows * sizeof(float);
    offs = c + srows * sizeof(float);
    total = offs + OFF_SLOTS * CHUNK * sizeof(long long);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats as the bf16 pair of an mma fragment (the lower column low)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D += A·B, m16n8k16, bf16 in, f32 accumulate (A row-major, B col-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the B fragment (16 keys x 8 dims) of P·V from V stored [key][dim]
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

// Element offset of key row `key` of kv-head kh in the page pool, or -1
// for a row at or past k1 (staged as zeros: the online softmax gives it
// probability 0, and a zero row keeps 0·V finite).
__device__ __forceinline__ long long row_offset(const Args& a, int page,
                                               int kh, int key, int k1) {
  if (key >= k1) return -1;
  return (static_cast<long long>(page) * a.ps + key % a.ps) * a.K * a.dh +
         static_cast<long long>(kh) * a.dh;
}

__device__ __forceinline__ int page_of(const Args& a, const int* bt_b,
                                       int key, int k1) {
  return key < k1 ? bt_b[key / a.ps] : 0;
}

// Stage the CHUNK key rows whose pool offsets are `offs` (-1: zeros). The
// 16-byte path walks (row, piece) with the piece fastest, so neighbouring
// lanes copy neighbouring addresses of a row, with no division per copy.
template <typename T, int CHUNK>
__device__ __forceinline__ void load_chunk(const Args& a, T* ks, T* vs,
                                           int stride,
                                           const long long* offs) {
  const T* kp = static_cast<const T*>(a.kp);
  const T* vp = static_cast<const T*>(a.vp);
  if (a.vec) {
    constexpr int PER = 16 / sizeof(T);       // elements per 16-byte piece
    const int segs = a.dh / PER;
    int row = threadIdx.x / segs, sg = threadIdx.x - row * segs;
    const int drow = THREADS / segs, dseg = THREADS - drow * segs;
    while (row < CHUNK) {
      const long long off = offs[row];
      const bool ok = off >= 0;
      const size_t src = ok ? static_cast<size_t>(off) + sg * PER : 0;
      cp_async16(ks + row * stride + sg * PER, kp + src, ok ? 16 : 0);
      cp_async16(vs + row * stride + sg * PER, vp + src, ok ? 16 : 0);
      sg += dseg;
      row += drow;
      if (sg >= segs) {
        sg -= segs;
        ++row;
      }
    }
  } else {
    for (int i = threadIdx.x; i < CHUNK * a.dh; i += THREADS) {
      const int row = i / a.dh, d = i - row * a.dh;
      const long long off = offs[row];
      T kv = from_f<T>(0.f), vv = from_f<T>(0.f);
      if (off >= 0) {
        kv = kp[off + d];
        vv = vp[off + d];
      }
      ks[row * stride + d] = kv;
      vs[row * stride + d] = vv;
    }
  }
}

// Where a row's result goes: the output (one split) or the split's partial.
__device__ __forceinline__ size_t out_row(const Args& a, int b, int kh,
                                          int G, int ridx) {
  const int w = ridx / G, g = ridx - w * G;
  return (static_cast<size_t>(b) * a.W + w) * a.H + kh * G + g;
}

// Stage the block's q rows (raw; the scale goes on the f32 scores) in
// columns [0, dh); rows past the block's own are zero. The pad columns
// [dh, kd) are zeroed with the K/V stages'.
template <typename T>
__device__ __forceinline__ void load_q(const Args& a, int b, int kh, int G,
                                       int r0, int nrows, int rows, T* qs,
                                       int stride) {
  const T* q = static_cast<const T*>(a.q);
  if (a.qvec) {
    constexpr int PER = 16 / sizeof(T);
    const int segs = a.dh / PER;
    for (int i = threadIdx.x; i < rows * segs; i += THREADS) {
      const int rl = i / segs, sg = i - rl * segs;
      const bool ok = rl < nrows;
      const T* src = ok ? q + out_row(a, b, kh, G, r0 + rl) * a.dh + sg * PER
                        : q;
      cp_async16(qs + rl * stride + sg * PER, src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * a.dh; i += THREADS) {
      const int rl = i / a.dh, d = i - rl * a.dh;
      qs[rl * stride + d] =
          rl < nrows ? q[out_row(a, b, kh, G, r0 + rl) * a.dh + d]
                     : from_f<T>(0.f);
    }
  }
}

// The ring of K/V chunks: chunk c lives in stage c % 2, and chunk c+1 is
// in flight while chunk c is computed: it is issued right after the
// barrier that opens chunk c (its stage held chunk c-1, whose math every
// warp has finished). Chunk c+2's key-row offsets are read from the block
// table while chunk c is computed.
template <typename T, int CHUNK>
struct Ring {
  const Args& a;
  T* kv;
  long long* offs;
  const int* bt_b;
  size_t stage;
  int stride, kh, k0, k1, n;

  __device__ Ring(const Args& a_, unsigned char* smem,
                  const Layout<T, CHUNK>& L, int b, int kh_, int k0_, int k1_)
      : a(a_), kv(reinterpret_cast<T*>(smem + L.kv)),
        offs(reinterpret_cast<long long*>(smem + L.offs)),
        bt_b(a_.bt + static_cast<size_t>(b) * a_.pps),
        stage(static_cast<size_t>(CHUNK) * L.stride), stride(L.stride),
        kh(kh_), k0(k0_), k1(k1_),
        n(k1_ > k0_ ? (k1_ - k0_ + CHUNK - 1) / CHUNK : 0) {}

  __device__ const T* k(int c) const { return kv + (c & 1) * 2 * stage; }
  __device__ const T* v(int c) const { return k(c) + stage; }
  __device__ long long* slot(int c) const {
    return offs + (c % OFF_SLOTS) * CHUNK;
  }
  __device__ void issue(int c) const {
    T* dst = kv + (c & 1) * 2 * stage;
    load_chunk<T, CHUNK>(a, dst, dst + stage, stride, slot(c));
  }
  // the page of chunk c's row `threadIdx.x` (threads < CHUNK), read early
  __device__ int page(int c) const {
    const int key = k0 + c * CHUNK + threadIdx.x;
    return threadIdx.x < CHUNK && c < n ? page_of(a, bt_b, key, k1) : 0;
  }
  __device__ void store(int c, int pg) const {
    if (threadIdx.x < CHUNK && c < n) {
      const int key = k0 + c * CHUNK + threadIdx.x;
      slot(c)[threadIdx.x] = row_offset(a, pg, kh, key, k1);
    }
  }
  // offsets of chunks 0 and 1, then chunk 0 issued (with q's copies,
  // issued before, in its group)
  __device__ void start() const {
    store(0, page(0));
    store(1, page(1));
    __syncthreads();
    if (n > 0) issue(0);
    cp_async_commit();
  }
  // chunk c landed for every thread, and every warp is done with chunk
  // c-1; then chunk c+1 goes out
  __device__ void open(int c) const {
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < n) issue(c + 1);
    cp_async_commit();
  }
};

// Online-softmax update of one chunk (f32): the scores S (rows x CHUNK)
// become probabilities in place, with the new max/denominator and each
// row's rescale factor for the accumulator. One warp per row.
template <int CHUNK>
__device__ __forceinline__ void softmax_chunk(float* S, float* ms,
                                              float* ls, float* cs,
                                              int sstride, int nrows, int r0,
                                              int G, int len, int key0,
                                              int k1) {
  constexpr int NI = (CHUNK + 31) / 32;
  const int lane = threadIdx.x & 31;
  for (int rl = threadIdx.x >> 5; rl < nrows; rl += WARPS) {
    const int w = (r0 + rl) / G;
    const int lim = min(len + w, k1) - key0;   // columns this row sees
    float sv[NI];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int t = lane + 32 * i;
      sv[i] = (t < CHUNK && t < lim) ? S[rl * sstride + t] : NEG_INF;
      mx = fmaxf(mx, sv[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_old = ms[rl];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int t = lane + 32 * i;
      const float p = (t < CHUNK && t < lim) ? expf(sv[i] - m_new) : 0.f;
      sum += p;
      if (t < CHUNK) S[rl * sstride + t] = p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const float corr = expf(m_old - m_new);
      cs[rl] = corr;
      ls[rl] = ls[rl] * corr + sum;
      ms[rl] = m_new;
    }
  }
}

template <typename T>
__device__ __forceinline__ void emit(const Args& a, size_t row, int d,
                                     float acc, float l) {
  if (a.splits == 1)
    static_cast<T*>(a.out)[row * a.dh + d] =
        from_f<T>(acc / fmaxf(l, 1e-30f));
  else
    a.pacc[(static_cast<size_t>(blockIdx.x) * a.B * a.W * a.H + row) * a.dh +
           d] = acc;
}

// Block prologue shared by both instances: this block's rows and key range.
struct Block {
  int b, kh, r0, nrows, len, k0, k1, G;
};

__device__ __forceinline__ bool block_range(const Args& a, Block& blk) {
  blk.b = blockIdx.z;
  blk.kh = blockIdx.y / a.groups;
  const int rg = blockIdx.y - blk.kh * a.groups;
  blk.G = a.H / a.K;
  blk.r0 = rg * a.rows;
  blk.nrows = min(a.rows, blk.G * a.W - blk.r0);
  blk.len = a.kv_len[blk.b];
  const int cols = max(0, min(blk.len + a.W - 1, a.pps * a.ps));
  const int span = a.pps_split * a.ps;
  blk.k0 = blockIdx.x * span;
  blk.k1 = min(blk.k0 + span, cols);
  // a split past the slot's columns has nothing to add (the combine reads
  // only the splits that ran); a single split runs to write zero rows
  return a.splits == 1 || blk.k0 < cols;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int HC, int CHUNK, int KSPLIT, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
paged_attn_bf16(const Args a) {
  using T = __nv_bfloat16;
  constexpr int NDT = HC / 8;                // dim n-tiles of PV
  constexpr int KW = CHUNK / KSPLIT;         // keys of a warp's slice
  constexpr int NKT = KW / 8;                // key n-tiles of the slice
  constexpr bool QREG = HC <= 128;           // q's fragments in registers
  static_assert(KW % 16 == 0 && WARPS % KSPLIT == 0, "bad key slices");
  extern __shared__ __align__(16) unsigned char smem[];
  Block blk;
  if (!block_range(a, blk)) return;
  const Layout<T, CHUNK> L(a.dh, a.rows);
  T* kv = reinterpret_cast<T*>(smem + L.kv);
  T* qs = reinterpret_cast<T*>(smem + L.q);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int stride = L.stride, kd = L.kd;
  // warp (mt, ks): M tile mt of the rows, key slice ks of every chunk;
  // warps past MT·KSPLIT only help stage the chunks
  const int MT = (blk.nrows + 15) / 16;
  const int mt = warp / KSPLIT, ks = warp - mt * KSPLIT;
  const bool active = mt < MT;
  const int kbase = ks * KW;

  // zero the pad columns [dh, kd) of every staged K/V row and q row (the
  // copies write [0, dh) only; q follows the stages with the same stride)
  if (kd > a.dh) {
    const int pad = kd - a.dh;
    for (int i = tid; i < (4 * CHUNK + L.rows) * pad; i += THREADS)
      kv[(i / pad) * stride + a.dh + i % pad] = from_f<T>(0.f);
  }
  load_q<T>(a, blk.b, blk.kh, blk.G, blk.r0, blk.nrows, L.rows, qs, stride);

  // rows g and g+8 of the warp's M tile: the columns each sees
  const int rlo = mt * 16 + g, rhi = rlo + 8;
  const int lim_lo = blk.len + (rlo < blk.nrows ? (blk.r0 + rlo) / blk.G : 0);
  const int lim_hi = blk.len + (rhi < blk.nrows ? (blk.r0 + rhi) / blk.G : 0);
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
  float acc[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  uint32_t qf[QREG ? HC / 16 : 1][4];

  const Ring<T, CHUNK> ring(a, smem, L, blk.b, blk.kh, blk.k0, blk.k1);
  ring.start();
  for (int c = 0; c < ring.n; ++c) {
    ring.open(c);
    const int ahead = ring.page(c + 2);
    const T* ks_ = ring.k(c);
    const T* vs = ring.v(c);
    const int key0 = blk.k0 + c * CHUNK + kbase;   // the slice's first key
    if (QREG && c == 0 && active) {
#pragma unroll
      for (int kk = 0; kk < (QREG ? HC / 16 : 1); ++kk) {
        const T* qr = qs + rlo * stride + kk * 16 + 2 * tig;
        qf[kk][0] = kk * 16 < kd ? ld32(qr) : 0u;
        qf[kk][1] = kk * 16 < kd ? ld32(qr + 8 * stride) : 0u;
        qf[kk][2] = kk * 16 < kd ? ld32(qr + 8) : 0u;
        qf[kk][3] = kk * 16 < kd ? ld32(qr + 8 * stride + 8) : 0u;
      }
    }
    if (active) {
      // S = q·Kᵀ over the slice: n-tile j holds keys key0 + 8j + 2·tig (+1)
      float s[NKT][4];
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HC / 16; ++kk) {
        if (kk * 16 < kd) {
          uint32_t af[4];
          if (QREG) {
#pragma unroll
            for (int e = 0; e < 4; ++e) af[e] = qf[QREG ? kk : 0][e];
          } else {
            const T* qr = qs + rlo * stride + kk * 16 + 2 * tig;
            af[0] = ld32(qr);
            af[1] = ld32(qr + 8 * stride);
            af[2] = ld32(qr + 8);
            af[3] = ld32(qr + 8 * stride + 8);
          }
#pragma unroll
          for (int j = 0; j < NKT; ++j) {
            const T* kr = ks_ + (kbase + j * 8 + g) * stride + kk * 16 +
                          2 * tig;
            mma_bf16(s[j], af, ld32(kr), ld32(kr + 8));
          }
        }
      }
      // online softmax in registers: a row's values sit in the 4 lanes of
      // a quad, so its max is two shuffles; l stays a per-lane partial
      const int clo = min(lim_lo, blk.k1) - key0;
      const int chi = min(lim_hi, blk.k1) - key0;
      float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        const int t = j * 8 + 2 * tig;
        s[j][0] = t < clo ? s[j][0] * a.scale : NEG_INF;
        s[j][1] = t + 1 < clo ? s[j][1] * a.scale : NEG_INF;
        s[j][2] = t < chi ? s[j][2] * a.scale : NEG_INF;
        s[j][3] = t + 1 < chi ? s[j][3] * a.scale : NEG_INF;
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float cr_lo = expf(m_lo - mn_lo), cr_hi = expf(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      l_lo *= cr_lo;
      l_hi *= cr_hi;
#pragma unroll
      for (int i = 0; i < NDT; ++i) {
        acc[i][0] *= cr_lo;
        acc[i][1] *= cr_lo;
        acc[i][2] *= cr_hi;
        acc[i][3] *= cr_hi;
      }
      // p (masked columns exactly 0), packed as the A fragments of P·V
      uint32_t pf[NKT][2];
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        const float p0 = s[j][0] > NEG_INF ? expf(s[j][0] - mn_lo) : 0.f;
        const float p1 = s[j][1] > NEG_INF ? expf(s[j][1] - mn_lo) : 0.f;
        const float p2 = s[j][2] > NEG_INF ? expf(s[j][2] - mn_hi) : 0.f;
        const float p3 = s[j][3] > NEG_INF ? expf(s[j][3] - mn_hi) : 0.f;
        l_lo += p0 + p1;
        l_hi += p2 + p3;
        pf[j][0] = pack_bf16(p0, p1);
        pf[j][1] = pack_bf16(p2, p3);
      }
      // acc += P·V: k-step kk covers the slice's keys 16kk..16kk+15
#pragma unroll
      for (int kk = 0; kk < NKT / 2; ++kk) {
        const uint32_t af[4] = {pf[2 * kk][0], pf[2 * kk][1],
                                pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
        const T* vr = vs + (kbase + kk * 16 + (lane & 15)) * stride;
#pragma unroll
        for (int i = 0; i < NDT; ++i) {
          if (i * 8 < kd) {
            uint32_t b0, b1;
            ldmatrix_x2_trans(b0, b1, vr + i * 8);
            mma_bf16(acc[i], af, b0, b1);
          }
        }
      }
    }
    ring.store(c + 2, ahead);
  }
  cp_async_wait_all();
  __syncthreads();

  // merge the key slices of each M tile, in slice order, through the
  // (now free) K/V stages: per warp 16 rows of (max, denominator, acc)
  float* abuf = reinterpret_cast<float*>(smem + L.kv);
  const int astride = kd + 1;
  float* mbuf = abuf + WARPS * 16 * astride;
  float* lbuf = mbuf + WARPS * 16;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o);
  }
  if (active) {
    float* aw = abuf + warp * 16 * astride;
    if (tig == 0) {
      mbuf[warp * 16 + g] = m_lo;
      mbuf[warp * 16 + g + 8] = m_hi;
      lbuf[warp * 16 + g] = l_lo;
      lbuf[warp * 16 + g + 8] = l_hi;
    }
#pragma unroll
    for (int i = 0; i < NDT; ++i) {
      const int d = i * 8 + 2 * tig;
      if (d < kd) {
        aw[g * astride + d] = acc[i][0];
        aw[g * astride + d + 1] = acc[i][1];
        aw[(g + 8) * astride + d] = acc[i][2];
        aw[(g + 8) * astride + d + 1] = acc[i][3];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < blk.nrows * a.dh; i += THREADS) {
    const int r = i / a.dh, d = i - r * a.dh;
    const int w0 = (r >> 4) * KSPLIT, rr = r & 15;
    float M = NEG_INF;
    for (int k = 0; k < KSPLIT; ++k) M = fmaxf(M, mbuf[(w0 + k) * 16 + rr]);
    float l = 0.f, o = 0.f;
    for (int k = 0; k < KSPLIT; ++k) {
      const float wk = expf(mbuf[(w0 + k) * 16 + rr] - M);
      l += wk * lbuf[(w0 + k) * 16 + rr];
      o += wk * abuf[((w0 + k) * 16 + rr) * astride + d];
    }
    const size_t row = out_row(a, blk.b, blk.kh, blk.G, blk.r0 + r);
    emit<T>(a, row, d, o, l);
    if (a.splits > 1 && d == 0) {
      float* ml = a.ml +
          (static_cast<size_t>(blockIdx.x) * a.B * a.W * a.H + row) * 2;
      ml[0] = M;
      ml[1] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: exact FP32 FMAs
// ---------------------------------------------------------------------------

template <int HC, int CHUNK, int MAXR>
__global__ void __launch_bounds__(THREADS, 2)
paged_attn_f32(const Args a) {
  using T = float;
  constexpr int TPK = THREADS / CHUNK;       // threads per key (scores)
  constexpr int RPT = MAXR / TPK;            // score rows per thread
  constexpr int NG = (HC / 4 + 31) / 32;     // float4 dim groups per lane
  constexpr int RPW = MAXR / WARPS;          // accumulator rows per warp
  static_assert(TPK >= 1 && RPT >= 1, "bad f32 geometry");
  extern __shared__ __align__(16) unsigned char smem[];
  Block blk;
  if (!block_range(a, blk)) return;
  const Layout<T, CHUNK> L(a.dh, a.rows);
  T* kv = reinterpret_cast<T*>(smem + L.kv);
  T* qs = reinterpret_cast<T*>(smem + L.q);
  float* S = reinterpret_cast<float*>(smem + L.s);
  float* ms = reinterpret_cast<float*>(smem + L.m);
  float* ls = reinterpret_cast<float*>(smem + L.l);
  float* cs = reinterpret_cast<float*>(smem + L.c);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int stride = L.stride, sstride = L.sstride;
  const int kd = L.kd;

  if (kd > a.dh) {
    const int pad = kd - a.dh;
    for (int i = tid; i < (4 * CHUNK + L.rows) * pad; i += THREADS)
      kv[(i / pad) * stride + a.dh + i % pad] = 0.f;
  }
  load_q<T>(a, blk.b, blk.kh, blk.G, blk.r0, blk.nrows, L.rows, qs, stride);
  for (int r = tid; r < L.rows; r += THREADS) {
    ms[r] = NEG_INF;
    ls[r] = 0.f;
  }

  float4 acc[NG][RPW];
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int j = 0; j < RPW; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  const Ring<T, CHUNK> ring(a, smem, L, blk.b, blk.kh, blk.k0, blk.k1);
  ring.start();
  const int t = tid % CHUNK, o = tid / CHUNK;
  for (int c = 0; c < ring.n; ++c) {
    ring.open(c);
    const int ahead = ring.page(c + 2);
    const T* ks = ring.k(c);
    const T* vs = ring.v(c);
    const int key0 = blk.k0 + c * CHUNK;

    // S[r][t] = (q_r·k_t)·scale: thread (t, o) takes rows o + TPK*j
    {
      float sacc[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) sacc[j] = 0.f;
      const float* kr = ks + t * stride;
      for (int d = 0; d < kd; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int rl = o + TPK * j;
          if (rl < blk.nrows) {
            const float4 qq =
                *reinterpret_cast<const float4*>(qs + rl * stride + d);
            sacc[j] = fmaf(qq.x, kk.x, sacc[j]);
            sacc[j] = fmaf(qq.y, kk.y, sacc[j]);
            sacc[j] = fmaf(qq.z, kk.z, sacc[j]);
            sacc[j] = fmaf(qq.w, kk.w, sacc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int rl = o + TPK * j;
        if (rl < blk.nrows) S[rl * sstride + t] = sacc[j] * a.scale;
      }
    }
    ring.store(c + 2, ahead);
    __syncthreads();
    softmax_chunk<CHUNK>(S, ms, ls, cs, sstride, blk.nrows, blk.r0, blk.G,
                         blk.len, key0, blk.k1);
    __syncthreads();

    // acc[r][d..d+3] = acc·corr + Σ_t p[r][t]·V[t][d..d+3]: lane-owned
    // float4 dim groups, rows warp + WARPS*j
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int rl = warp + WARPS * j;
      if (rl < blk.nrows) {
        const float cr = cs[rl];
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          acc[i][j].x *= cr;
          acc[i][j].y *= cr;
          acc[i][j].z *= cr;
          acc[i][j].w *= cr;
        }
      }
    }
    for (int tk = 0; tk < CHUNK; ++tk) {
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int d = (lane + 32 * i) * 4;
        if (d < kd) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vs + tk * stride + d);
#pragma unroll
          for (int j = 0; j < RPW; ++j) {
            const int rl = warp + WARPS * j;
            if (rl < blk.nrows) {
              const float p = S[rl * sstride + tk];
              acc[i][j].x = fmaf(p, vv.x, acc[i][j].x);
              acc[i][j].y = fmaf(p, vv.y, acc[i][j].y);
              acc[i][j].z = fmaf(p, vv.z, acc[i][j].z);
              acc[i][j].w = fmaf(p, vv.w, acc[i][j].w);
            }
          }
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int rl = warp + WARPS * j;
    if (rl < blk.nrows) {
      const size_t row = out_row(a, blk.b, blk.kh, blk.G, blk.r0 + rl);
      const float l = ls[rl];
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int d = (lane + 32 * i) * 4;
        const float v[4] = {acc[i][j].x, acc[i][j].y, acc[i][j].z,
                            acc[i][j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < a.dh) emit<T>(a, row, d + e, v[e], l);
      }
    }
  }
  if (a.splits > 1) {
    for (int rl = tid; rl < blk.nrows; rl += THREADS) {
      const size_t row = out_row(a, blk.b, blk.kh, blk.G, blk.r0 + rl);
      float* ml = a.ml +
          (static_cast<size_t>(blockIdx.x) * a.B * a.W * a.H + row) * 2;
      ml[0] = ms[rl];
      ml[1] = ls[rl];
    }
  }
}

// ---------------------------------------------------------------------------
// Combine: one warp per output row, splits merged in split order
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
combine_splits(const Args a) {
  const int lane = threadIdx.x & 31;
  const size_t nrows = static_cast<size_t>(a.B) * a.W * a.H;
  const size_t row = static_cast<size_t>(blockIdx.x) * WARPS +
                     (threadIdx.x >> 5);
  if (row >= nrows) return;                  // warp-uniform
  const int b = static_cast<int>(row / (static_cast<size_t>(a.W) * a.H));
  const int cols = max(0, min(a.kv_len[b] + a.W - 1, a.pps * a.ps));
  const int span = a.pps_split * a.ps;
  const int n = min(a.splits, (cols + span - 1) / span);   // splits that ran
  // lane s holds split s's and s + 32's max, denominator and weight
  float m[2], l[2], w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = lane + 32 * h;
    m[h] = s < n ? a.ml[(s * nrows + row) * 2] : NEG_INF;
    l[h] = s < n ? a.ml[(s * nrows + row) * 2 + 1] : 0.f;
  }
  float M = fmaxf(m[0], m[1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  float L = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    w[h] = lane + 32 * h < n ? expf(m[h] - M) : 0.f;
    L += w[h] * l[h];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
  const float inv = 1.f / fmaxf(L, 1e-30f);
  T* out = static_cast<T*>(a.out) + row * a.dh;
  if ((a.dh & 3) == 0) {                     // a float4 of dims per lane
    for (int d0 = 0; d0 < a.dh; d0 += 128) {
      const int d = d0 + 4 * lane;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int s = 0; s < n; ++s) {
        const float ws =
            __shfl_sync(0xffffffffu, s < 32 ? w[0] : w[1], s & 31);
        if (d < a.dh) {
          const float4 x = *reinterpret_cast<const float4*>(
              a.pacc + (s * nrows + row) * a.dh + d);
          acc.x += ws * x.x;
          acc.y += ws * x.y;
          acc.z += ws * x.z;
          acc.w += ws * x.w;
        }
      }
      if (d < a.dh) {
        out[d] = from_f<T>(acc.x * inv);
        out[d + 1] = from_f<T>(acc.y * inv);
        out[d + 2] = from_f<T>(acc.z * inv);
        out[d + 3] = from_f<T>(acc.w * inv);
      }
    }
    return;
  }
  for (int d0 = 0; d0 < a.dh; d0 += 32) {
    const int d = d0 + lane;
    float acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < n; ++s) {
      const float ws = __shfl_sync(0xffffffffu, s < 32 ? w[0] : w[1], s & 31);
      if (d < a.dh) acc += ws * a.pacc[(s * nrows + row) * a.dh + d];
    }
    if (d < a.dh) out[d] = from_f<T>(acc * inv);
  }
}

// Launch the split kernel (and the combine when the pages are split), or,
// with `occupancy`, only report how many blocks of it an SM holds.
template <typename T, typename Kern>
int run(Kern kern, int smem, const Args& a, cudaStream_t s, bool& configured,
        int* occupancy) {
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  if (occupancy)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occupancy, kern, THREADS, smem));
  kern<<<dim3(a.splits, a.K * a.groups, a.B), THREADS, smem, s>>>(a);
  if (a.splits > 1) {
    const size_t rows = static_cast<size_t>(a.B) * a.W * a.H;
    combine_splits<T><<<static_cast<unsigned>((rows + WARPS - 1) / WARPS),
                        THREADS, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int HC, int CHUNK, int KSPLIT, int MINB>
int run_bf16(const Args& a, cudaStream_t s, int* occupancy) {
  static bool configured = false;
  const Layout<__nv_bfloat16, CHUNK> L(a.dh, a.rows);
  if ((a.rows + 15) / 16 * KSPLIT > WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  return run<__nv_bfloat16>(paged_attn_bf16<HC, CHUNK, KSPLIT, MINB>,
                            static_cast<int>(L.total), a, s, configured,
                            occupancy);
}

// the key slices per M tile: all four warps on one tile, two on each of
// two, one each for three or four (a slice holds at least 16 keys)
template <int HC, int CHUNK>
int run_bf16_split(const Args& a, cudaStream_t s, int* occupancy) {
  const int mt = (a.rows + 15) / 16;
  if constexpr (CHUNK >= 64) {
    if (mt == 1) return run_bf16<HC, CHUNK, 4, 3>(a, s, occupancy);
  }
  if (mt <= 2) return run_bf16<HC, CHUNK, 2, 2>(a, s, occupancy);
  return run_bf16<HC, CHUNK, 1, 2>(a, s, occupancy);
}

template <int HC, int CHUNK, int MAXR>
int run_f32(const Args& a, cudaStream_t s, int* occupancy) {
  static bool configured = false;
  const Layout<float, CHUNK> L(a.dh, a.rows);
  if (a.rows > MAXR) return static_cast<int>(cudaErrorInvalidValue);
  return run<float>(paged_attn_f32<HC, CHUNK, MAXR>,
                    static_cast<int>(L.total), a, s, configured, occupancy);
}


int dispatch(const Args& a, bool is_bf16, cudaStream_t s, int* occupancy) {
  if (is_bf16) {
    if (a.dh <= 64) return run_bf16_split<64, 64>(a, s, occupancy);
    if (a.dh <= 128) return run_bf16_split<128, 64>(a, s, occupancy);
    return run_bf16_split<256, 32>(a, s, occupancy);
  }
  if (a.dh <= 64) return run_f32<64, 64, 32>(a, s, occupancy);
  if (a.dh <= 128) return run_f32<128, 32, 32>(a, s, occupancy);
  return run_f32<256, 16, 32>(a, s, occupancy);
}

// dims: B, W, H, K, dh, ps, pps, splits, pages_per_split, rows (query rows
// per group), groups, is_bf16 — splits..groups from
// kernels/paged_attention.py::split_plan. 1 <= dh <= 256, H % K == 0.
bool make_args(Args& a, const int* dims) {
  const int B = dims[0], W = dims[1], H = dims[2], K = dims[3], dh = dims[4],
            ps = dims[5], pps = dims[6], splits = dims[7],
            pages_per_split = dims[8], rows = dims[9], groups = dims[10];
  if (B < 1 || W < 1 || K < 1 || H % K != 0 || ps < 1 || pps < 1 ||
      dh < 1 || dh > 256 || splits < 1 || splits > 64 ||
      pages_per_split < 1 || rows < 1 || groups < 1 ||
      groups * rows < (H / K) * W || B > 65535 || K * groups > 65535)
    return false;
  a.B = B; a.W = W; a.H = H; a.K = K; a.dh = dh; a.ps = ps; a.pps = pps;
  a.splits = splits; a.pps_split = pages_per_split; a.rows = rows;
  a.groups = groups;
  a.scale = 1.0f / sqrtf(static_cast<float>(dh));
  return true;
}

}  // namespace

// q (B, W, H, dh), k/v pages (P, ps, K, dh), out (B, W, H, dh): all f32
// (dims[11] = 0) or all bf16 (dims[11] = 1); block_table (B, pps) and
// kv_len (B,) int32; work: f32, 16-byte aligned, when splits > 1
// round_up(splits·B·W·H·2, 4) + splits·B·W·H·dh floats
// (kernels/paged_attention.py::work_numel). Returns the CUDA error code
// of the launches (0 = success).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_table,
                                      const void* kv_len, void* out,
                                      void* work, const int* dims,
                                      void* stream) {
  Args a;
  if (!make_args(a, dims) || (a.splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.q = q;
  a.kp = k_pages;
  a.vp = v_pages;
  a.bt = static_cast<const int*>(block_table);
  a.kv_len = static_cast<const int*>(kv_len);
  a.out = out;
  const size_t nrows = static_cast<size_t>(a.B) * a.W * a.H;
  a.ml = static_cast<float*>(work);
  const size_t ml_floats = (static_cast<size_t>(a.splits) * nrows * 2 + 3) /
                           4 * 4;
  a.pacc = work ? a.ml + ml_floats : nullptr;
  const int elt = dims[11] ? 2 : 4;
  a.vec = (a.dh * elt) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  a.qvec = (a.dh * elt) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  return dispatch(a, dims[11] != 0, static_cast<cudaStream_t>(stream),
                  nullptr);
}

// Blocks of the split kernel for `dims` that one SM holds (registers and
// shared memory), written to *blocks. Returns the CUDA error code.
extern "C" int paged_attention_occupancy(const int* dims, int* blocks) {
  Args a;
  if (!make_args(a, dims)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(a, dims[11] != 0, nullptr, blocks);
}
