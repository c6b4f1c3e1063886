// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention_fwd
// (kernel body _flash_kernel, pallas_call at line 98): same function, with q_offset
// added and the log-sum-exp written out for a later backward.
//
//   q [B,Tq,KV,G,hd], k/v [B,Tk,KV,hd] (fp32 or bf16) -> o like q, lse [B,KV,G,Tq] fp32
//   query i (absolute position q_offset+i) sees key j iff j <= q_offset+i, j < Tk and,
//   with a window, q_offset+i-j < window.
//
// What bounds it on an H100: at prefill shapes (T in the thousands, hd 128) every
// (query, visible key) pair costs 4*hd flops against q/k/v rows that are each read
// once, hundreds of flops per byte, so attention is bound by arithmetic (the 989
// TFLOP/s bf16 tensor-core rate), not by device memory.  Two kernels, chosen by dtype:
//
// bf16 (the serving and training path): flash_fwd_sm90, on the tensor cores.
//   * one block per (b, kv head, g, 128-query tile), heaviest (latest) tiles first:
//     two consumer warpgroups of 64 query rows each and one producer warp;
//   * the producer loads the q tile once by TMA and streams 128-key k/v tiles through
//     a ring of STAGES shared-memory slots (TMA, full/empty mbarriers).  The tensor
//     maps see q as (hd, KV*G, Tq, B) and k/v as (hd, KV, Tk, B), so rows past Tq/Tk
//     are zero-filled by TMA, never read from the next batch; GQA is the head
//     coordinate, no G-fold copy;
//   * S = Q K^T by wgmma from 128-byte-swizzled shared memory (64-byte at hd 32);
//     mask (on the tiles that straddle the diagonal, the window or Tk only) and
//     online softmax in base 2 in registers, a row's statistics over the 4 threads
//     that hold it.  The softmax scale is applied in fp32 after the product, inside
//     the exponent (one FFMA and one ex2 an element); the row maxima are taken on
//     the raw products, and o is rescaled only when some row's maximum moved.  The
//     softmax's instructions, not the products, set this kernel's pace: each one cut
//     from it showed in its time (PERF.md);
//   * P rounded to bf16 (where the reference rounds it) and fed from registers as
//     the A operand of O += P V, V read from shared memory as a transposed B: P never
//     goes to shared memory;
//   * hd 112 is computed at 128: its second 64-column box is zero-filled past column
//     112 by TMA (14% more products on zamba2-7b's shared block);
//   * hd 224 (Zamba2-7B's shared block) is computed at 224, in seven 32-column panels
//     swizzled by 64 bytes, with tiles of 64 keys: q and two stages of k and v then
//     take 169 KB of shared memory, and O (N = 224) 112 accumulator registers a thread;
//   * tiles wholly above the diagonal or before the window are never loaded;
//   * the softmax scale is the caller's, or 1/sqrt(hd) where it passes none.
//
// fp32 (consistency checks only): flash_fwd_kernel, SIMT on the CUDA cores, kept
// because TF32 tensor cores would not meet the fp32 checks' tolerances.  Its ceiling
// is the 67 TFLOP/s fp32 rate:
//   * one block per (64-query tile, batch*kv-head*group); blocks share no state and
//     the kv loop runs inside the block, heaviest (latest) query tiles launched first;
//   * each 64-row k/v tile is staged once in shared memory as fp32 and reused by the
//     block's 64 queries; each thread keeps a 4x8 tile of logits and a 4 x hd/8 slice
//     of the output accumulator in registers (register tiling over the smem tiles);
//   * row strides are padded so every shared-memory walk is free of bank conflicts;
//   * kv tiles wholly above the diagonal or wholly before the window are never
//     loaded, and the ragged edges (Tq, Tk not multiples of 64) are masked here
//     instead of being padded in device memory;
//   * k/v are addressed by the query's kv head through strides: no G-fold
//     broadcast copy and no transposes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "flash_sm90.cuh"

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int NTHREADS = 128;
constexpr int ROWS = 4;       // a thread's query rows: r, r+16, r+32, r+48
constexpr int COLS = 8;       // a thread's key columns: c, c+8, ..., c+56
constexpr int PLD = BK + 8;   // row stride of the probability tile (conflict-free)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, Tq, Tk, KV, G, q_offset, window;
  float scale_log2;                    // log2(e) * the softmax scale (1/sqrt(hd) by default)
  long long q_sb, q_st, q_sh, q_sg;    // element strides of q (and o)
  long long k_sb, k_st, k_sh;          // element strides of k
  long long v_sb, v_st, v_sh;          // element strides of v
};

// the SIMT kernel is instantiated for fp32 only (bf16 runs flash_fwd_sm90)
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ float row_max(float x) {   // over the 8 lanes of a row group
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int HD>
constexpr int kp_floats() {   // the k tile and the probability tile share one region
  return BK * (HD + 1) > BQ * PLD ? BK * (HD + 1) : BQ * PLD;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (HD + 1) + BK * (HD + 1) + kp_floats<HD>());
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(const Params p) {
  constexpr int LD = HD + 1;        // padded row stride: column walks hit distinct banks
  constexpr int DC = HD / COLS;     // output columns per thread: c, c+8, ...
  extern __shared__ float smem[];
  float* q_s = smem;                // [BQ][LD], pre-scaled by scale_log2
  float* v_s = q_s + BQ * LD;       // [BK][LD]
  float* k_s = v_s + BK * LD;       // [BK][LD], until the logits are computed
  float* p_s = k_s;                 // [BQ][PLD], the tile's probabilities after that

  const int tid = threadIdx.x;
  const int r = tid >> 3;           // row group 0..15 (8 lanes of one warp)
  const int c = tid & 7;            // column group 0..7
  const int bhg = blockIdx.x;       // (b*KV + kvh)*G + g
  const int g = bhg % p.G;
  const int kvh = (bhg / p.G) % p.KV;
  const int b = bhg / (p.G * p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + kvh * p.q_sh + g * p.q_sg;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.q_sb + kvh * p.q_sh + g * p.q_sg;

  for (int idx = tid; idx < BQ * HD; idx += NTHREADS) {
    const int row = idx / HD, d = idx % HD, t = q0 + row;
    q_s[row * LD + d] = t < p.Tq ? to_f(qg[t * p.q_st + d]) * p.scale_log2 : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.f;
  }

  // keys that some real row of this tile can see
  const int pos_lo = p.q_offset + q0;
  const int pos_hi = p.q_offset + min(q0 + BQ, p.Tq) - 1;
  const int k_lo = p.window ? max(0, pos_lo - p.window + 1) : 0;
  const int k_hi = min(p.Tk, pos_hi + 1);

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();                // last tile's k_s/v_s/p_s reads are done
    for (int idx = tid; idx < BK * HD; idx += NTHREADS) {
      const int row = idx / HD, d = idx % HD, t = k0 + row;
      const bool in = t < p.Tk;
      k_s[row * LD + d] = in ? to_f(kg[t * p.k_st + d]) : 0.f;
      v_s[row * LD + d] = in ? to_f(vg[t * p.v_st + d]) : 0.f;
    }
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = q_s[(r + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = k_s[(c + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    __syncthreads();                // k_s is free: p_s takes its place

    // mask, then the online-softmax update in base 2 (logits carry log2(e))
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = r + 16 * i;
      const int pos = p.q_offset + q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int kp = k0 + c + 8 * j;
        const bool ok = kp < p.Tk && kp <= pos && (p.window == 0 || pos - kp < p.window);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // row has seen no key yet
      const float corr = exp2f(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float pij = exp2f(s[i][j] - m_use);
        sum += pij;
        p_s[row * PLD + c + 8 * j] = pij;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();                // p_s complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = p_s[(r + 16 * i) * PLD + kk];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const float vv = v_s[kk * LD + c + 8 * jj];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int t = q0 + r + 16 * i;
    if (t >= p.Tq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lc;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) og[t * p.q_st + c + 8 * jj] = from_f<T>(acc[i][jj] * inv);
    if (c == 0) p.lse[(long long)bhg * p.Tq + t] = m[i] * LN2 + logf(lc);
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.KV * p.G, (p.Tq + BQ - 1) / BQ);
  flash_fwd_kernel<T, HD><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16: wgmma + TMA

template <int HD>
struct Sm90 {
  static constexpr int HDP = HD == 112 ? 128 : HD;   // computed head width
  static constexpr int PANEL = HDP % 64 ? 32 : 64;   // columns per TMA box and swizzled row
  static constexpr int NPANEL = HDP / PANEL;
  static constexpr int ROWB = PANEL * 2;             // bytes of a swizzled row: 128 or 64
  static constexpr int KPP = PANEL / 16;             // k16 steps per panel
  static constexpr int BQ = 128;                     // two consumer warpgroups x 64 rows
  static constexpr int BK = HDP > 128 ? 64 : 128;    // keys per k/v tile
  static constexpr int STAGES = HDP > 64 ? 2 : 3;    // the ring: 128 or 96 KB at most, 112 at hd 224
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int KV_BYTES = BK * HDP * 2;      // one k (or v) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int NTHREADS = 2 * 128 + 32;      // 2 consumer warpgroups + 1 producer warp
  static constexpr size_t SMEM = 1024 + Q_BYTES + (size_t)STAGES * STAGE_BYTES;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {   // over the 4 lanes holding a row
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x on the special-function unit, one instruction (relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__global__ void __launch_bounds__(Sm90<HD>::NTHREADS, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using C = Sm90<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, HDP = C::HDP, STAGES = C::STAGES, ROWB = C::ROWB;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[STAGES], empty[STAGES];
  // the swizzle atoms need 1024-byte alignment of the shared-memory address
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;                                   // NPANEL panels of [BQ][PANEL]
  uint8_t* kv_s = smem + C::Q_BYTES;                     // STAGES x (k, v), each NPANEL x [BK][PANEL]

  const int bhg = blockIdx.x;       // (b*KV + kvh)*G + g
  const int g = bhg % p.G;
  const int kvh = (bhg / p.G) % p.KV;
  const int b = bhg / (p.G * p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  // key tiles that some real row of this block can see
  const int pos_lo = p.q_offset + q0;
  const int pos_hi = p.q_offset + min(q0 + BQ, p.Tq) - 1;
  const int k_lo = p.window ? max(0, pos_lo - p.window + 1) : 0;
  const int k_hi = min(p.Tk, pos_hi + 1);
  const int first = k_lo / BK;
  const int n_tiles = k_hi > k_lo ? (k_hi + BK - 1) / BK - first : 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);    // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {                  // ---- producer: TMA loads
    if (lane != 0) return;
    sm90::mbar_expect_tx(&q_full, C::Q_BYTES);
    for (int pn = 0; pn < C::NPANEL; ++pn)
      sm90::tma_load_4d(q_s + pn * BQ * ROWB, &tm_q, &q_full, pn * C::PANEL, kvh * p.G + g, q0, b);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) sm90::mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
      const int k0 = (first + it) * BK;
      uint8_t* k_dst = kv_s + s * C::STAGE_BYTES;
      sm90::mbar_expect_tx(&full[s], C::STAGE_BYTES);
      for (int pn = 0; pn < C::NPANEL; ++pn) {
        sm90::tma_load_4d(k_dst + pn * BK * ROWB, &tm_k, &full[s], pn * C::PANEL, kvh, k0, b);
        sm90::tma_load_4d(k_dst + C::KV_BYTES + pn * BK * ROWB, &tm_v, &full[s], pn * C::PANEL,
                          kvh, k0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns query rows [q0 + 64 w, q0 + 64 w + 64)
  const int w = warp >> 2;
  const int r_lo = 16 * (warp & 3) + (lane >> 2);   // this thread's rows: r_lo, r_lo + 8
  const int col = 2 * (lane & 3);                   // and columns col, col+1 of each 8-block
  const int qw = q0 + 64 * w;
  const int pos0 = p.q_offset + qw + r_lo, pos1 = pos0 + 8;
  const bool rows = qw < p.Tq;
  const int w_pos_lo = p.q_offset + qw;
  const int w_pos_hi = p.q_offset + min(qw + 64, p.Tq) - 1;

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // descriptors of this warpgroup's q rows and of the stage-0 k and v tiles; another
  // tile's are these plus its byte offset / 16
  const uint32_t kv_addr = sm90::smem_addr(kv_s);
  const uint64_t dq0 = sm90::make_desc(sm90::smem_addr(q_s) + 64 * w * ROWB, 16, 8 * ROWB, ROWB);
  const uint64_t dk0 = sm90::make_desc(kv_addr, 16, 8 * ROWB, ROWB);
  const uint64_t dv0 = sm90::make_desc(kv_addr + C::KV_BYTES, BK * ROWB, 8 * ROWB, ROWB);
  sm90::mbar_wait(&q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int k0 = (first + it) * BK;
    sm90::mbar_wait(&full[s], (it / STAGES) & 1);
    const bool seen = rows && k0 <= w_pos_hi &&
                      (p.window == 0 || k0 + BK - 1 > w_pos_lo - p.window);
    if (seen) {
      const uint32_t stage = s * (C::STAGE_BYTES >> 4);
      float sc[BK / 2];             // S = Q K^T (the first product overwrites it)
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const int pn = kk / C::KPP, off = 32 * (kk % C::KPP);
        sm90::Wgmma<BK>::ss(sc, dq0 + ((pn * BQ * ROWB + off) >> 4),
                            dk0 + stage + ((pn * BK * ROWB + off) >> 4), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(sc);

      // mask where the tile straddles the diagonal, window or Tk; the row maxima are
      // taken on the raw products (the scale is positive) and the scale is applied
      // in fp32 inside the exponent: p = 2^(s * log2(e) / sqrt(hd) - m)
      const bool mask = !(k0 + BK - 1 <= w_pos_lo && k0 + BK <= p.Tk &&
                          (p.window == 0 || w_pos_hi - k0 < p.window));
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (mask) {
            const int key = k0 + 8 * j + col + (e & 1);
            const int pos = e < 2 ? pos0 : pos1;
            if (!(key < p.Tk && key <= pos && (p.window == 0 || pos - key < p.window)))
              sc[4 * j + e] = -INFINITY;
          }
          if (e < 2) mx0 = fmaxf(mx0, sc[4 * j + e]); else mx1 = fmaxf(mx1, sc[4 * j + e]);
        }
      }
      const float sl2 = p.scale_log2;
      const float mn0 = fmaxf(m0, quad_max(mx0) * sl2), mn1 = fmaxf(m1, quad_max(mx1) * sl2);
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;   // a row that has seen no key yet
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float c0 = ex2(m0 - mu0), c1 = ex2(m1 - mu1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        sc[4 * j + 0] = ex2(fmaf(sc[4 * j + 0], sl2, -mu0));
        sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], sl2, -mu0));
        sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], sl2, -mu1));
        sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], sl2, -mu1));
        sum0 += sc[4 * j + 0] + sc[4 * j + 1];
        sum1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * c0 + quad_sum(sum0);
      l1 = l1 * c1 + quad_sum(sum1);
      m0 = mn0;
      m1 = mn1;
      if (__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {   // a row maximum moved
#pragma unroll
        for (int j = 0; j < HDP / 8; ++j) {
          o[4 * j + 0] *= c0;
          o[4 * j + 1] *= c0;
          o[4 * j + 2] *= c1;
          o[4 * j + 3] *= c1;
        }
      }

      // O += P V: P in bf16 from registers (the accumulator layout of S is the A layout)
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        sm90::Wgmma<HDP>::rs(o, pa[kk], dv0 + stage + ((kk * 16 * ROWB) >> 4), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(o);
    }
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }
  if (!rows) return;

  // epilogue: o / l in bf16, staged in this warpgroup's own q rows (same panels, a
  // 16-byte-chunk XOR swizzle), then written out 16 bytes a thread
  constexpr int CPR = ROWB / 16;    // 16-byte chunks per panel row
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");   // the q reads are done
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int pn = j / CPR, cc = j % CPR;
    uint8_t* panel = q_s + pn * BQ * ROWB + 64 * w * ROWB;
    const int r1 = r_lo + 8;
    *reinterpret_cast<uint32_t*>(panel + r_lo * ROWB + ((cc ^ (r_lo & (CPR - 1))) << 4) +
                                 2 * col) = pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
    *reinterpret_cast<uint32_t*>(panel + r1 * ROWB + ((cc ^ (r1 & (CPR - 1))) << 4) + 2 * col) =
        pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.q_sb + kvh * p.q_sh + g * p.q_sg;
  constexpr int NCH = HDP / 8;
  for (int idx = threadIdx.x & 127; idx < 64 * NCH; idx += 128) {
    const int r = idx / NCH, c = idx % NCH, t = qw + r;
    if (t >= p.Tq || c * 8 >= HD) continue;
    const int pn = c / CPR, cc = c % CPR;
    const uint8_t* src = q_s + pn * BQ * ROWB + (64 * w + r) * ROWB + ((cc ^ (r & (CPR - 1))) << 4);
    *reinterpret_cast<uint4*>(og + (long long)t * p.q_st + c * 8) =
        *reinterpret_cast<const uint4*>(src);
  }
  if ((lane & 3) == 0) {
    if (qw + r_lo < p.Tq)
      p.lse[(long long)bhg * p.Tq + qw + r_lo] = m0 * LN2 + logf(fmaxf(l0, 1e-30f));
    if (qw + r_lo + 8 < p.Tq)
      p.lse[(long long)bhg * p.Tq + qw + r_lo + 8] = m1 * LN2 + logf(fmaxf(l1, 1e-30f));
  }
}

template <int HD>
cudaError_t launch_sm90(const Params& p, cudaStream_t stream) {
  using C = Sm90<HD>;
  // the tensor maps merge (KV, G) into one head axis and need 16-byte-aligned rows
  if (p.q_sh != (long long)p.G * p.q_sg) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!sm90::make_map(&tq, p.q, HD, (long long)p.KV * p.G, p.Tq, p.B, p.q_sg, p.q_st, p.q_sb,
                      C::PANEL, C::BQ) ||
      !sm90::make_map(&tk, p.k, HD, p.KV, p.Tk, p.B, p.k_sh, p.k_st, p.k_sb, C::PANEL, C::BK) ||
      !sm90::make_map(&tv, p.v, HD, p.KV, p.Tk, p.B, p.v_sh, p.v_st, p.v_sb, C::PANEL, C::BK))
    return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.KV * p.G, (p.Tq + C::BQ - 1) / C::BQ);
  flash_fwd_sm90<HD><<<grid, C::NTHREADS, C::SMEM, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_sm90<32>(p, stream);
    case 64: return launch_sm90<64>(p, stream);
    case 112: return launch_sm90<112>(p, stream);   // zamba2-7b's shared attention block
    case 128: return launch_sm90<128>(p, stream);
    case 224: return launch_sm90<224>(p, stream);   // Zamba2-7B's shared attention block
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_fp32(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<float, 32>(p, stream);
    case 64: return launch<float, 64>(p, stream);
    case 112: return launch<float, 112>(p, stream);
    case 128: return launch<float, 128>(p, stream);
    case 224: return launch<float, 224>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the kernel was launched.  is_bf16 selects the
// element type of q/k/v/o and the kernel (0: fp32, SIMT; 1: bf16, wgmma + TMA;
// cudaErrorNotSupported if a tensor map cannot be encoded); strides are in elements;
// scale is the softmax scale, 1/sqrt(hd) where it is 0.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                        int is_bf16, int B, int Tq, int Tk, int KV, int G, int hd,
                        int q_offset, int window, float scale,
                        long long q_sb, long long q_st, long long q_sh, long long q_sg,
                        long long k_sb, long long k_st, long long k_sh,
                        long long v_sb, long long v_st, long long v_sh, void* stream) {
  Params p{q, k, v, o, lse, B, Tq, Tk, KV, G, q_offset, window,
           scale > 0.f ? LOG2E * scale : LOG2E / sqrtf((float)hd),
           q_sb, q_st, q_sh, q_sg, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_bf16(p, hd, s) : dispatch_fp32(p, hd, s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
