// Causal GQA flash-attention forward for Hopper (sm_90a), fp32 online softmax.
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
// once, hundreds of flops per byte, so attention is bound by arithmetic, not by
// device memory.  This first kernel does that arithmetic in fp32 on the CUDA cores,
// so its ceiling is the 67 TFLOP/s fp32 rate, well under the 989 TFLOP/s bf16
// tensor-core rate its bound is stated against; wgmma, TMA and pipelining are later
// work.  What the design does about it:
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
  float scale_log2;                    // log2(e) / sqrt(hd)
  long long q_sb, q_st, q_sh, q_sg;    // element strides of q (and o)
  long long k_sb, k_st, k_sh;          // element strides of k
  long long v_sb, v_st, v_sh;          // element strides of v
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T>
cudaError_t dispatch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 112: return launch<T, 112>(p, stream);   // zamba2-7b's shared attention block
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the kernel was launched.  is_bf16 selects the
// element type of q/k/v/o (0: fp32, 1: bf16); strides are in elements.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                        int is_bf16, int B, int Tq, int Tk, int KV, int G, int hd,
                        int q_offset, int window,
                        long long q_sb, long long q_st, long long q_sh, long long q_sg,
                        long long k_sb, long long k_st, long long k_sh,
                        long long v_sb, long long v_st, long long v_sh, void* stream) {
  Params p{q, k, v, o, lse, B, Tq, Tk, KV, G, q_offset, window,
           LOG2E / sqrtf((float)hd),
           q_sb, q_st, q_sh, q_sg, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_hd<__nv_bfloat16>(p, hd, s) : dispatch_hd<float>(p, hd, s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
