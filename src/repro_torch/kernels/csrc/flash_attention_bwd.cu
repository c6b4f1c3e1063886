// Causal GQA flash-attention backward for Hopper (sm_90a), SIMT fp32.
//
// Replaces the reference's flash backward, which has no Pallas kernel: the JAX
// package differentiates through the custom VJP src/repro/kernels/ref.py::
// _flash_bwd_impl (ref.py:105-208, wired at :211-228).  Same function: dq, dk, dv
// recomputed from (q, k, v, lse) and do, never from a saved probability matrix.
//
//   q, o, do [B,Tq,KV,G,hd], k/v [B,Tk,KV,hd] (fp32 or bf16), lse [B,KV,G,Tq] fp32
//   (natural log, as flash_attention.cu writes it) -> dq like q, dk/dv like k/v.
//   The mask is the forward's: query i (position q_offset+i) sees key j iff
//   j <= q_offset+i, j < Tk and, with a window, q_offset+i-j < window.
//
// Three launches, no atomics, so two runs give identical gradients:
//   1. delta_kernel: D = rowsum(do * o) in fp32, [B,KV,G,Tq].  The reference
//      recomputes o from p; o is what the forward returned, so this is the same D
//      up to o's rounding to its dtype.
//   2. dkdv_kernel: one block per (b, kv head, 64-key tile).  k/v stay in shared
//      memory; the block walks the G query heads of its group and, for each, the
//      64-query tiles that can see its keys, recomputes p = exp(s - lse) and
//      ds = p * (do.v - D) * scale, and accumulates dv += p^T do, dk += ds^T q in
//      registers.
//   3. dq_kernel: one block per (b, kv head, g, 64-query tile), walking the
//      key tiles its queries see (as the forward does), dq += ds k.
// p and ds are rounded to the inputs' dtype before the products that read them,
// where the reference rounds them (ref.py:158-168).
//
// What bounds it on an H100: 5 products of 2*hd flops per visible (query, key)
// pair (q.k and do.v to recompute, then dv, dk, dq) against q/k/v/o/do read once:
// hundreds of flops per byte at training shapes, so arithmetic bounds it.  This
// kernel recomputes q.k and do.v in both passes (7 products a pair) and does them
// in fp32 on the CUDA cores, 67 TFLOP/s at most against the 989 TFLOP/s bf16
// tensor-core rate its bound is stated against.  Tensor cores and a fused
// single pass are later work.  What the design keeps from the forward: register
// tiles of 4 rows x 8 columns per thread over padded (bank-conflict-free) fp32
// shared-memory tiles, masked tiles never visited, ragged edges masked in the
// kernel, and k/v addressed by kv head through strides (no G-fold copy).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 64;        // queries per tile
constexpr int BK = 64;        // keys per tile
constexpr int NTHREADS = 128;
constexpr int ROWS = 4;       // a thread's tile rows: r, r+16, r+32, r+48
constexpr int COLS = 8;       // a thread's tile columns: c, c+8, ..., c+56
constexpr int PLD = 64 + 8;   // row stride of the p / ds tiles (conflict-free)
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                    // [B,KV,G,Tq], natural log
  float* delta;                        // [B,KV,G,Tq], rowsum(do * o)
  void* dq;
  void* dk;
  void* dv;
  int B, Tq, Tk, KV, G, q_offset, window;
  float scale;                         // 1 / sqrt(hd)
  long long q_sb, q_st, q_sh, q_sg;    // element strides of q, o, do and dq
  long long k_sb, k_st, k_sh;          // element strides of k, v, dk and dv
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back: where the reference casts p and ds to the inputs' dtype
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ bool visible(const Params& p, int t, int key) {
  const int pos = p.q_offset + t;
  return t < p.Tq && key < p.Tk && key <= pos && (p.window == 0 || pos - key < p.window);
}

// ---------------------------------------------------------------- 1. D = rowsum(do*o)

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) delta_kernel(const Params p) {
  const long long row = (long long)blockIdx.x * (NTHREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)p.B * p.Tq * p.KV * p.G;
  if (row >= rows) return;
  const int g = row % p.G;
  const int kvh = (row / p.G) % p.KV;
  const int t = (row / ((long long)p.G * p.KV)) % p.Tq;
  const int b = row / ((long long)p.G * p.KV * p.Tq);
  const long long off = b * p.q_sb + t * p.q_st + kvh * p.q_sh + g * p.q_sg;
  const T* o = static_cast<const T*>(p.o) + off;
  const T* dout = static_cast<const T*>(p.dout) + off;
  float sum = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32) sum = fmaf(to_f(dout[d]), to_f(o[d]), sum);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) p.delta[((long long)(b * p.KV + kvh) * p.G + g) * p.Tq + t] = sum;
}

// ---------------------------------------------------------------- shared helpers

// rows [0, 64) of a [*, HD] slab starting at row t0 into a padded fp32 tile
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int t0, int n_rows) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < 64 * HD; idx += NTHREADS) {
    const int row = idx / HD, d = idx % HD, t = t0 + row;
    dst[row * LD + d] = t < n_rows ? to_f(src[t * row_stride + d]) : 0.f;
  }
}

// s[i][j] = a_row(r+16i) . b_row(c+8j) and e[i][j] = x_row(r+16i) . y_row(c+8j)
template <int HD>
__device__ __forceinline__ void two_products(const float* a, const float* bt, const float* x,
                                             const float* y, int r, int c,
                                             float (&s)[ROWS][COLS], float (&e)[ROWS][COLS]) {
  constexpr int LD = HD + 1;
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < COLS; ++j) s[i][j] = e[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; ++d) {
    float av[ROWS], xv[ROWS], bv[COLS], yv[COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      av[i] = a[(r + 16 * i) * LD + d];
      xv[i] = x[(r + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      bv[j] = bt[(c + 8 * j) * LD + d];
      yv[j] = y[(c + 8 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        e[i][j] = fmaf(xv[i], yv[j], e[i][j]);
      }
  }
}

// ---------------------------------------------------------------- 2. dk, dv

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * 64 * (HD + 1) + 2 * 64 * PLD + 2 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) dkdv_kernel(const Params p) {
  constexpr int LD = HD + 1;
  constexpr int DC = HD / COLS;
  extern __shared__ float smem[];
  float* k_s = smem;                // [BK][LD]
  float* v_s = k_s + BK * LD;       // [BK][LD]
  float* q_s = v_s + BK * LD;       // [BQ][LD]
  float* do_s = q_s + BQ * LD;      // [BQ][LD]
  float* p_s = do_s + BQ * LD;      // [BK][PLD], p^T rounded to T
  float* ds_s = p_s + BK * PLD;     // [BK][PLD], ds^T rounded to T
  float* lse_s = ds_s + BK * PLD;   // [BQ], log2 units
  float* dl_s = lse_s + BQ;         // [BQ]

  const int tid = threadIdx.x;
  const int r = tid >> 3;           // key rows r + 16 i
  const int c = tid & 7;            // query columns c + 8 j
  const int bkv = blockIdx.x;       // b * KV + kvh
  const int kvh = bkv % p.KV;
  const int b = bkv / p.KV;
  const int k0 = blockIdx.y * BK;
  const float scale_log2 = p.scale * LOG2E;

  const long long k_off = b * p.k_sb + kvh * p.k_sh;
  load_tile<T, HD>(k_s, static_cast<const T*>(p.k) + k_off + (long long)k0 * p.k_st, p.k_st,
                   0, p.Tk - k0);
  load_tile<T, HD>(v_s, static_cast<const T*>(p.v) + k_off + (long long)k0 * p.k_st, p.k_st,
                   0, p.Tk - k0);

  float dk[ROWS][DC], dv[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  // queries that can see some key of this tile
  const int k_last = min(k0 + BK, p.Tk) - 1;
  const int t_lo = max(0, k0 - p.q_offset);
  const int t_hi = p.window ? min(p.Tq, k_last + p.window - p.q_offset) : p.Tq;

  for (int g = 0; g < p.G; ++g) {
    const long long q_off = b * p.q_sb + kvh * p.q_sh + g * p.q_sg;
    const T* qg = static_cast<const T*>(p.q) + q_off;
    const T* dog = static_cast<const T*>(p.dout) + q_off;
    const long long stat = ((long long)bkv * p.G + g) * p.Tq;
    for (int q0 = (t_lo / BQ) * BQ; q0 < t_hi; q0 += BQ) {
      __syncthreads();              // the last tile's q_s/do_s/p_s/ds_s reads are done
      load_tile<T, HD>(q_s, qg, p.q_st, q0, p.Tq);
      load_tile<T, HD>(do_s, dog, p.q_st, q0, p.Tq);
      for (int row = tid; row < BQ; row += NTHREADS) {
        const int t = q0 + row;
        lse_s[row] = t < p.Tq ? p.lse[stat + t] * LOG2E : 0.f;
        dl_s[row] = t < p.Tq ? p.delta[stat + t] : 0.f;
      }
      __syncthreads();

      float s[ROWS][COLS], dp[ROWS][COLS];   // [key][query]
      two_products<HD>(k_s, q_s, v_s, do_s, r, c, s, dp);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int kr = r + 16 * i;
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          const int qc = c + 8 * j;
          const float pij = visible(p, q0 + qc, k0 + kr)
                                ? exp2f(s[i][j] * scale_log2 - lse_s[qc]) : 0.f;
          p_s[kr * PLD + qc] = rnd<T>(pij);
          ds_s[kr * PLD + qc] = rnd<T>(pij * (dp[i][j] - dl_s[qc]) * p.scale);
        }
      }
      __syncthreads();              // p_s / ds_s complete

#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[ROWS], dsv[ROWS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          pv[i] = p_s[(r + 16 * i) * PLD + qq];
          dsv[i] = ds_s[(r + 16 * i) * PLD + qq];
        }
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) {
          const float dov = do_s[qq * LD + c + 8 * jj];
          const float qv = q_s[qq * LD + c + 8 * jj];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            dv[i][jj] = fmaf(pv[i], dov, dv[i][jj]);
            dk[i][jj] = fmaf(dsv[i], qv, dk[i][jj]);
          }
        }
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk) + k_off;
  T* dvg = static_cast<T*>(p.dv) + k_off;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int t = k0 + r + 16 * i;
    if (t >= p.Tk) continue;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      dkg[t * p.k_st + c + 8 * jj] = from_f<T>(dk[i][jj]);
      dvg[t * p.k_st + c + 8 * jj] = from_f<T>(dv[i][jj]);
    }
  }
}

// ---------------------------------------------------------------- 3. dq

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * 64 * (HD + 1) + 64 * PLD + 2 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(const Params p) {
  constexpr int LD = HD + 1;
  constexpr int DC = HD / COLS;
  extern __shared__ float smem[];
  float* q_s = smem;                // [BQ][LD]
  float* do_s = q_s + BQ * LD;      // [BQ][LD]
  float* k_s = do_s + BQ * LD;      // [BK][LD]
  float* v_s = k_s + BK * LD;       // [BK][LD]
  float* ds_s = v_s + BK * LD;      // [BQ][PLD], ds rounded to T
  float* lse_s = ds_s + BQ * PLD;   // [BQ], log2 units
  float* dl_s = lse_s + BQ;         // [BQ]

  const int tid = threadIdx.x;
  const int r = tid >> 3;           // query rows r + 16 i
  const int c = tid & 7;            // key columns c + 8 j
  const int bhg = blockIdx.x;       // (b*KV + kvh)*G + g
  const int g = bhg % p.G;
  const int kvh = (bhg / p.G) % p.KV;
  const int b = bhg / (p.G * p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest (latest) tiles first
  const float scale_log2 = p.scale * LOG2E;

  const long long q_off = b * p.q_sb + kvh * p.q_sh + g * p.q_sg;
  const long long k_off = b * p.k_sb + kvh * p.k_sh;
  load_tile<T, HD>(q_s, static_cast<const T*>(p.q) + q_off, p.q_st, q0, p.Tq);
  load_tile<T, HD>(do_s, static_cast<const T*>(p.dout) + q_off, p.q_st, q0, p.Tq);
  for (int row = tid; row < BQ; row += NTHREADS) {
    const int t = q0 + row;
    lse_s[row] = t < p.Tq ? p.lse[(long long)bhg * p.Tq + t] * LOG2E : 0.f;
    dl_s[row] = t < p.Tq ? p.delta[(long long)bhg * p.Tq + t] : 0.f;
  }

  float acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.f;

  // keys that some real query of this tile can see
  const int pos_lo = p.q_offset + q0;
  const int pos_hi = p.q_offset + min(q0 + BQ, p.Tq) - 1;
  const int k_lo = p.window ? max(0, pos_lo - p.window + 1) : 0;
  const int k_hi = min(p.Tk, pos_hi + 1);

  const T* kg = static_cast<const T*>(p.k) + k_off;
  const T* vg = static_cast<const T*>(p.v) + k_off;
  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();                // the last tile's k_s/v_s/ds_s reads are done
    load_tile<T, HD>(k_s, kg, p.k_st, k0, p.Tk);
    load_tile<T, HD>(v_s, vg, p.k_st, k0, p.Tk);
    __syncthreads();

    float s[ROWS][COLS], dp[ROWS][COLS];     // [query][key]
    two_products<HD>(q_s, k_s, do_s, v_s, r, c, s, dp);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qr = r + 16 * i;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int kc = c + 8 * j;
        const float pij = visible(p, q0 + qr, k0 + kc)
                              ? exp2f(s[i][j] * scale_log2 - lse_s[qr]) : 0.f;
        ds_s[qr * PLD + kc] = rnd<T>(pij * (dp[i][j] - dl_s[qr]) * p.scale);
      }
    }
    __syncthreads();                // ds_s complete

#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) dsv[i] = ds_s[(r + 16 * i) * PLD + kk];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const float kv = k_s[kk * LD + c + 8 * jj];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][jj] = fmaf(dsv[i], kv, acc[i][jj]);
      }
    }
  }

  T* dqg = static_cast<T*>(p.dq) + q_off;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int t = q0 + r + 16 * i;
    if (t >= p.Tq) continue;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) dqg[t * p.q_st + c + 8 * jj] = from_f<T>(acc[i][jj]);
  }
}

// ---------------------------------------------------------------- launch

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.Tq * p.KV * p.G;
  const int rows_per_block = NTHREADS / 32;
  delta_kernel<T, HD><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), NTHREADS, 0,
                        stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t kv_smem = dkdv_smem_bytes<HD>();
  err = cudaFuncSetAttribute(dkdv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_smem);
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, HD><<<dim3(p.B * p.KV, (p.Tk + BK - 1) / BK), NTHREADS, kv_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t q_smem = dq_smem_bytes<HD>();
  err = cudaFuncSetAttribute(dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_smem);
  if (err != cudaSuccess) return err;
  dq_kernel<T, HD><<<dim3(p.B * p.KV * p.G, (p.Tq + BQ - 1) / BQ), NTHREADS, q_smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 112: return launch<T, 112>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the three kernels were launched.  is_bf16 selects
// the element type of q/k/v/o/do/dq/dk/dv (0: fp32, 1: bf16); strides are in
// elements, q's for q/o/do/dq and k's for k/v/dk/dv.  delta is fp32 scratch of
// lse's shape.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int is_bf16, int B, int Tq, int Tk, int KV, int G, int hd,
                        int q_offset, int window,
                        long long q_sb, long long q_st, long long q_sh, long long q_sg,
                        long long k_sb, long long k_st, long long k_sh, void* stream) {
  Params p{q, k, v, o, dout, lse, delta, dq, dk, dv, B, Tq, Tk, KV, G, q_offset, window,
           1.f / sqrtf((float)hd), q_sb, q_st, q_sh, q_sg, k_sb, k_st, k_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_hd<__nv_bfloat16>(p, hd, s) : dispatch_hd<float>(p, hd, s);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
