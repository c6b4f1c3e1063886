// Causal GQA flash-attention backward for Hopper (sm_90a).
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
//   2. dkdv: one block per (b, kv head, 64-key tile).  k/v stay in shared memory;
//      the block walks the G query heads of its group and, for each, the query
//      tiles that can see its keys, recomputes p = exp(s - lse) and
//      ds = p * (do.v - D) * scale, and accumulates dv += p^T do, dk += ds^T q in
//      registers.
//   3. dq: one block per (b, kv head, g, 64-query tile), walking the key tiles its
//      queries see (as the forward does), dq += ds k.
// p and ds are rounded to the inputs' dtype before the products that read them,
// where the reference rounds them (ref.py:158-168); scale and lse apply in fp32.
//
// What bounds it on an H100: 5 products of 2*hd flops per visible (query, key)
// pair (q.k and do.v to recompute, then dv, dk, dq) against q/k/v/o/do read once:
// hundreds of flops per byte at training shapes, so arithmetic bounds it (the 989
// TFLOP/s bf16 tensor-core rate).  Both passes recompute q.k and do.v (7 products a
// pair), the price of determinism without atomics.  Two sets of kernels, by dtype:
//
// bf16 (the training path): dkdv_mma and dq_mma, every product on the tensor cores
//   by mma.sync m16n8k16 (fp32 accumulate) with ldmatrix operands.  4 warps of 16
//   rows each; dkdv computes S^T = K Q^T and dP^T = V dO^T with key rows as M, so P^T
//   and dS^T sit in registers in the accumulator layout and, packed to bf16, are the
//   A operands of dV += P^T dO and dK += dS^T Q (dO and Q read by ldmatrix.trans); dq
//   computes S = Q K^T and dP = dO V^T and then dQ += dS K (K by ldmatrix.trans).  The
//   streamed tiles (Q/dO with their lse and D in dkdv, K/V in dq) are double-buffered
//   by cp.async in padded shared-memory rows (hd + 8: conflict-free ldmatrix).
//   p = 2^(s * log2(e) / sqrt(hd) - lse * log2(e)) is one FFMA and one ex2.
//
// fp32 (consistency checks only): dkdv_kernel and dq_kernel, SIMT on the CUDA cores
//   (67 TFLOP/s at most), kept because TF32 would not meet the fp32 checks'
//   tolerances: register tiles of 4 rows x 8 columns per thread over padded
//   (bank-conflict-free) fp32 shared-memory tiles.
// Both keep masked tiles unvisited, ragged edges masked in the kernel, and k/v
// addressed by kv head through strides (no G-fold copy).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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

// ---------------------------------------------------------------- bf16: tensor cores

// mma.sync m16n8k16 (bf16 in, fp32 accumulate) with ldmatrix operands from padded
// shared-memory tiles [rows][HD + 8] (the pad makes every ldmatrix conflict-free).
// Fragments: C/D of an n8 block holds (row lane/4, cols 2(lane%4), +1) in d[0..1] and
// row lane/4 + 8 in d[2..3]; two neighbouring n8 blocks of C are one k16 A operand.

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit, one instruction (relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// rows [t0, t0 + R) of a [*, HD] bf16 slab into a padded tile by cp.async, rows
// at or past n_rows zero-filled; the caller commits the group
template <int HD, int R>
__device__ __forceinline__ void cp_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                        long long row_stride, int t0, int n_rows) {
  constexpr int LD = HD + 8, CH = HD / 8;
  for (int idx = threadIdx.x; idx < R * CH; idx += NTHREADS) {
    const int r = idx / CH, c = idx % CH, t = t0 + r;
    const bool in = t < n_rows;
    const __nv_bfloat16* s = src + (in ? (long long)t * row_stride : 0) + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst + r * LD + c * 8)),
                 "l"(s), "r"(in ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// c[16 x N] = A[16 rows of a] . B[N rows of b]^T over HD: both tiles row-major [rows][HD+8]
template <int HD, int N>
__device__ __forceinline__ void mma_abt(float (&c)[N / 8][4], const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  const uint32_t a_addr = smem_u32(a + (lane & 15) * LD + (lane >> 4) * 8);
  const uint32_t b_addr = smem_u32(b + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a_addr + kk * 32);
#pragma unroll
    for (int nb = 0; nb < N / 16; ++nb) {
      uint32_t bf[4];
      ldsm_x4(bf, b_addr + (nb * 16 * LD + kk * 16) * 2);
      mma16816(c[2 * nb], af, bf[0], bf[1]);
      mma16816(c[2 * nb + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[16 x HD] += P[16 x K] . B[K rows of b], P in registers as K/16 A operands,
// b row-major [K][HD+8] read transposed by ldmatrix
template <int HD, int K>
__device__ __forceinline__ void mma_pb(float (&acc)[HD / 8][4], const uint32_t (&pa)[K / 16][4],
                                       const __nv_bfloat16* b, int lane) {
  constexpr int LD = HD + 8;
  const uint32_t b_addr =
      smem_u32(b + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int nb = 0; nb < HD / 16; ++nb) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b_addr + (kk * 16 * LD + nb * 16) * 2);
      mma16816(acc[2 * nb], pa[kk], bf[0], bf[1]);
      mma16816(acc[2 * nb + 1], pa[kk], bf[2], bf[3]);
    }
  }
}

// p = exp(s - lse) on visible pairs and ds = p (dp - D) scale, in place in c/dp; then
// both packed to bf16 A operands (p and ds rounded where the reference rounds them).
// rows index the accumulator's rows (row0 = this lane's first), cols its columns;
// `key_rows` says which of the two holds keys.
template <int N, bool KEY_ROWS>
__device__ __forceinline__ void p_and_ds(const Params& p, float (&s)[N / 8][4],
                                         float (&dp)[N / 8][4], uint32_t (&pp)[N / 16][4],
                                         uint32_t (&pds)[N / 16][4], int row0, int col0,
                                         int lane, const float* lse_s, const float* dl_s,
                                         int stat0, float scale_log2) {
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + (lane >> 2) + (e >> 1) * 8;          // row of the accumulator
      const int c = nb * 8 + 2 * (lane & 3) + (e & 1);           // its column in the tile
      const int t = KEY_ROWS ? col0 + c : r;                     // query (absolute index)
      const int key = KEY_ROWS ? r : col0 + c;
      const int qi = t - stat0;                                  // index into lse_s / dl_s
      const float pij = visible(p, t, key) ? ex2(fmaf(s[nb][e], scale_log2, -lse_s[qi])) : 0.f;
      s[nb][e] = pij;
      dp[nb][e] = pij * (dp[nb][e] - dl_s[qi]) * p.scale;
    }
  }
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int nb = 2 * kk + (i >> 1), e = (i & 1) * 2;
      pp[kk][i] = pack_bf16(s[nb][e], s[nb][e + 1]);
      pds[kk][i] = pack_bf16(dp[nb][e], dp[nb][e + 1]);
    }
  }
}

template <int HD>
struct Mma {
  static constexpr int LD = HD + 8;
  static constexpr int BQ = HD <= 64 ? 64 : 32;   // queries per dk/dv step (register budget)
  static constexpr int TILE64 = 64 * LD;           // elements of a 64-row tile
  static constexpr int TILEQ = BQ * LD;
  static constexpr size_t DKDV_SMEM = 2 * (2 * TILE64 + 4 * TILEQ) + 4 * 4 * BQ;
  static constexpr size_t DQ_SMEM = 2 * (2 * TILE64 + 4 * TILE64) + 4 * 2 * 64;
};

// dk, dv per (b, kv head, 64-key tile): 4 warps of 16 key rows; Q/dO tiles (with
// their lse and D) double-buffered by cp.async over the G heads and visible q tiles
template <int HD>
__global__ void __launch_bounds__(NTHREADS) dkdv_mma(const Params p) {
  using M = Mma<HD>;
  constexpr int BQ = M::BQ, LD = M::LD;
  extern __shared__ __align__(16) uint8_t smem_b[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_b);   // [64][LD]
  __nv_bfloat16* v_s = k_s + M::TILE64;                            // [64][LD]
  __nv_bfloat16* q_s = v_s + M::TILE64;                            // 2 x [BQ][LD]
  __nv_bfloat16* do_s = q_s + 2 * M::TILEQ;                        // 2 x [BQ][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * M::TILEQ);    // 2 x [BQ], log2 units
  float* dl_s = lse_s + 2 * BQ;                                    // 2 x [BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bkv = blockIdx.x, kvh = bkv % p.KV, b = bkv / p.KV;
  const int k0 = blockIdx.y * 64;
  const float scale_log2 = p.scale * LOG2E;
  const long long k_off = b * p.k_sb + kvh * p.k_sh;
  cp_tile<HD, 64>(k_s, static_cast<const __nv_bfloat16*>(p.k) + k_off, p.k_st, k0, p.Tk);
  cp_tile<HD, 64>(v_s, static_cast<const __nv_bfloat16*>(p.v) + k_off, p.k_st, k0, p.Tk);

  // queries that can see some key of this tile
  const int k_last = min(k0 + 64, p.Tk) - 1;
  const int t_lo = max(0, k0 - p.q_offset);
  const int t_hi = p.window ? min(p.Tq, k_last + p.window - p.q_offset) : p.Tq;
  const int qt0 = t_lo / BQ;
  const int n_qt = t_hi > t_lo ? (t_hi + BQ - 1) / BQ - qt0 : 0;
  const int total = n_qt * p.G;

  auto issue = [&](int it) {        // the it-th (g, q tile) into buffer it & 1
    const int g = it / n_qt, q0 = (qt0 + it % n_qt) * BQ, buf = it & 1;
    const long long q_off = b * p.q_sb + kvh * p.q_sh + g * p.q_sg;
    cp_tile<HD, BQ>(q_s + buf * M::TILEQ, static_cast<const __nv_bfloat16*>(p.q) + q_off, p.q_st,
                    q0, p.Tq);
    cp_tile<HD, BQ>(do_s + buf * M::TILEQ, static_cast<const __nv_bfloat16*>(p.dout) + q_off,
                    p.q_st, q0, p.Tq);
    const long long stat = ((long long)bkv * p.G + g) * p.Tq;
    for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
      const int t = q0 + r;
      lse_s[buf * BQ + r] = t < p.Tq ? p.lse[stat + t] * LOG2E : 0.f;
      dl_s[buf * BQ + r] = t < p.Tq ? p.delta[stat + t] : 0.f;
    }
  };

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  if (total > 0) issue(0);
  cp_commit();
  for (int it = 0; it < total; ++it) {
    const int buf = it & 1, q0 = (qt0 + it % n_qt) * BQ;
    if (it + 1 < total) issue(it + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();                // tile `it` (and k/v) in shared memory
    float s[BQ / 8][4], dp[BQ / 8][4];
    uint32_t pp[BQ / 16][4], pds[BQ / 16][4];
    mma_abt<HD, BQ>(s, k_s + warp * 16 * LD, q_s + buf * M::TILEQ, lane);     // S^T
    mma_abt<HD, BQ>(dp, v_s + warp * 16 * LD, do_s + buf * M::TILEQ, lane);   // dP^T
    p_and_ds<BQ, true>(p, s, dp, pp, pds, k0 + warp * 16, q0, lane, lse_s + buf * BQ,
                       dl_s + buf * BQ, q0, scale_log2);
    mma_pb<HD, BQ>(dv, pp, do_s + buf * M::TILEQ, lane);     // dV += P^T dO
    mma_pb<HD, BQ>(dk, pds, q_s + buf * M::TILEQ, lane);     // dK += dS^T Q
    __syncthreads();                // buffer `buf` is free for tile it + 2
  }
  cp_wait<0>();

  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + k_off;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + k_off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = k0 + warp * 16 + (lane >> 2) + 8 * h;
    if (t >= p.Tk) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const long long off = (long long)t * p.k_st + j * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(dkg + off) = pack_bf16(dk[j][2 * h], dk[j][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dvg + off) = pack_bf16(dv[j][2 * h], dv[j][2 * h + 1]);
    }
  }
}

// dq per (b, kv head, g, 64-query tile): 4 warps of 16 query rows; K/V tiles
// double-buffered by cp.async over the visible key tiles
template <int HD>
__global__ void __launch_bounds__(NTHREADS) dq_mma(const Params p) {
  using M = Mma<HD>;
  constexpr int LD = M::LD;
  extern __shared__ __align__(16) uint8_t smem_b[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_b);   // [64][LD]
  __nv_bfloat16* do_s = q_s + M::TILE64;                           // [64][LD]
  __nv_bfloat16* k_s = do_s + M::TILE64;                           // 2 x [64][LD]
  __nv_bfloat16* v_s = k_s + 2 * M::TILE64;                        // 2 x [64][LD]
  float* lse_s = reinterpret_cast<float*>(v_s + 2 * M::TILE64);    // [64], log2 units
  float* dl_s = lse_s + 64;                                        // [64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bhg = blockIdx.x;
  const int g = bhg % p.G, kvh = (bhg / p.G) % p.KV, b = bhg / (p.G * p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;   // heaviest (latest) tiles first
  const float scale_log2 = p.scale * LOG2E;
  const long long q_off = b * p.q_sb + kvh * p.q_sh + g * p.q_sg;
  const long long k_off = b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + k_off;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + k_off;

  // keys that some real query of this tile can see
  const int pos_lo = p.q_offset + q0;
  const int pos_hi = p.q_offset + min(q0 + 64, p.Tq) - 1;
  const int k_lo = p.window ? max(0, pos_lo - p.window + 1) : 0;
  const int k_hi = min(p.Tk, pos_hi + 1);
  const int kt0 = k_lo / 64;
  const int n_kt = k_hi > k_lo ? (k_hi + 63) / 64 - kt0 : 0;

  cp_tile<HD, 64>(q_s, static_cast<const __nv_bfloat16*>(p.q) + q_off, p.q_st, q0, p.Tq);
  cp_tile<HD, 64>(do_s, static_cast<const __nv_bfloat16*>(p.dout) + q_off, p.q_st, q0, p.Tq);
  for (int r = threadIdx.x; r < 64; r += NTHREADS) {
    const int t = q0 + r;
    lse_s[r] = t < p.Tq ? p.lse[(long long)bhg * p.Tq + t] * LOG2E : 0.f;
    dl_s[r] = t < p.Tq ? p.delta[(long long)bhg * p.Tq + t] : 0.f;
  }
  auto issue = [&](int it) {
    const int kt = (kt0 + it) * 64, buf = it & 1;
    cp_tile<HD, 64>(k_s + buf * M::TILE64, kg, p.k_st, kt, p.Tk);
    cp_tile<HD, 64>(v_s + buf * M::TILE64, vg, p.k_st, kt, p.Tk);
  };

  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  if (n_kt > 0) issue(0);
  cp_commit();
  for (int it = 0; it < n_kt; ++it) {
    const int buf = it & 1, kt = (kt0 + it) * 64;
    if (it + 1 < n_kt) issue(it + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    float s[8][4], dp[8][4];
    uint32_t pp[4][4], pds[4][4];
    mma_abt<HD, 64>(s, q_s + warp * 16 * LD, k_s + buf * M::TILE64, lane);     // S
    mma_abt<HD, 64>(dp, do_s + warp * 16 * LD, v_s + buf * M::TILE64, lane);   // dP
    p_and_ds<64, false>(p, s, dp, pp, pds, q0 + warp * 16, kt, lane, lse_s, dl_s, q0,
                        scale_log2);
    mma_pb<HD, 64>(dq, pds, k_s + buf * M::TILE64, lane);                      // dQ += dS K
    __syncthreads();
  }
  cp_wait<0>();

  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + q_off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = q0 + warp * 16 + (lane >> 2) + 8 * h;
    if (t >= p.Tq) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dqg + (long long)t * p.q_st + j * 8 + 2 * (lane & 3)) =
          pack_bf16(dq[j][2 * h], dq[j][2 * h + 1]);
  }
}

template <int HD>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  using M = Mma<HD>;
  using T = __nv_bfloat16;
  const long long rows = (long long)p.B * p.Tq * p.KV * p.G;
  const int rows_per_block = NTHREADS / 32;
  delta_kernel<T, HD><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), NTHREADS, 0,
                        stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(dkdv_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)M::DKDV_SMEM);
  if (err != cudaSuccess) return err;
  dkdv_mma<HD><<<dim3(p.B * p.KV, (p.Tk + 63) / 64), NTHREADS, M::DKDV_SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(dq_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)M::DQ_SMEM);
  if (err != cudaSuccess) return err;
  dq_mma<HD><<<dim3(p.B * p.KV * p.G, (p.Tq + 63) / 64), NTHREADS, M::DQ_SMEM, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_bf16<32>(p, stream);
    case 64: return launch_bf16<64>(p, stream);
    case 112: return launch_bf16<112>(p, stream);
    case 128: return launch_bf16<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_fp32(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<float, 32>(p, stream);
    case 64: return launch<float, 64>(p, stream);
    case 112: return launch<float, 112>(p, stream);
    case 128: return launch<float, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the three kernels were launched.  is_bf16 selects
// the element type of q/k/v/o/do/dq/dk/dv and the kernels (0: fp32, SIMT; 1: bf16,
// tensor cores); strides are in
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
  return is_bf16 ? dispatch_bf16(p, hd, s) : dispatch_fp32(p, hd, s);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
