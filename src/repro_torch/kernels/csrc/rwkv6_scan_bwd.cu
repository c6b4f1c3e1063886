// Backward of the chunked RWKV6 WKV recurrence for Hopper (sm_90a), fp32, its matrix
// products on the TF32 tensor cores (3xTF32 mma.sync, scan_sm90.cuh).
//
// The reference has no kernel for it: src/repro/kernels/ref.py:285-345 (rwkv6_chunked) is
// differentiated by JAX's autodiff.  This computes the same gradients from the forward's
// chunk states (rwkv6_scan.cu's workspace, the state at every chunk's start):
//
//   r, k, v, w [B,T,H,K], u [H,K], S_chunks [B,n_chunks,H,K,V], dy [B,T,H,V],
//   ds_out [B,H,K,V] (or none: zero)  ->  dr, dk, dv, dw [B,T,H,K], du [H,K], ds0 [B,H,K,V]
//
// Per chunk of 64 rows, with cl the inclusive cumsum of log w down each key column, clp
// the exclusive one, E_ijk = e^(clp_ik - cl_jk) (j < i), S the chunk's initial state, dS
// the gradient of its final state, datt_ij = dy_i . v_j and att_ij = sum_k r_ik k_jk E_ijk:
//   dS_in = e^cl_last * dS + (r * e^clp)^T dy                         (the state pass)
//   dv_j  = sum_{i>j} att_ij dy_i + (r_j . u k_j) dy_j + (k_j * e^(cl_last - cl_j)) dS
//   dr_i  = e^clp_i * (S dy_i) + sum_{j<i} datt_ij k_j E_ij. + datt_ii u k_i
//   dk_j  = e^(cl_last - cl_j) * (dS v_j) + sum_{i>j} datt_ij r_i E_i.j + datt_jj u r_j
//   du    = sum over batch and rows of datt_ii r_i k_i
// and for the decays, with dr', dk' the first two terms of dr, dk:
//   dclp_i = r_i dr'_i,  dcl_j = -k_j dk'_j,  plus on the last row
//   e^cl_last * rowsum(S dS) + sum_j k_j (e^(cl_last - cl_j) * (dS v_j)),
//   dlog w_m = sum_{i>=m} dcl_i + sum_{i>m} dclp_i,  dw = dlog w / w where w >= 1e-30, else 0
// (the reference's log(max(w, 1e-30)): autodiff gives 0 where the clamp bites).
//
// What bounds it on an H100 (SXM, published peaks at a 700 W power limit): at rwkv6-1.6b's
// training shape (B=2, T=2048, H=32, K=V=64) it reads r, k, v, w, dy and writes dr, dk,
// dv, dw: 0.30 GB, 0.090 ms of device memory; its products are ~1e10 flops, 0.02 ms at the
// 495 TFLOP/s TF32 rate, so it is bound by bytes.  The design is the simple one first:
//   * three kernels, one call: a reverse state pass (one block per (batch, head, 32 value
//     columns)) walks the chunks from the last, writes each chunk's dS to a workspace
//     [B, n_chunks, H, K, V] and ends with ds0; a chunk pass (one block per (batch, head,
//     chunk), all independent) computes every input gradient of the chunk from S, dS and
//     dy; a last small kernel sums du's per-chunk partials in a fixed order;
//   * the matrix products (dy v^T, att^T dy, (k e^(cl_last - cl)) dS, dy S^T, v dS^T and the
//     state pass's (r e^clp)^T dy) run as 3xTF32 mma.sync through warp_gemm;
//   * the decay-weighted sums over (i, j, k) (att, and datt's terms of dr and dk) run on
//     the CUDA cores with one exponential per triple, all of whose exponents are <= 0 for
//     w <= 1, so nothing overflows and no inf * 0 appears where a decay underflows; the
//     forward's factoring of them through reference rows is not done here yet;
//   * exponentials on the special-function unit (ex2.approx.ftz), in log2 units;
//   * the ragged last chunk is masked (rows past T read as r = k = v = dy = 0, w = 1) and
//     not written;
//   * no atomics and a fixed order of every sum: reruns are bit-identical.

#include <cuda_runtime.h>

#include "scan_sm90.cuh"

namespace {

constexpr int CH = 64;                          // rows per chunk
constexpr int D = 64;                           // K = V
constexpr int VT = 32;                          // value columns of one state-pass block
constexpr int ST_THREADS = 128;
constexpr int CT = 256;                         // chunk-pass threads: 8 warps
constexpr int LDK = 72;
constexpr int LDV = VT + 8;
constexpr int LD = 68;

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* S_chunks;   // [B][n_chunks][H][K][V] the forward's state at each chunk's start
  const float* dy;
  const float* ds_out;     // [B][H][K][V] or null
  float* dr;
  float* dk;
  float* dv;
  float* dw;
  float* du;
  float* ds0;
  float* dS_chunks;        // [B][n_chunks][H][K][V] the gradient of each chunk's final state
  float* du_part;          // [B][n_chunks][H][K]
  int B, T, H, n_chunks;
};

// ------------------------------------------------------------------ (a) reverse state pass

constexpr size_t ST_SMEM = (2 * CH * LDK + CH * LDV) * sizeof(float);   // r, w (then cl), dy

__global__ void __launch_bounds__(ST_THREADS) wkv6_bwd_state_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* r_s = smem;
  float* cl_s = r_s + CH * LDK;
  float* dy_s = cl_s + CH * LDK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int v0 = blockIdx.x * VT, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const long long row = (long long)p.H * D;
  const long long base = (long long)b * p.T * row + (long long)h * D;
  const int m0 = 16 * warp;                    // this warp's key rows

  // dS[m0 .. m0+15][v0 .. v0+VT) as VT/8 accumulator tiles
  float dS[VT / 8][4];
  const long long sidx = (long long)bh * D * D + v0;
#pragma unroll
  for (int nt = 0; nt < VT / 8; ++nt) {
    float2 a = make_float2(0.f, 0.f), c = a;
    if (p.ds_out) {
      const float* s = p.ds_out + sidx + (m0 + g) * D + 8 * nt + 2 * t;
      a = *reinterpret_cast<const float2*>(s);
      c = *reinterpret_cast<const float2*>(s + 8 * D);
    }
    dS[nt][0] = a.x, dS[nt][1] = a.y, dS[nt][2] = c.x, dS[nt][3] = c.y;
  }

  for (int c = p.n_chunks - 1; c >= 0; --c) {
    {
      float* out = p.dS_chunks + (((long long)b * p.n_chunks + c) * p.H + h) * D * D + v0;
#pragma unroll
      for (int nt = 0; nt < VT / 8; ++nt) {
        float* s = out + (m0 + g) * D + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(s) = make_float2(dS[nt][0], dS[nt][1]);
        *reinterpret_cast<float2*>(s + 8 * D) = make_float2(dS[nt][2], dS[nt][3]);
      }
    }
    const int t0 = c * CH;
    __syncthreads();              // every warp is done with chunk c+1's tiles
    scan::load_rows<CH, D, LDK, ST_THREADS>(r_s, p.r + base, row, t0, p.T, tid);
    scan::load_rows<CH, D, LDK, ST_THREADS>(cl_s, p.w + base, row, t0, p.T, tid);
    scan::load_rows<CH, VT, LDV, ST_THREADS>(dy_s, p.dy + base + v0, row, t0, p.T, tid);
    scan::cp_async_commit();
    scan::cp_async_wait<0>();
    __syncthreads();
    scan::log2_cumsum<LDK, ST_THREADS>(cl_s, p.T - t0, tid);
    __syncthreads();

    // dS = 2^cl_last * dS + Q^T dy, Q_ik = r_ik 2^clp_ik; A = Q^T [key rows][i]
    const float d0 = scan::ex2(cl_s[(CH - 1) * LDK + m0 + g]);
    const float d1 = scan::ex2(cl_s[(CH - 1) * LDK + m0 + g + 8]);
#pragma unroll
    for (int nt = 0; nt < VT / 8; ++nt) {
      dS[nt][0] *= d0, dS[nt][1] *= d0;
      dS[nt][2] *= d1, dS[nt][3] *= d1;
    }
    scan::warp_gemm<VT / 8, CH>(
        dS,
        [&](int m, int i) {
          const int kk = m0 + m;
          return r_s[i * LDK + kk] * (i ? scan::ex2(cl_s[(i - 1) * LDK + kk]) : 1.f);
        },
        [&](int i, int n) { return dy_s[i * LDV + n]; });
  }

#pragma unroll
  for (int nt = 0; nt < VT / 8; ++nt) {
    float* s = p.ds0 + sidx + (m0 + g) * D + 8 * nt + 2 * t;
    *reinterpret_cast<float2*>(s) = make_float2(dS[nt][0], dS[nt][1]);
    *reinterpret_cast<float2*>(s + 8 * D) = make_float2(dS[nt][2], dS[nt][3]);
  }
}

// ------------------------------------------------------------------ (b) chunk pass

constexpr int TILE = CH * LD;
constexpr size_t CHUNK_SMEM = (11 * TILE + D) * sizeof(float);

__global__ void __launch_bounds__(CT, 1) wkv6_bwd_chunk_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* r_s = smem;                 // [i][k]
  float* k_s = r_s + TILE;
  float* v_s = k_s + TILE;           // [i][v]
  float* dy_s = v_s + TILE;
  float* cl_s = dy_s + TILE;         // w, then the inclusive log2 cumsum
  float* S_s = cl_s + TILE;          // [k][v] the chunk's initial state
  float* dS_s = S_s + TILE;          // [k][v] the gradient of its final state
  float* att_s = dS_s + TILE;        // [i][j] att (j < i), the u bonus (j = i), 0 (j > i)
  float* datt_s = att_s + TILE;      // [i][j] dy_i . v_j
  float* x1_s = datt_s + TILE;       // [i][k] 2^clp * (dy S^T), then dclp
  float* x2_s = x1_s + TILE;         // [j][k] 2^(cl_last - cl) * (v dS^T), then dcl
  float* u_s = x2_s + TILE;          // [k]
  const int tid = threadIdx.x, warp = tid >> 5;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int t0 = c * CH, valid = min(CH, p.T - t0);
  const long long row = (long long)p.H * D;
  const long long base = (long long)b * p.T * row + (long long)h * D;
  const long long sbase = (((long long)b * p.n_chunks + c) * p.H + h) * D * D;

  scan::load_rows<CH, D, LD, CT>(r_s, p.r + base, row, t0, p.T, tid);
  scan::load_rows<CH, D, LD, CT>(k_s, p.k + base, row, t0, p.T, tid);
  scan::load_rows<CH, D, LD, CT>(v_s, p.v + base, row, t0, p.T, tid);
  scan::load_rows<CH, D, LD, CT>(dy_s, p.dy + base, row, t0, p.T, tid);
  scan::load_rows<CH, D, LD, CT>(cl_s, p.w + base, row, t0, p.T, tid);
  scan::load_rows<D, D, LD, CT>(S_s, p.S_chunks + sbase, D, 0, D, tid);
  scan::load_rows<D, D, LD, CT>(dS_s, p.dS_chunks + sbase, D, 0, D, tid);
  scan::cp_async_commit();
  if (tid < D) u_s[tid] = p.u[(long long)h * D + tid];
  scan::cp_async_wait<0>();
  __syncthreads();
  scan::log2_cumsum<LD, CT>(cl_s, valid, tid);
  __syncthreads();

  const float* clL = cl_s + (CH - 1) * LD;     // cl at the chunk's last row
  auto clp = [&](int i, int kk) { return i ? cl_s[(i - 1) * LD + kk] : 0.f; };
  const int mi = 16 * (warp >> 1), n0 = 32 * (warp & 1);   // this warp's 16 x 32 of a 64 x 64

  // (1) datt = dy v^T
  {
    float acc[4][4] = {};
    scan::warp_gemm<4, D>(acc, [&](int m, int vv) { return dy_s[(mi + m) * LD + vv]; },
                          [&](int vv, int n) { return v_s[(n0 + n) * LD + vv]; });
    scan::for_each_acc<4>(acc, [&](int m, int n, float x) { datt_s[(mi + m) * LD + n0 + n] = x; });
  }

  // (2) att_ij = sum_k r_ik k_jk 2^(clp_ik - cl_jk) for j < i, the u bonus on the
  // diagonal, zeros above it; a warp per row i at a time, its lanes over k
  {
    const int lane = tid & 31;
    for (int i = warp; i < CH; i += CT / 32) {
      const float ra = r_s[i * LD + lane], rb = r_s[i * LD + lane + 32];
      const float pa = clp(i, lane), pb = clp(i, lane + 32);
      for (int j = 0; j < CH; ++j) {
        float x = 0.f;
        if (j < i) {
          x = ra * k_s[j * LD + lane] * scan::ex2(pa - cl_s[j * LD + lane]) +
              rb * k_s[j * LD + lane + 32] * scan::ex2(pb - cl_s[j * LD + lane + 32]);
        } else if (j == i) {
          x = ra * u_s[lane] * k_s[i * LD + lane] + rb * u_s[lane + 32] * k_s[i * LD + lane + 32];
        }
        if (j <= i) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
        }
        if (lane == 0) att_s[i * LD + j] = x;
      }
    }
  }
  __syncthreads();

  // (3) dv = att^T dy + (k 2^(cl_last - cl)) dS;  x1 = 2^clp * (dy S^T);
  //     x2 = 2^(cl_last - cl) * (v dS^T)
  {
    float acc[4][4] = {};
    scan::warp_gemm<4, CH>(acc, [&](int m, int i) { return att_s[i * LD + mi + m]; },
                           [&](int i, int n) { return dy_s[i * LD + n0 + n]; });
    scan::warp_gemm<4, D>(
        acc,
        [&](int m, int kk) {
          const int j = mi + m;
          return k_s[j * LD + kk] * scan::ex2(clL[kk] - cl_s[j * LD + kk]);
        },
        [&](int kk, int n) { return dS_s[kk * LD + n0 + n]; });
    scan::for_each_acc<4>(acc, [&](int m, int n, float x) {
      if (mi + m < valid) p.dv[base + (long long)(t0 + mi + m) * row + n0 + n] = x;
    });
  }
  {
    float acc[4][4] = {};
    scan::warp_gemm<4, D>(acc, [&](int m, int vv) { return dy_s[(mi + m) * LD + vv]; },
                          [&](int vv, int n) { return S_s[(n0 + n) * LD + vv]; });
    scan::for_each_acc<4>(acc, [&](int m, int n, float x) {
      x1_s[(mi + m) * LD + n0 + n] = x * scan::ex2(clp(mi + m, n0 + n));
    });
  }
  {
    float acc[4][4] = {};
    scan::warp_gemm<4, D>(acc, [&](int m, int vv) { return v_s[(mi + m) * LD + vv]; },
                          [&](int vv, int n) { return dS_s[(n0 + n) * LD + vv]; });
    scan::for_each_acc<4>(acc, [&](int m, int n, float x) {
      const int j = mi + m, kk = n0 + n;
      x2_s[j * LD + kk] = x * scan::ex2(clL[kk] - cl_s[j * LD + kk]);
    });
  }
  __syncthreads();

  // (4) per (row, key): dr and dk, and the decay's terms; a thread per key column and
  // every 4th row
  {
    const int kk = tid & 63;
    const float uk = u_s[kk];
    for (int i = tid >> 6; i < CH; i += CT / 64) {
      const float pi = clp(i, kk), ci = cl_s[i * LD + kk];
      const float ri = r_s[i * LD + kk], ki = k_s[i * LD + kk];
      float dr_att = 0.f, dk_att = 0.f;
      for (int j = 0; j < i; ++j)
        dr_att += datt_s[i * LD + j] * k_s[j * LD + kk] * scan::ex2(pi - cl_s[j * LD + kk]);
      for (int i2 = i + 1; i2 < CH; ++i2)
        dk_att += datt_s[i2 * LD + i] * r_s[i2 * LD + kk] * scan::ex2(cl_s[(i2 - 1) * LD + kk] - ci);
      const float dd = datt_s[i * LD + i];
      const float x1 = x1_s[i * LD + kk], x2 = x2_s[i * LD + kk];
      const float drs = x1 + dr_att, dks = x2 + dk_att;
      if (i < valid) {
        const long long o = base + (long long)(t0 + i) * row + kk;
        p.dr[o] = drs + dd * uk * ki;
        p.dk[o] = dks + dd * uk * ri;
      }
      x1_s[i * LD + kk] = ri * drs;       // dclp
      x2_s[i * LD + kk] = -ki * dks;      // dcl
      att_s[i * LD + kk] = ki * x2;       // k_j . the state part of dk_j
    }
  }
  __syncthreads();

  // (5) per key column: dlog w by a reverse cumsum, dw, and du's partial
  if (tid < D) {
    const int kk = tid;
    float x = 0.f;
    for (int vv = 0; vv < D; ++vv) x += S_s[kk * LD + vv] * dS_s[kk * LD + vv];
    float run_cl = x * scan::ex2(clL[kk]);
    for (int j = 0; j < CH; ++j) run_cl += att_s[j * LD + kk];
    float run_clp = 0.f, du = 0.f;
    for (int m = CH - 1; m >= 0; --m) {
      run_cl += x2_s[m * LD + kk];
      const float dlw = run_cl + run_clp;
      run_clp += x1_s[m * LD + kk];
      if (m < valid) {
        const long long o = base + (long long)(t0 + m) * row + kk;
        const float wm = p.w[o];
        p.dw[o] = wm >= 1e-30f ? dlw / wm : 0.f;
      }
      du += datt_s[m * LD + m] * r_s[m * LD + kk] * k_s[m * LD + kk];
    }
    p.du_part[(((long long)b * p.n_chunks + c) * p.H + h) * D + kk] = du;
  }
}

// ------------------------------------------------------------------ (c) du

// du[h][k] = sum over batch and chunks of du_part, in a fixed order
__global__ void wkv6_bwd_du_reduce_kernel(const Params p) {
  const int h = blockIdx.x, kk = threadIdx.x;
  float acc = 0.f;
  for (int b = 0; b < p.B; ++b)
    for (int c = 0; c < p.n_chunks; ++c)
      acc += p.du_part[(((long long)b * p.n_chunks + c) * p.H + h) * D + kk];
  p.du[h * D + kk] = acc;
}

}  // namespace

extern "C" {

// Floats of the workspace wkv6_bwd needs: dS at every 64-row chunk, and du's partials.
long long wkv6_bwd_workspace_floats(int B, int T, int H) {
  const long long nc = (T + CH - 1) / CH;
  return (long long)B * nc * H * D * D + (long long)B * nc * H * D;
}

// Returns a cudaError_t: 0 when the three kernels were launched.  All tensors are contiguous
// fp32; K = V = head (64) and chunk (64) are the compiled sizes; S_chunks is wkv6_fwd's
// workspace; ds_out may be null (zero); `work` holds wkv6_bwd_workspace_floats(B, T, H).
int wkv6_bwd(const float* r, const float* k, const float* v, const float* w, const float* u,
             const float* S_chunks, const float* dy, const float* ds_out, float* dr, float* dk,
             float* dv, float* dw, float* du, float* ds0, int B, int T, int H, int head,
             int chunk, void* work, void* stream) {
  if (head != D || chunk != CH || T <= 0) return cudaErrorInvalidValue;
  const int n_chunks = (T + CH - 1) / CH;
  float* ws = static_cast<float*>(work);
  const Params p{r,  k,  v,  w,  u,   S_chunks, dy, ds_out, dr, dk, dv, dw, du, ds0,
                 ws, ws + (long long)B * n_chunks * H * D * D, B, T, H, n_chunks};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_state_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ST_SMEM);
  if (err != cudaSuccess) return err;
  wkv6_bwd_state_kernel<<<dim3(D / VT, B * H), ST_THREADS, ST_SMEM, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv6_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)CHUNK_SMEM);
  if (err != cudaSuccess) return err;
  wkv6_bwd_chunk_kernel<<<dim3(n_chunks, B * H), CT, CHUNK_SMEM, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkv6_bwd_du_reduce_kernel<<<H, D, 0, st>>>(p);
  return cudaGetLastError();
}

const char* wkv6_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
