// Backward of the chunked Mamba2 SSD scan for Hopper (sm_90a), fp32, its products on the
// TF32 tensor cores (3xTF32 mma.sync, scan_sm90.cuh).
//
// The reference has no kernel for it: src/repro/kernels/ref.py:366-420 (mamba2_ssd) is
// differentiated by JAX's autodiff.  This computes the same gradients from the state
// before every 64 rows, which mamba2_ssd.cu writes when asked (S_chunks):
//
//   x [Bt,T,H,P], dt [Bt,T,H], A [H], B/C [Bt,T,N], S_chunks [Bt,n_chunks,H,P,N],
//   dy [Bt,T,H,P], ds_out [Bt,H,P,N] (or none: zero)
//     -> dx [Bt,T,H,P], ddt [Bt,T,H], dA [H], dB/dC [Bt,T,N], ds0 [Bt,H,P,N]
//
// Per chunk of 64 rows and head, with cl the inclusive cumsum of a = A dt, L_ij =
// e^(cl_i - cl_j) (j <= i), G = C B^T, M = G * L, xs_j = dt_j x_j, S the chunk's initial
// state and dS the gradient of its final state:
//   dS_in = e^cl_last dS + (e^cl * dy)^T C                             (the state pass)
//   dxs_j = sum_{i>=j} M_ij dy_i + e^(cl_last - cl_j) dS B_j,  dx_j = dt_j dxs_j
//   dG_ij = L_ij dy_i . xs_j,  dC_i = e^cl_i (S^T dy_i) + sum_j dG_ij B_j,
//   dB_j = sum_i dG_ij C_i + e^(cl_last - cl_j) dS^T xs_j               (dB, dC summed over heads)
//   dcl_i = C_i . e^cl_i (S^T dy_i) + sum_j dG_ij G_ij - sum_j dG_ji G_ji
//           - xs_i . e^(cl_last - cl_i) dS B_i,  plus on the last row
//           e^cl_last sum(S * dS) + sum_j xs_j . e^(cl_last - cl_j) dS B_j
//   da_m = sum_{i>=m} dcl_i,  ddt_m = x_m . dxs_m + A da_m,  dA = sum over batch and rows of dt da.
//
// What bounds it on an H100 (SXM, published peaks at a 700 W power limit): at zamba2-7b's
// training shape (Bt=2, T=2048, H=112, P=N=64) it reads x and dy and writes dx, 117 MB
// each, with dt, B, C and their gradients small: 0.36 GB, 0.11 ms of device memory, against
// ~5e10 flops of products, 0.1 ms at the 495 TFLOP/s TF32 rate.  The design is the simple
// one first:
//   * a reverse state pass (one block per (batch, head), the [P,N] gradient in registers)
//     walks the chunks from the last, writes each chunk's dS to a workspace and ends with
//     ds0;
//   * a chunk pass, one block per (chunk, batch, 8 heads): C B^T once for the 8 heads, then
//     per head every product above as 3xTF32 mma.sync through warp_gemm, dB and dC summed
//     over its 8 heads in registers, dx and ddt written;
//   * two small kernels sum dB and dC over the head groups, and dA's partials, in a fixed
//     order: no atomics, reruns are bit-identical;
//   * exponentials on the special-function unit (ex2.approx.ftz); every exponent is <= 0
//     for A < 0 and dt >= 0, so nothing overflows where a decay underflows;
//   * the ragged last chunk is masked (rows past T read as x = dt = B = C = dy = 0) and not
//     written.

#include <cuda_runtime.h>

#include "scan_sm90.cuh"

namespace {

constexpr int CH = 64;          // rows per chunk
constexpr int P = 64, N = 64;   // head and state sizes
constexpr int HG = 8;           // heads of one chunk-pass block
constexpr int ST_THREADS = 128;
constexpr int CT = 256;         // chunk-pass threads: 8 warps
constexpr int LDK = 72;
constexpr int LD = 68;

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  const float* S_chunks;   // [Bt][n_chunks][H][P][N]
  const float* dy;
  const float* ds_out;     // [Bt][H][P][N] or null
  float* dx;
  float* ddt;
  float* dA;
  float* dB;
  float* dC;
  float* ds0;
  float* dS_chunks;        // [Bt][n_chunks][H][P][N] the gradient of each chunk's final state
  float* dBC_part;         // [2][Bt][n_groups][T][N]: dB, dC summed over each group's heads
  float* dA_part;          // [Bt][n_chunks][H]
  int Bt, T, H, n_chunks, n_groups;
};

// cl_s[i] = cumsum(A dt) over the chunk's rows, e_s[i] = e^cl_i, dec_s[i] = e^(cl_last -
// cl_i), by one warp (two rows a lane); returns cl_last in every lane.
__device__ __forceinline__ float chunk_cumsum(const float* dt_s, float A, float* cl_s, float* e_s,
                                              float* dec_s, int lane) {
  const float a0 = A * dt_s[2 * lane], a1 = A * dt_s[2 * lane + 1];
  const float run = a0 + a1;
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float excl = incl - run, last = __shfl_sync(0xffffffffu, incl, 31);
  const float c0 = excl + a0, c1 = excl + a0 + a1;
  if (cl_s) cl_s[2 * lane] = c0, cl_s[2 * lane + 1] = c1;
  e_s[2 * lane] = scan::ex(c0), e_s[2 * lane + 1] = scan::ex(c1);
  if (dec_s) dec_s[2 * lane] = scan::ex(last - c0), dec_s[2 * lane + 1] = scan::ex(last - c1);
  return last;
}

__device__ __forceinline__ void load_dt(float* dt_s, const float* dt, int H, int t0, int T,
                                        int tid) {
  if (tid < CH) {
    const bool in = t0 + tid < T;
    scan::cp_async4(dt_s + tid, dt + (in ? (long long)(t0 + tid) * H : 0), in);
  }
}

// ------------------------------------------------------------------ (a) reverse state pass

constexpr size_t ST_SMEM = (2 * CH * LDK + 2 * CH) * sizeof(float);   // dy, C; dt, e^cl

__global__ void __launch_bounds__(ST_THREADS) ssd_bwd_state_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* dy_s = smem;               // [i][p]
  float* C_s = dy_s + CH * LDK;     // [i][n]
  float* dt_s = C_s + CH * LDK;
  float* e_s = dt_s + CH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const float A = p.A[h];
  const long long row = (long long)p.H * P;
  const float* dyb = p.dy + (long long)b * p.T * row + h * P;
  const float* Cb = p.Cm + (long long)b * p.T * N;
  const float* dtb = p.dt + (long long)b * p.T * p.H + h;
  const int p0 = 16 * warp;

  float dS[N / 8][4];
  const long long sidx = ((long long)b * p.H + h) * P * N;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    float2 lo = make_float2(0.f, 0.f), hi = lo;
    if (p.ds_out) {
      lo = *reinterpret_cast<const float2*>(p.ds_out + sidx + (p0 + g) * N + 8 * nt + 2 * t);
      hi = *reinterpret_cast<const float2*>(p.ds_out + sidx + (p0 + g + 8) * N + 8 * nt + 2 * t);
    }
    dS[nt][0] = lo.x, dS[nt][1] = lo.y, dS[nt][2] = hi.x, dS[nt][3] = hi.y;
  }

  for (int c = p.n_chunks - 1; c >= 0; --c) {
    {
      float* s = p.dS_chunks + (((long long)b * p.n_chunks + c) * p.H + h) * P * N;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        *reinterpret_cast<float2*>(s + (p0 + g) * N + 8 * nt + 2 * t) =
            make_float2(dS[nt][0], dS[nt][1]);
        *reinterpret_cast<float2*>(s + (p0 + g + 8) * N + 8 * nt + 2 * t) =
            make_float2(dS[nt][2], dS[nt][3]);
      }
    }
    const int t0 = c * CH;
    __syncthreads();              // every warp is done with chunk c+1's tiles
    scan::load_rows<CH, P, LDK, ST_THREADS>(dy_s, dyb, row, t0, p.T, tid);
    scan::load_rows<CH, N, LDK, ST_THREADS>(C_s, Cb, N, t0, p.T, tid);
    load_dt(dt_s, dtb, p.H, t0, p.T, tid);
    scan::cp_async_commit();
    scan::cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) chunk_cumsum(dt_s, A, nullptr, e_s, nullptr, lane);
    __syncthreads();
    const float decay = e_s[CH - 1];   // e^cl_last

    // dS = e^cl_last dS + (e^cl * dy)^T C; A = [p rows][i]
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) dS[nt][q] *= decay;
    scan::warp_gemm<N / 8, CH>(
        dS, [&](int m, int i) { return dy_s[i * LDK + p0 + m] * e_s[i]; },
        [&](int i, int n) { return C_s[i * LDK + n]; });
  }

#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    *reinterpret_cast<float2*>(p.ds0 + sidx + (p0 + g) * N + 8 * nt + 2 * t) =
        make_float2(dS[nt][0], dS[nt][1]);
    *reinterpret_cast<float2*>(p.ds0 + sidx + (p0 + g + 8) * N + 8 * nt + 2 * t) =
        make_float2(dS[nt][2], dS[nt][3]);
  }
}

// ------------------------------------------------------------------ (b) chunk pass

constexpr int TILE = CH * LD;
// B, C, G, x, dy, S, dS, M, dG tiles; dt, cl, e^cl, dec, dcl; 2 x 3 partial rows
constexpr size_t CHUNK_SMEM = (9 * TILE + 5 * CH + 6 * CH) * sizeof(float);

// Sum over the 4 lanes of a row group (t = 0..3) of a warp's accumulator rows, then the
// lane with t = 0 writes the two rows' sums to out[m0 + g] and out[m0 + g + 8].
__device__ __forceinline__ void row_sums(float lo, float hi, float* out, int m0, int lane) {
  lo += __shfl_xor_sync(0xffffffffu, lo, 1);
  lo += __shfl_xor_sync(0xffffffffu, lo, 2);
  hi += __shfl_xor_sync(0xffffffffu, hi, 1);
  hi += __shfl_xor_sync(0xffffffffu, hi, 2);
  if ((lane & 3) == 0) out[m0 + (lane >> 2)] = lo, out[m0 + (lane >> 2) + 8] = hi;
}

__global__ void __launch_bounds__(CT, 1) ssd_bwd_chunk_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* B_s = smem;                // [j][n]
  float* C_s = B_s + TILE;          // [i][n]
  float* G_s = C_s + TILE;          // [i][j] C_i . B_j
  float* x_s = G_s + TILE;          // [j][p]
  float* dy_s = x_s + TILE;         // [i][p]
  float* S_s = dy_s + TILE;         // [p][n]
  float* dS_s = S_s + TILE;         // [p][n]
  float* M_s = dS_s + TILE;         // [i][j] G L (j <= i)
  float* dG_s = M_s + TILE;         // [i][j] L dy_i . xs_j (j <= i)
  float* dt_s = dG_s + TILE;
  float* cl_s = dt_s + CH;
  float* e_s = cl_s + CH;           // e^cl
  float* dec_s = e_s + CH;          // e^(cl_last - cl)
  float* dcl_s = dec_s + CH;
  float* part = dcl_s + CH;         // [3 kinds][2 column halves][CH]: x.dxs, xs.dxs_state, C.dC_state
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x, b = blockIdx.y, grp = blockIdx.z;
  const int t0 = c * CH, valid = min(CH, p.T - t0);
  const long long row = (long long)p.H * P;
  const int mi = 16 * (warp >> 1), n0 = 32 * (warp & 1), half = warp & 1;
  float* ddt_part = part;
  float* q_part = part + 2 * CH;
  float* rr_part = part + 4 * CH;

  scan::load_rows<CH, N, LD, CT>(B_s, p.Bm + (long long)b * p.T * N, N, t0, p.T, tid);
  scan::load_rows<CH, N, LD, CT>(C_s, p.Cm + (long long)b * p.T * N, N, t0, p.T, tid);
  scan::cp_async_commit();
  scan::cp_async_wait<0>();
  __syncthreads();
  {
    float acc[4][4] = {};
    scan::warp_gemm<4, N>(acc, [&](int m, int nn) { return C_s[(mi + m) * LD + nn]; },
                          [&](int nn, int n) { return B_s[(n0 + n) * LD + nn]; });
    scan::for_each_acc<4>(acc, [&](int m, int n, float v) { G_s[(mi + m) * LD + n0 + n] = v; });
  }

  float dB_acc[4][4] = {}, dC_acc[4][4] = {};     // rows t (mi..), columns n (n0..)
  const int h_end = min(p.H, (grp + 1) * HG);
  for (int h = grp * HG; h < h_end; ++h) {
    const float A = p.A[h];
    const long long xb = (long long)b * p.T * row + h * P;
    const long long sbase = (((long long)b * p.n_chunks + c) * p.H + h) * P * N;
    __syncthreads();              // the previous head's tiles are read
    scan::load_rows<CH, P, LD, CT>(x_s, p.x + xb, row, t0, p.T, tid);
    scan::load_rows<CH, P, LD, CT>(dy_s, p.dy + xb, row, t0, p.T, tid);
    scan::load_rows<P, N, LD, CT>(S_s, p.S_chunks + sbase, N, 0, P, tid);
    scan::load_rows<P, N, LD, CT>(dS_s, p.dS_chunks + sbase, N, 0, P, tid);
    load_dt(dt_s, p.dt + (long long)b * p.T * p.H + h, p.H, t0, p.T, tid);
    scan::cp_async_commit();
    scan::cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) chunk_cumsum(dt_s, A, cl_s, e_s, dec_s, lane);
    __syncthreads();

    // (1) dyx = dy xs^T -> M = G L and dG = L dyx on j <= i, zeros above
    {
      float acc[4][4] = {};
      scan::warp_gemm<4, P>(acc, [&](int m, int pp) { return dy_s[(mi + m) * LD + pp]; },
                            [&](int pp, int n) { return x_s[(n0 + n) * LD + pp] * dt_s[n0 + n]; });
      scan::for_each_acc<4>(acc, [&](int m, int n, float v) {
        const int i = mi + m, j = n0 + n;
        float M = 0.f, dG = 0.f;
        if (j <= i) {
          const float L = scan::ex(cl_s[i] - cl_s[j]);
          M = G_s[i * LD + j] * L;
          dG = L * v;
        }
        M_s[i * LD + j] = M;
        dG_s[i * LD + j] = dG;
      });
    }
    __syncthreads();

    // (2) dxs = M^T dy + dec * (B dS^T): dx, and the rows' x . dxs and xs . dxs_state
    {
      float acc[4][4] = {}, st[4][4] = {};
      scan::warp_gemm<4, CH>(acc, [&](int m, int i) { return M_s[i * LD + mi + m]; },
                             [&](int i, int n) { return dy_s[i * LD + n0 + n]; });
      scan::warp_gemm<4, N>(st, [&](int m, int nn) { return B_s[(mi + m) * LD + nn]; },
                            [&](int nn, int n) { return dS_s[(n0 + n) * LD + nn]; });
      // per row j: x_j . dxs_j, and x_j . (the state part of dxs_j), which dt_j turns into
      // xs_j . dxs_state_j when it is read
      float sx[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = mi + g + 8 * (q >> 1), pp = n0 + 8 * nt + 2 * t + (q & 1);
          const float xv = x_s[j * LD + pp], s = dec_s[j] * st[nt][q], dxs = acc[nt][q] + s;
          sx[q >> 1] += xv * dxs;
          sq[q >> 1] += xv * s;
          if (j < valid) p.dx[xb + (long long)(t0 + j) * row + pp] = dt_s[j] * dxs;
        }
      row_sums(sx[0], sx[1], ddt_part + half * CH, mi, lane);
      row_sums(sq[0], sq[1], q_part + half * CH, mi, lane);
    }

    // (3) dC += e^cl * (dy S) + dG B, and the rows' C . e^cl (dy S)
    {
      float acc[4][4] = {};
      scan::warp_gemm<4, P>(acc, [&](int m, int pp) { return dy_s[(mi + m) * LD + pp]; },
                            [&](int pp, int n) { return S_s[pp * LD + n0 + n]; });
      float rr[2] = {0.f, 0.f};
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = g + 8 * (q >> 1), i = mi + m, n = n0 + 8 * nt + 2 * t + (q & 1);
          const float v = acc[nt][q] * e_s[i];
          rr[q >> 1] += C_s[i * LD + n] * v;
          dC_acc[nt][q] += v;
        }
      row_sums(rr[0], rr[1], rr_part + half * CH, mi, lane);
      scan::warp_gemm<4, CH>(dC_acc, [&](int m, int j) { return dG_s[(mi + m) * LD + j]; },
                             [&](int j, int n) { return B_s[j * LD + n0 + n]; });
    }

    // (4) dB += dG^T C + dec * (xs dS)
    {
      scan::warp_gemm<4, CH>(dB_acc, [&](int m, int i) { return dG_s[i * LD + mi + m]; },
                             [&](int i, int n) { return C_s[i * LD + n0 + n]; });
      float acc[4][4] = {};
      scan::warp_gemm<4, P>(acc,
                            [&](int m, int pp) { return x_s[(mi + m) * LD + pp] * dt_s[mi + m]; },
                            [&](int pp, int n) { return dS_s[pp * LD + n0 + n]; });
      const int g = lane >> 2;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) dB_acc[nt][q] += dec_s[mi + g + 8 * (q >> 1)] * acc[nt][q];
    }
    __syncthreads();

    // (5) per row: dcl; then, by one thread in a fixed order, da, ddt and dA's partial
    if (tid < CH) {
      const int i = tid;
      float prow = 0.f, pcol = 0.f, ss = 0.f;
      for (int j = 0; j < CH; ++j) {
        prow += dG_s[i * LD + j] * G_s[i * LD + j];
        pcol += dG_s[j * LD + i] * G_s[j * LD + i];
        ss += S_s[i * LD + j] * dS_s[i * LD + j];      // row p = i of S * dS
      }
      dcl_s[i] = (rr_part[i] + rr_part[CH + i]) + prow - pcol -
                 dt_s[i] * (q_part[i] + q_part[CH + i]);
      cl_s[i] = ss;                                   // cl is no longer needed
    }
    __syncthreads();
    if (tid == 0) {
      float x = 0.f, qs = 0.f;
      for (int i = 0; i < CH; ++i) x += cl_s[i], qs += dt_s[i] * (q_part[i] + q_part[CH + i]);
      float da = x * e_s[CH - 1] + qs, dA = 0.f;
      for (int m = CH - 1; m >= 0; --m) {
        da += dcl_s[m];
        if (m < valid)
          p.ddt[((long long)b * p.T + t0 + m) * p.H + h] =
              (ddt_part[m] + ddt_part[CH + m]) + A * da;
        dA += dt_s[m] * da;
      }
      p.dA_part[((long long)b * p.n_chunks + c) * p.H + h] = dA;
    }
  }

  // this group's dB and dC rows
  const long long pb = (((long long)b * p.n_groups + grp) * p.T + t0) * N;
  const long long pc = pb + (long long)p.Bt * p.n_groups * p.T * N;
  scan::for_each_acc<4>(dB_acc, [&](int m, int n, float v) {
    if (mi + m < valid) p.dBC_part[pb + (long long)(mi + m) * N + n0 + n] = v;
  });
  scan::for_each_acc<4>(dC_acc, [&](int m, int n, float v) {
    if (mi + m < valid) p.dBC_part[pc + (long long)(mi + m) * N + n0 + n] = v;
  });
}

// ------------------------------------------------------------------ (c) sums over groups

// dB[b][t][n], dC[b][t][n] = sums over the head groups, in a fixed order; a block per
// (4 rows, batch)
__global__ void ssd_bwd_reduce_kernel(const Params p) {
  const int t = blockIdx.x * 4 + (threadIdx.x >> 6), n = threadIdx.x & 63, b = blockIdx.y;
  if (t >= p.T) return;
  const long long stride = (long long)p.T * N, half = (long long)p.Bt * p.n_groups * stride;
  const float* src = p.dBC_part + (long long)b * p.n_groups * stride + (long long)t * N + n;
  float sb = 0.f, sc = 0.f;
  for (int g = 0; g < p.n_groups; ++g) sb += src[g * stride], sc += src[half + g * stride];
  p.dB[((long long)b * p.T + t) * N + n] = sb;
  p.dC[((long long)b * p.T + t) * N + n] = sc;
}

// dA[h] = sum over batch and chunks of dA_part, in a fixed order
__global__ void ssd_bwd_dA_reduce_kernel(const Params p) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= p.H) return;
  float acc = 0.f;
  for (int b = 0; b < p.Bt; ++b)
    for (int c = 0; c < p.n_chunks; ++c) acc += p.dA_part[((long long)b * p.n_chunks + c) * p.H + h];
  p.dA[h] = acc;
}

}  // namespace

extern "C" {

// Floats of the workspace ssd_bwd needs: dS at every 64-row chunk, dB and dC summed per
// group of 8 heads, and dA's partials.
long long ssd_bwd_workspace_floats(int Bt, int T, int H) {
  const long long nc = (T + CH - 1) / CH, groups = (H + HG - 1) / HG;
  return (long long)Bt * nc * H * P * N + 2LL * Bt * groups * T * N + (long long)Bt * nc * H;
}

// Returns a cudaError_t: 0 when the four kernels were launched.  All tensors are contiguous
// fp32; P = N = 64 and chunk 128 (the forward's; this walks 64 rows at a time) are the
// compiled sizes; S_chunks is what ssd_fwd writes to s_chunks; ds_out may be null (zero);
// `work` holds ssd_bwd_workspace_floats(Bt, T, H) floats.
int ssd_bwd(const float* x, const float* dt, const float* A, const float* Bm, const float* Cm,
            const float* S_chunks, const float* dy, const float* ds_out, float* dx, float* ddt,
            float* dA, float* dB, float* dC, float* ds0, int Bt, int T, int H, int P_, int N_,
            int chunk, void* work, void* stream) {
  if (P_ != P || N_ != N || chunk != 128 || T <= 0) return cudaErrorInvalidValue;
  const int n_chunks = (T + CH - 1) / CH, n_groups = (H + HG - 1) / HG;
  float* ws = static_cast<float*>(work);
  float* dS_chunks = ws;
  float* dBC_part = dS_chunks + (long long)Bt * n_chunks * H * P * N;
  float* dA_part = dBC_part + 2LL * Bt * n_groups * T * N;
  const Params p{x,  dt,  A,  Bm,        Cm,       S_chunks, dy, ds_out,   dx,      ddt,
                 dA, dB,  dC, ds0,       dS_chunks, dBC_part, dA_part, Bt, T, H, n_chunks,
                 n_groups};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_state_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ST_SMEM);
  if (err != cudaSuccess) return err;
  ssd_bwd_state_kernel<<<Bt * H, ST_THREADS, ST_SMEM, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)CHUNK_SMEM);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<<<dim3(n_chunks, Bt, n_groups), CT, CHUNK_SMEM, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_reduce_kernel<<<dim3((T + 3) / 4, Bt), 256, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dA_reduce_kernel<<<(H + 127) / 128, 128, 0, st>>>(p);
  return cudaGetLastError();
}

const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
