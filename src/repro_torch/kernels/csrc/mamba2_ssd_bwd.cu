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
// What bounds it on an H100 (SXM, published peaks at a 700 W power limit), at zamba2-7b's
// training shape (Bt=2, T=2048, H=112, P=N=64; 7168 (chunk of 64 rows, head) pairs):
//   * bytes: it reads x and dy and writes dx, 117 MB each, with dt, B, C and their
//     gradients small: 0.36 GB, 0.11 ms of device memory; its workspace adds 0.35 GB: dS
//     of every chunk and head written by the state pass and read by the chunk pass (117 MB
//     each way) and the forward's states read (117 MB), which puts its byte floor near
//     0.21 ms;
//   * tensor cores: per chunk and head seven 64 x 64 x 64 products, three of them over a
//     triangular operand (M^T dy, dG B, dG^T C), and dy xs^T on and below the diagonal:
//     1428 m16n8k8 products with the zero blocks above the diagonal skipped (C B^T's share
//     included), each run as 3 TF32 passes (3xTF32), plus the state pass's 256: 7.4e10
//     tensor-core flops, 0.15 ms at the 495 TFLOP/s TF32 rate and 0.2-0.3 ms at the rates
//     mma.sync reaches, with every operand's TF32 split on the CUDA cores beside them.
//     This, not bytes, bounds the chunk pass: on an H100 80GB HBM3 at 700 W it ran
//     markedly faster with one TF32 pass in place of three, and with no split at all
//     (diagnostic builds, wrong results), and no faster with the products' passes
//     interleaved across tiles, their loop unrolled further or two products in one loop.
// What the design does about it:
//   * a reverse state pass (one block per (batch, head), the [P,N] gradient in registers)
//     walks the chunks from the last with a 2-stage cp.async ring, writes each chunk's dS
//     to a workspace and ends with ds0; it moves 0.23 GB (dy in, dS out), about 60% of
//     the card's memory rate at its measured time;
//   * a chunk pass, one 16-warp block per (chunk, batch, 8 heads), one an SM: C B^T once
//     for the 8 heads (its lower half), then per head every product above as 3xTF32
//     mma.sync (scan::gemm), dB and dC summed over its 8 heads in registers, dx and ddt
//     written.  Head h+1's x, dy, S, dS and dt load (cp.async) into a second set of tiles
//     while head h computes: 13 tiles of 64 x 68 floats and the partial sums, 231.7 KB.
//     16 warps of 16 x 16 outputs each ran faster than 8 of 16 x 32;
//   * operands read along rows (an A operand, or a B operand stored transposed) load a
//     fragment with one ldmatrix, scaled by dt before the split where the function forms
//     xs = x dt (RowsA, ColsB): xs is then rounded as the function rounds it.  With dt
//     applied after the product instead, dA (a sum over every row of the batch) read
//     3.5e-3 from the plain backward at T=1000, over SCAN_TOL; it reads 2.3e-3 so;
//   * the products over M and dG skip their 16 x 16 blocks above the diagonal, which hold
//     zeros: the skip drops only zero terms, so no sum changes;
//   * M is stored transposed (M^T dy reads it along rows), and the decay gradient's row
//     and column sums of dG * G are formed in the product's accumulators and summed over
//     lanes by shuffles; da's reverse cumsum over the chunk is one warp's shuffle scan;
//   * two small kernels sum dB and dC over the head groups, and dA's partials, in a fixed
//     order: no atomics, reruns are bit-identical;
//   * exponentials on the special-function unit (ex2.approx.ftz); every exponent is <= 0
//     for A < 0 and dt >= 0, so nothing overflows where a decay underflows;
//   * the ragged last chunk is masked (rows past T read as x = dt = B = C = dy = 0) and not
//     written.
// The head and state sizes (P, N) are template parameters, instantiated for (64, 64) and
// for the reduced configs' (32, 16) and chosen by the extern "C" entry.  The state pass has
// a warp for every 16 head columns; the chunk pass keeps its 64 x 68 tiles (G, M^T and dG
// are [64][64] whatever P and N are) and its 16 warps, and a warp's column quarter takes
// part in a product over head columns (dx) or state columns (dB, dC) only where that
// quarter exists: at (32, 16) two warps of a row block form dx and one dB and dC, the
// others adding zeros to the row sums.  A head count that is not a multiple of HG leaves
// the last group short (h_end).

#include <cuda_runtime.h>

#include "scan_sm90.cuh"

namespace {

constexpr int CH = 64;          // rows per chunk
constexpr int HG = 8;           // heads of one chunk-pass block
constexpr int CT = 512;         // chunk-pass threads: 16 warps
constexpr int LD = CH + 4;      // the chunk pass's rows

template <int P, int N>
struct Shape {
  static_assert(P % 16 == 0 && N % 16 == 0 && P <= 64 && N <= 64, "(P, N) up to (64, 64)");
  static constexpr int ST_THREADS = 2 * P;                // a warp per 16 head columns
  static constexpr int LDK = (P > N ? P : N) + 8;         // the state pass's rows
  static constexpr int ST_STAGE = 2 * CH * LDK + CH;      // dy, C, dt
  static constexpr size_t ST_SMEM = (2 * ST_STAGE + CH) * sizeof(float);   // two stages; e^cl
};

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ------------------------------------------------------------------ (a) reverse state pass

template <int P, int N>
__global__ void __launch_bounds__(Shape<P, N>::ST_THREADS, 2) ssd_bwd_state_kernel(const Params p) {
  constexpr int ST_THREADS = Shape<P, N>::ST_THREADS, LDK = Shape<P, N>::LDK;
  constexpr int ST_STAGE = Shape<P, N>::ST_STAGE;
  extern __shared__ __align__(16) float smem[];
  float* e_s = smem + 2 * ST_STAGE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const float A = p.A[h];
  const long long row = (long long)p.H * P;
  const float* dyb = p.dy + (long long)b * p.T * row + h * P;
  const float* Cb = p.Cm + (long long)b * p.T * N;
  const float* dtb = p.dt + (long long)b * p.T * p.H + h;
  const int p0 = 16 * warp;

  auto load_chunk = [&](int c, int stage) {
    float* dy_s = smem + stage * ST_STAGE;
    const int t0 = c * CH;
    scan::load_rows<CH, P, LDK, ST_THREADS>(dy_s, dyb, row, t0, p.T, tid);
    scan::load_rows<CH, N, LDK, ST_THREADS>(dy_s + CH * LDK, Cb, N, t0, p.T, tid);
    load_dt(dy_s + 2 * CH * LDK, dtb, p.H, t0, p.T, tid);
    scan::cp_async_commit();
  };

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

  load_chunk(p.n_chunks - 1, 0);
  for (int c = p.n_chunks - 1; c >= 0; --c) {
    const float* dy_s = smem + ((p.n_chunks - 1 - c) & 1) * ST_STAGE;
    const float* C_s = dy_s + CH * LDK;
    const float* dt_s = C_s + CH * LDK;
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
    scan::cp_async_wait<0>();
    __syncthreads();            // chunk c has landed; every warp is done with chunk c+1
    if (c > 0) load_chunk(c - 1, (p.n_chunks - c) & 1);
    if (warp == 0) chunk_cumsum(dt_s, A, nullptr, e_s, nullptr, lane);
    __syncthreads();
    const float decay = e_s[CH - 1];   // e^cl_last

    // dS = e^cl_last dS + (e^cl * dy)^T C; A = [p rows][i]
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) dS[nt][q] *= decay;
    scan::gemm<N / 8>(dS,
                      scan::elem_a([&](int m, int i) { return dy_s[i * LDK + p0 + m] * e_s[i]; }),
                      scan::elem_b([&](int i, int n) { return C_s[i * LDK + n]; }), 0, CH);
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
constexpr int HSTAGE = 4 * TILE + CH;   // a head's x, dy, S, dS tiles and dt
constexpr int NW = CT / 32;
// B, C, G, M^T, dG tiles; two head stages; cl, e^cl, dec; the partial sums
constexpr int PARTS = 4 * 4 * CH + NW;
constexpr size_t CHUNK_SMEM = (5 * TILE + 2 * HSTAGE + 3 * CH + PARTS) * sizeof(float);

// Sum over the 4 lanes of a row group (t = 0..3) of a warp's accumulator rows, then the
// lane with t = 0 writes (or, with `add`, adds) the two rows' sums to out[m0 + g] and
// out[m0 + g + 8].
__device__ __forceinline__ void row_sums(float lo, float hi, float* out, int m0, int lane,
                                         bool add = false) {
  lo += __shfl_xor_sync(0xffffffffu, lo, 1);
  lo += __shfl_xor_sync(0xffffffffu, lo, 2);
  hi += __shfl_xor_sync(0xffffffffu, hi, 1);
  hi += __shfl_xor_sync(0xffffffffu, hi, 2);
  if ((lane & 3) == 0) {
    float* o = out + m0 + (lane >> 2);
    if (add) lo += o[0], hi += o[8];
    o[0] = lo, o[8] = hi;
  }
}

template <int P, int N>
__global__ void __launch_bounds__(CT, 1) ssd_bwd_chunk_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* B_s = smem;                // [j][n]
  float* C_s = B_s + TILE;          // [i][n]
  float* G_s = C_s + TILE;          // [i][j] C_i . B_j on and below the diagonal blocks
  float* MT_s = G_s + TILE;         // [j][i] (G L)^T (j <= i)
  float* dG_s = MT_s + TILE;        // [i][j] L dy_i . xs_j (j <= i)
  float* hs = dG_s + TILE;          // two stages of a head's x, dy, S, dS, dt
  float* cl_s = hs + 2 * HSTAGE;
  float* e_s = cl_s + CH;           // e^cl
  float* dec_s = e_s + CH;          // e^(cl_last - cl)
  float* rowp = dec_s + CH;         // [4 column quarters][i] sum_j dG_ij G_ij + C . dC_state
  float* colp = rowp + 4 * CH;      // [4 row blocks][j] sum_i dG_ij G_ij
  float* ddt_part = colp + 4 * CH;  // [4][CH] x . dxs
  float* q_part = ddt_part + 4 * CH;    // [4][CH] x . dxs_state
  float* ss_part = q_part + 4 * CH;     // [NW warps] sum S * dS
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.x, b = blockIdx.y, grp = blockIdx.z;
  const int t0 = c * CH, valid = min(CH, p.T - t0);
  const long long row = (long long)p.H * P;
  // this warp: rows mi .. mi+15 (row block rb) and columns n0 .. n0+15 (quarter cq)
  const int rb = warp >> 2, mi = 16 * rb, cq = warp & 3, n0 = 16 * cq;
  const bool p_cols = n0 < P, n_cols = n0 < N;   // this quarter's head and state columns
  const int h_first = grp * HG, h_end = min(p.H, h_first + HG);
  // this warp's 8-column tiles n0 + 8 nt with nt < n_tri lie on or below the diagonal blocks
  const int n_tri = min(2, max(0, (mi + 16 - n0) / 8));

  auto load_head = [&](int h, int stage) {
    float* x_s = hs + stage * HSTAGE;
    const long long xb = (long long)b * p.T * row + h * P;
    const long long sbase = (((long long)b * p.n_chunks + c) * p.H + h) * P * N;
    scan::load_rows<CH, P, LD, CT>(x_s, p.x + xb, row, t0, p.T, tid);
    scan::load_rows<CH, P, LD, CT>(x_s + TILE, p.dy + xb, row, t0, p.T, tid);
    scan::load_rows<P, N, LD, CT>(x_s + 2 * TILE, p.S_chunks + sbase, N, 0, P, tid);
    scan::load_rows<P, N, LD, CT>(x_s + 3 * TILE, p.dS_chunks + sbase, N, 0, P, tid);
    load_dt(x_s + 4 * TILE, p.dt + (long long)b * p.T * p.H + h, p.H, t0, p.T, tid);
    scan::cp_async_commit();
  };

  scan::load_rows<CH, N, LD, CT>(B_s, p.Bm + (long long)b * p.T * N, N, t0, p.T, tid);
  scan::load_rows<CH, N, LD, CT>(C_s, p.Cm + (long long)b * p.T * N, N, t0, p.T, tid);
  scan::cp_async_commit();
  load_head(h_first, 0);
  scan::cp_async_wait<1>();
  __syncthreads();                  // B and C have landed; the first head may still load
  if (n_tri > 0) {
    float acc[2][4] = {};
    scan::gemm<2>(acc, scan::RowsA(C_s, LD, mi), scan::ColsB(B_s, LD, n0), 0, N, n_tri);
    scan::for_each_acc<2>(acc, [&](int m, int n, float v) { G_s[(mi + m) * LD + n0 + n] = v; });
  }

  float dB_acc[2][4] = {}, dC_acc[2][4] = {};     // rows t (mi..), columns n (n0..)
  for (int h = h_first; h < h_end; ++h) {
    const int stage = (h - h_first) & 1;
    const float* x_s = hs + stage * HSTAGE;
    const float* dy_s = x_s + TILE;
    const float* S_s = dy_s + TILE;
    const float* dS_s = S_s + TILE;
    const float* dt_s = dS_s + TILE;
    const float A = p.A[h];
    const long long xb = (long long)b * p.T * row + h * P;
    scan::cp_async_wait<0>();
    __syncthreads();                // head h has landed; every warp is done with head h-1
    if (h + 1 < h_end) load_head(h + 1, stage ^ 1);
    if (warp == 0) chunk_cumsum(dt_s, A, cl_s, e_s, dec_s, lane);
    {
      // the sum of S * dS, element e = tid + CT i at (e / N, e % N)
      static_assert(P * N % CT == 0, "the [P, N] state is a whole number of block passes");
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < P * N / CT; ++i) {
        const int e = tid + CT * i, o = (e / N) * LD + e % N;
        x += S_s[o] * dS_s[o];
      }
      x = warp_sum(x);
      if (lane == 0) ss_part[warp] = x;
    }
    __syncthreads();

    // (1) dyx = dy xs^T on and below the diagonal blocks -> M^T = (G L)^T and dG = L dyx
    //     on j <= i, zeros above; the row and column sums of dG * G
    {
      float acc[2][4] = {};
      if (n_tri > 0)
        scan::gemm<2>(acc, scan::RowsA(dy_s, LD, mi), scan::ColsB(x_s, LD, n0, dt_s + n0), 0, P,
                      n_tri);
      float pr[2] = {0.f, 0.f};
      float pc[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (nt >= n_tri) {
          pc[2 * nt] = pc[2 * nt + 1] = 0.f;
          continue;
        }
        float pcs[2] = {0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = mi + g + 8 * (q >> 1), j = n0 + 8 * nt + 2 * t + (q & 1);
          float M = 0.f, dG = 0.f;
          if (j <= i) {
            const float L = scan::ex(cl_s[i] - cl_s[j]);
            const float G = G_s[i * LD + j];
            M = G * L;
            dG = L * acc[nt][q];
            pr[q >> 1] += dG * G;
            pcs[q & 1] += dG * G;
          }
          MT_s[j * LD + i] = M;
          dG_s[i * LD + j] = dG;
        }
        pc[2 * nt] = pcs[0], pc[2 * nt + 1] = pcs[1];
      }
      row_sums(pr[0], pr[1], rowp + cq * CH, mi, lane);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float v = pc[x];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) colp[rb * CH + n0 + 8 * (x >> 1) + 2 * t + (x & 1)] = v;
      }
    }
    __syncthreads();

    // (2) dxs = M^T dy (over i >= mi) + dec * (B dS^T): dx, and the rows' x . dxs and
    //     x . dxs_state (which dt turns into xs . dxs_state)
    if (p_cols) {
      float acc[2][4] = {}, st[2][4] = {};
      scan::gemm<2>(acc, scan::RowsA(MT_s, LD, mi),
                    scan::elem_b([&](int i, int n) { return dy_s[i * LD + n0 + n]; }), mi, CH);
      scan::gemm<2>(st, scan::RowsA(B_s, LD, mi), scan::ColsB(dS_s, LD, n0), 0, N);
      float sx[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int j = mi + g + 8 * x;
        float* o = p.dx + xb + (long long)(t0 + j) * row + n0 + 2 * t;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int pp = n0 + 8 * nt + 2 * t;
          const float2 xv = *reinterpret_cast<const float2*>(x_s + j * LD + pp);
          const float s0 = dec_s[j] * st[nt][2 * x], s1 = dec_s[j] * st[nt][2 * x + 1];
          const float d0 = acc[nt][2 * x] + s0, d1 = acc[nt][2 * x + 1] + s1;
          sx[x] += xv.x * d0 + xv.y * d1;
          sq[x] += xv.x * s0 + xv.y * s1;
          if (j < valid)
            *reinterpret_cast<float2*>(o + 8 * nt) = make_float2(dt_s[j] * d0, dt_s[j] * d1);
        }
      }
      row_sums(sx[0], sx[1], ddt_part + cq * CH, mi, lane);
      row_sums(sq[0], sq[1], q_part + cq * CH, mi, lane);
    } else {
      row_sums(0.f, 0.f, ddt_part + cq * CH, mi, lane);
      row_sums(0.f, 0.f, q_part + cq * CH, mi, lane);
    }

    // (3) dC += e^cl * (dy S) + dG B (over j < mi + 16), and the rows' C . e^cl (dy S),
    //     added to this warp's row sums of dG * G
    if (n_cols) {
      float acc[2][4] = {};
      scan::gemm<2>(acc, scan::RowsA(dy_s, LD, mi),
                    scan::elem_b([&](int pp, int n) { return S_s[pp * LD + n0 + n]; }), 0, P);
      float rr[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = mi + g + 8 * (q >> 1), n = n0 + 8 * nt + 2 * t + (q & 1);
          const float v = acc[nt][q] * e_s[i];
          rr[q >> 1] += C_s[i * LD + n] * v;
          dC_acc[nt][q] += v;
        }
      row_sums(rr[0], rr[1], rowp + cq * CH, mi, lane, true);
      scan::gemm<2>(dC_acc, scan::RowsA(dG_s, LD, mi),
                    scan::elem_b([&](int j, int n) { return B_s[j * LD + n0 + n]; }), 0, mi + 16);
    }

    // (4) dB += dG^T C (over i >= mi) + dec * (xs dS)
    if (n_cols) {
      scan::gemm<2>(dB_acc, scan::elem_a([&](int m, int i) { return dG_s[i * LD + mi + m]; }),
                    scan::elem_b([&](int i, int n) { return C_s[i * LD + n0 + n]; }), mi, CH);
      float acc[2][4] = {};
      scan::gemm<2>(acc, scan::RowsA(x_s, LD, mi, dt_s + mi),
                    scan::elem_b([&](int pp, int n) { return dS_s[pp * LD + n0 + n]; }), 0, P);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = mi + g + 8 * (q >> 1);
          dB_acc[nt][q] += dec_s[j] * acc[nt][q];
        }
    }
    __syncthreads();

    // (5) one warp: dcl per row from the partial sums, da = the reverse cumsum of dcl plus
    //     the chunk's last-row terms (a shuffle scan, two rows a lane), ddt and dA's partial
    if (warp == 0) {
      auto quarters = [&](const float* a, int i) {
        return (a[i] + a[CH + i]) + (a[2 * CH + i] + a[3 * CH + i]);
      };
      float dcl[2], qd[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int i = 2 * lane + x;
        qd[x] = dt_s[i] * quarters(q_part, i);
        dcl[x] = quarters(rowp, i) - quarters(colp, i) - qd[x];
      }
      float ss = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) ss += ss_part[w];
      const float last = ss * e_s[CH - 1] + warp_sum(qd[0] + qd[1]);
      float incl = dcl[0] + dcl[1];    // this lane's rows and every later lane's
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += o;
      }
      float after = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) after = 0.f;
      const float da1 = last + after + dcl[1], da0 = da1 + dcl[0];
      const float da[2] = {da0, da1};
      float dA = 0.f;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int m = 2 * lane + x;
        if (m < valid)
          p.ddt[((long long)b * p.T + t0 + m) * p.H + h] = quarters(ddt_part, m) + A * da[x];
        dA += dt_s[m] * da[x];
      }
      dA = warp_sum(dA);
      if (lane == 0) p.dA_part[((long long)b * p.n_chunks + c) * p.H + h] = dA;
    }
  }

  // this group's dB and dC rows
  if (!n_cols) return;
  const long long pb = (((long long)b * p.n_groups + grp) * p.T + t0) * N;
  const long long pc = pb + (long long)p.Bt * p.n_groups * p.T * N;
  scan::for_each_acc<2>(dB_acc, [&](int m, int n, float v) {
    if (mi + m < valid) p.dBC_part[pb + (long long)(mi + m) * N + n0 + n] = v;
  });
  scan::for_each_acc<2>(dC_acc, [&](int m, int n, float v) {
    if (mi + m < valid) p.dBC_part[pc + (long long)(mi + m) * N + n0 + n] = v;
  });
}

// ------------------------------------------------------------------ (c) sums over groups

// dB[b][t][n], dC[b][t][n] = sums over the head groups, in a fixed order; a block of 256
// threads per (256 / N rows, batch)
template <int N>
__global__ void ssd_bwd_reduce_kernel(const Params p) {
  const int t = blockIdx.x * (256 / N) + threadIdx.x / N, n = threadIdx.x % N, b = blockIdx.y;
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

template <int P, int N>
int occupancy(int kernel, int* threads, int* smem, int* blocks_per_sm) {
  using Sh = Shape<P, N>;
  cudaError_t err = cudaErrorInvalidValue;
  if (kernel == 0) {
    *threads = Sh::ST_THREADS, *smem = (int)Sh::ST_SMEM;
    if ((err = scan::prepare_smem(ssd_bwd_state_kernel<P, N>, Sh::ST_SMEM)) == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, ssd_bwd_state_kernel<P, N>, Sh::ST_THREADS, Sh::ST_SMEM);
  } else if (kernel == 1) {
    *threads = CT, *smem = (int)CHUNK_SMEM;
    if ((err = scan::prepare_smem(ssd_bwd_chunk_kernel<P, N>, CHUNK_SMEM)) == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, ssd_bwd_chunk_kernel<P, N>, CT, CHUNK_SMEM);
  } else if (kernel == 2) {
    *threads = 256, *smem = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ssd_bwd_reduce_kernel<N>,
                                                        256, 0);
  } else if (kernel == 3) {
    *threads = 128, *smem = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ssd_bwd_dA_reduce_kernel,
                                                        128, 0);
  }
  return err;
}

template <int P, int N>
int launch(const Params& p, cudaStream_t st) {
  using Sh = Shape<P, N>;
  cudaError_t err = scan::prepare_smem(ssd_bwd_state_kernel<P, N>, Sh::ST_SMEM);
  if (err != cudaSuccess) return err;
  ssd_bwd_state_kernel<P, N><<<p.Bt * p.H, Sh::ST_THREADS, Sh::ST_SMEM, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = scan::prepare_smem(ssd_bwd_chunk_kernel<P, N>, CHUNK_SMEM)) != cudaSuccess)
    return err;
  ssd_bwd_chunk_kernel<P, N><<<dim3(p.n_chunks, p.Bt, p.n_groups), CT, CHUNK_SMEM, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_reduce_kernel<N><<<dim3((p.T + 256 / N - 1) / (256 / N), p.Bt), 256, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dA_reduce_kernel<<<(p.H + 127) / 128, 128, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the workspace ssd_bwd needs: dS at every 64-row chunk, dB and dC summed per
// group of 8 heads, and dA's partials.
long long ssd_bwd_workspace_floats(int Bt, int T, int H, int P, int N) {
  const long long nc = (T + CH - 1) / CH, groups = (H + HG - 1) / HG;
  return (long long)Bt * nc * H * P * N + 2LL * Bt * groups * T * N + (long long)Bt * nc * H;
}

// Per kernel of ssd_bwd at sizes (P, N) (0 the state pass, 1 the chunk pass, 2 the dB and
// dC sums, 3 dA's sum): the threads of a block, the dynamic shared memory a block takes,
// and how many blocks an SM holds.  Returns a cudaError_t.
int ssd_bwd_occupancy(int P, int N, int kernel, int* threads, int* smem, int* blocks_per_sm) {
  if (P == 64 && N == 64) return occupancy<64, 64>(kernel, threads, smem, blocks_per_sm);
  if (P == 32 && N == 16) return occupancy<32, 16>(kernel, threads, smem, blocks_per_sm);
  return cudaErrorInvalidValue;
}

// Returns a cudaError_t: 0 when the four kernels were launched.  All tensors are contiguous
// fp32; (P, N) = (64, 64) or (32, 16) and chunk 128 (the forward's; this walks 64 rows at
// a time) are the compiled sizes, any other is refused; S_chunks is what ssd_fwd writes
// to s_chunks; ds_out may be null (zero); `work` holds ssd_bwd_workspace_floats(Bt, T, H,
// P, N) floats.
int ssd_bwd(const float* x, const float* dt, const float* A, const float* Bm, const float* Cm,
            const float* S_chunks, const float* dy, const float* ds_out, float* dx, float* ddt,
            float* dA, float* dB, float* dC, float* ds0, int Bt, int T, int H, int P, int N,
            int chunk, void* work, void* stream) {
  if (chunk != 128 || T <= 0) return cudaErrorInvalidValue;
  const int n_chunks = (T + CH - 1) / CH, n_groups = (H + HG - 1) / HG;
  float* ws = static_cast<float*>(work);
  float* dS_chunks = ws;
  float* dBC_part = dS_chunks + (long long)Bt * n_chunks * H * P * N;
  float* dA_part = dBC_part + 2LL * Bt * n_groups * T * N;
  const Params p{x,  dt,  A,  Bm,        Cm,       S_chunks, dy, ds_out,   dx,      ddt,
                 dA, dB,  dC, ds0,       dS_chunks, dBC_part, dA_part, Bt, T, H, n_chunks,
                 n_groups};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 64) return launch<64, 64>(p, st);
  if (P == 32 && N == 16) return launch<32, 16>(p, st);
  return cudaErrorInvalidValue;
}

const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
