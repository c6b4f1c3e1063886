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
// What bounds it on an H100 (SXM, published peaks at a 700 W power limit), at rwkv6-1.6b's
// training shape (B=2, T=2048, H=32, K=V=64, 2048 chunks of 64 rows):
//   * bytes: it reads r, k, v, w, dy and writes dr, dk, dv, dw, 0.30 GB (0.091 ms at
//     3.35 TB/s); its workspace adds 0.10 GB: dS of every chunk written by the state pass
//     and read by the chunk pass (33.5 MB each way) and the forward's chunk states read
//     (33.5 MB), which puts its byte floor near 0.12 ms;
//   * tensor cores: 1472 m16n8k8 products a chunk in the chunk pass (dy v^T and dy S^T on
//     and below the diagonal, v dS^T, (k 2^(cl_last - cl)) dS, att, att^T dy and datt's
//     factored terms of dr and dk) and 256 in the state pass, each run as 3 TF32 passes
//     (3xTF32): 2.2e10 tensor-core flops, 0.045 ms at the 495 TFLOP/s TF32 rate, more at
//     the rate mma.sync reaches;
//   * exponentials: about 9e4 a chunk (1.9e8 a call, most of them the 8 x 8 diagonal
//     sub-blocks', each evaluated twice), 0.05 ms at the special-function unit's 16 a
//     clock and SM.
// So no one floor dominates.  On an H100 80GB HBM3 at 700 W the chunk pass ran only a
// little faster with one TF32 pass in place of three, or with no operand split
// (diagnostic builds, wrong results): most of its time is the exponentials, the diagonal
// sub-blocks' sums on the CUDA cores and the latency of 16 warps an SM.  The design keeps
// all three in flight:
//   * three kernels, one call: a reverse state pass (one block per (batch, head, 32 value
//     columns): 128 blocks, the fastest of 16, 32 and 64 columns) walks the chunks from
//     the last with a 2-stage cp.async ring, writes each chunk's dS to a workspace
//     [B, n_chunks, H, K, V] and ends with ds0; a chunk pass (one 8-warp block per (batch,
//     head, chunk), all independent, two an SM: six 64 x 64 tiles, 110.6 KB) computes
//     every input gradient of the chunk from S, dS and dy; a last small kernel sums du's
//     per-chunk partials in a fixed order;
//   * the chunk pass's decay-weighted sums over (i, j, k) run on the tensor cores,
//     factored through reference rows as the forward's att is.  In log2 units, for 16-row
//     blocks I, J, ref_I = clp at I's first row and ref'_J = cl at J's last row:
//       att_IJ = (r_I 2^(clp_I - ref_I)) (k_J 2^(ref_I - cl_J))^T                  J < I
//       dr_I  += 2^(clp_I - ref_I) (datt_IJ (k_J 2^(ref_I - cl_J)))                J < I
//       dk_J  += 2^(ref'_J - cl_J) (datt_IJ^T (r_I 2^(clp_I - ref'_J)))            I > J
//     and each 16 x 16 diagonal block the same way through its middle row.  Every
//     exponent is <= 0 for w <= 1, so no factor overflows, a factor underflows only where
//     the exact decay already lies under fp32's range, and no inf * 0 appears.  Only the
//     eight 8 x 8 diagonal sub-blocks keep one exponential per (i, j < i, k), computed in
//     the accumulator layout of dr and dk, whose lanes also sum att's pairs there;
//   * each warp holds its 16 rows x 32 keys of dr and dk (and of dv) in registers from
//     the first product to the store; dlog w's reverse cumsum runs on every thread, a
//     shuffle scan across row groups as the forward's log-decay cumsum;
//   * the chunk pass reuses its tiles: dy, v, S, dS and w are loaded first; once dy v^T,
//     dy S^T, v dS^T and the row sums of S * dS are formed, r and k load into v's and S's
//     tiles (the log-decay cumsum runs meanwhile), att^T takes dS's tile, and dlog w's
//     terms take dy's and att^T's;
//   * operands read along rows load a fragment with one ldmatrix (scan::RowsA, ColsB);
//   * exponentials on the special-function unit (ex2.approx.ftz), in log2 units;
//   * the ragged last chunk is masked (rows past T read as r = k = v = dy = 0, w = 1) and
//     not written;
//   * no atomics and a fixed order of every sum: reruns are bit-identical.
// The head size D = K = V is a template parameter, instantiated for 64 and for the reduced
// configs' 32 and chosen by the extern "C" entry.  At D = 32 the state pass splits its
// warps as the forward's does, and each chunk-pass warp holds 16 keys (two 8-column tiles)
// in place of 32; the chunk pass's tiles keep rows of 68 floats, since datt and att^T are
// [64][64] whatever D is.

#include <cuda_runtime.h>

#include "scan_sm90.cuh"

namespace {

constexpr int CH = 64;                          // rows per chunk
constexpr int VT = 32;                          // value columns of one state-pass block
constexpr int ST_THREADS = 128;
constexpr int CT = 256;                         // chunk-pass threads: 8 warps
constexpr int LDV = VT + 8;
constexpr int LD = CH + 4;                      // chunk pass: [64][D] and [64][64] tiles

// The state pass's strides and warp split for head size D = K = V (32 or 64), as in the
// forward: KR 16-row key blocks, each warp WV of the block's VT value columns; the chunk
// pass's keys (or value columns) a warp, NTW 8-column tiles.
template <int D>
struct Shape {
  static_assert(D % 32 == 0 && D <= 64, "D is 32 or 64");
  static constexpr int LDK = D + 8;
  static constexpr int KR = D / 16;
  static constexpr int WV = VT * KR / 4;
  static constexpr int ST_STAGE = 2 * CH * LDK + CH * LDV;    // r, w (then cl), dy
  static constexpr size_t ST_SMEM = 2 * ST_STAGE * sizeof(float);
  static constexpr int NTW = D / 16;
  // u, S.dS; k.x2; att's diagonal
  static constexpr int SMALL = 2 * D + 4 * D + 2 * CH * 8 + 2 * CH;
  static constexpr size_t CHUNK_SMEM = (6 * CH * LD + SMALL) * sizeof(float);
};

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

template <int D>
__global__ void __launch_bounds__(ST_THREADS, 2) wkv6_bwd_state_kernel(const Params p) {
  using Sh = Shape<D>;
  constexpr int LDK = Sh::LDK, ST_STAGE = Sh::ST_STAGE, NTW = Sh::WV / 8;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int v0 = blockIdx.x * VT, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const long long row = (long long)p.H * D;
  const long long base = (long long)b * p.T * row + (long long)h * D;
  const int m0 = 16 * (warp % Sh::KR);         // this warp's key rows
  const int vw = Sh::WV * (warp / Sh::KR);     // and its value columns, from v0

  auto load_chunk = [&](int c, int stage) {
    float* r_s = smem + stage * ST_STAGE;
    const int t0 = c * CH;
    scan::load_rows<CH, D, LDK, ST_THREADS>(r_s, p.r + base, row, t0, p.T, tid);
    scan::load_rows<CH, D, LDK, ST_THREADS>(r_s + CH * LDK, p.w + base, row, t0, p.T, tid);
    scan::load_rows<CH, VT, LDV, ST_THREADS>(r_s + 2 * CH * LDK, p.dy + base + v0, row, t0,
                                             p.T, tid);
    scan::cp_async_commit();
  };

  // dS[m0 .. m0+15][v0 + vw .. v0 + vw + WV) as NTW accumulator tiles
  float dS[NTW][4];
  const long long sidx = (long long)bh * D * D + v0 + vw;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    float2 a = make_float2(0.f, 0.f), c = a;
    if (p.ds_out) {
      const float* s = p.ds_out + sidx + (m0 + g) * D + 8 * nt + 2 * t;
      a = *reinterpret_cast<const float2*>(s);
      c = *reinterpret_cast<const float2*>(s + 8 * D);
    }
    dS[nt][0] = a.x, dS[nt][1] = a.y, dS[nt][2] = c.x, dS[nt][3] = c.y;
  }

  load_chunk(p.n_chunks - 1, 0);
  for (int c = p.n_chunks - 1; c >= 0; --c) {
    float* r_s = smem + ((p.n_chunks - 1 - c) & 1) * ST_STAGE;
    float* cl_s = r_s + CH * LDK;
    const float* dy_s = cl_s + CH * LDK;
    {
      float* out = p.dS_chunks + (((long long)b * p.n_chunks + c) * p.H + h) * D * D + v0 + vw;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        float* s = out + (m0 + g) * D + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(s) = make_float2(dS[nt][0], dS[nt][1]);
        *reinterpret_cast<float2*>(s + 8 * D) = make_float2(dS[nt][2], dS[nt][3]);
      }
    }
    scan::cp_async_wait<0>();
    __syncthreads();            // chunk c has landed; every warp is done with chunk c+1
    if (c > 0) load_chunk(c - 1, (p.n_chunks - c) & 1);
    scan::log2_cumsum<LDK, ST_THREADS, D>(cl_s, p.T - c * CH, tid);
    __syncthreads();

    // dS = 2^cl_last * dS + Q^T dy, Q_ik = r_ik 2^clp_ik; A = Q^T [key rows][i]
    const float d0 = scan::ex2(cl_s[(CH - 1) * LDK + m0 + g]);
    const float d1 = scan::ex2(cl_s[(CH - 1) * LDK + m0 + g + 8]);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      dS[nt][0] *= d0, dS[nt][1] *= d0;
      dS[nt][2] *= d1, dS[nt][3] *= d1;
    }
    scan::gemm<NTW>(dS, scan::elem_a([&](int m, int i) {
                         const int kk = m0 + m;
                         return r_s[i * LDK + kk] * (i ? scan::ex2(cl_s[(i - 1) * LDK + kk]) : 1.f);
                       }),
                       scan::elem_b([&](int i, int n) { return dy_s[i * LDV + vw + n]; }), 0, CH);
  }

#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    float* s = p.ds0 + sidx + (m0 + g) * D + 8 * nt + 2 * t;
    *reinterpret_cast<float2*>(s) = make_float2(dS[nt][0], dS[nt][1]);
    *reinterpret_cast<float2*>(s + 8 * D) = make_float2(dS[nt][2], dS[nt][3]);
  }
}

// ------------------------------------------------------------------ (b) chunk pass

constexpr int TILE = CH * LD;

template <int D>
__global__ void __launch_bounds__(CT, 2) wkv6_bwd_chunk_kernel(const Params p) {
  constexpr int NTW = Shape<D>::NTW, X = 2 * NTW;   // a warp's key tiles, and keys a lane
  extern __shared__ __align__(16) float smem[];
  float* dy_s = smem;                // [i][v], then dclp [i][k]
  float* v_s = dy_s + TILE;          // [j][v], then r [i][k]
  float* S_s = v_s + TILE;           // [k][v] the chunk's initial state, then k [j][k]
  float* dS_s = S_s + TILE;          // [k][v] the gradient of its final state, then
                                     // att^T [j][i], then dcl [j][k]
  float* datt_s = dS_s + TILE;       // [i][j] dy_i . v_j, on and below the diagonal blocks
  float* cl_s = datt_s + TILE;       // w, then the inclusive log2 cumsum
  float* u_s = cl_s + TILE;          // [k]
  float* sds_s = u_s + D;            // [k] sum_v S * dS
  float* kx2_s = sds_s + D;          // [4 row blocks][k] column sums of k * x2
  float* adg_s = kx2_s + 4 * D;      // [2 key halves][i][8] att's 8 x 8 diagonal pairs
  float* bon_s = adg_s + 2 * CH * 8; // [2 key halves][i] the u bonus
  float* r_s = v_s;
  float* k_s = S_s;
  float* attT_s = dS_s;
  float* dclp_s = dy_s;
  float* dcl_s = dS_s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int t0 = c * CH, valid = min(CH, p.T - t0);
  const long long row = (long long)p.H * D;
  const long long base = (long long)b * p.T * row + (long long)h * D;
  const long long sbase = (((long long)b * p.n_chunks + c) * p.H + h) * D * D;
  // this warp: rows i0 .. i0+15 (row block R) and keys (or value columns) n0 .. n0+D/2-1
  const int R = warp >> 1, hf = warp & 1, i0 = 16 * R, n0 = (D / 2) * hf;

  scan::load_rows<CH, D, LD, CT>(dy_s, p.dy + base, row, t0, p.T, tid);
  scan::load_rows<CH, D, LD, CT>(v_s, p.v + base, row, t0, p.T, tid);
  scan::load_rows<D, D, LD, CT>(S_s, p.S_chunks + sbase, D, 0, D, tid);
  scan::load_rows<D, D, LD, CT>(dS_s, p.dS_chunks + sbase, D, 0, D, tid);
  scan::load_rows<CH, D, LD, CT>(cl_s, p.w + base, row, t0, p.T, tid);
  scan::cp_async_commit();
  if (tid < D) u_s[tid] = p.u[(long long)h * D + tid];
  scan::cp_async_wait<0>();
  __syncthreads();

  // (1) datt = dy v^T on and below the diagonal blocks (this warp: the 8-column tiles
  //     2q + hf, q <= R, of row block R), x1 = dy S^T and x2 = v dS^T (keys n0..), the
  //     row sums of S * dS
  float x1[NTW][4] = {}, x2[NTW][4] = {};
  {
    float acc[4][4] = {};
    const scan::RowsA dy_rows(dy_s, LD, i0);
    const scan::ColsB vt(v_s, LD, 8 * hf), st(S_s, LD, n0);
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 8) {
      const scan::FragA a = dy_rows(k0);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q <= R) scan::mma(acc[q], a, vt(k0, 2 * q));
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) scan::mma(x1[nt], a, st(k0, nt));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q > R) continue;
      float* o = datt_s + (i0 + g) * LD + 8 * (2 * q + hf) + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(acc[q][0], acc[q][1]);
      *reinterpret_cast<float2*>(o + 8 * LD) = make_float2(acc[q][2], acc[q][3]);
    }
  }
  scan::gemm<NTW>(x2, scan::RowsA(v_s, LD, i0), scan::ColsB(dS_s, LD, n0), 0, D);
  if (tid < 4 * D) {                 // warp-uniform
    const int kk = tid >> 2, q = tid & 3;
    float x = 0.f;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) x += S_s[kk * LD + q + 4 * i] * dS_s[kk * LD + q + 4 * i];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (q == 0) sds_s[kk] = x;
  }
  __syncthreads();                   // v and S are read: r and k take their tiles
  scan::load_rows<CH, D, LD, CT>(r_s, p.r + base, row, t0, p.T, tid);
  scan::load_rows<CH, D, LD, CT>(k_s, p.k + base, row, t0, p.T, tid);
  scan::cp_async_commit();
  scan::log2_cumsum<LD, CT, D>(cl_s, valid, tid);
  scan::cp_async_wait<0>();
  __syncthreads();

  const float* clL = cl_s + (CH - 1) * LD;     // cl at the chunk's last row
  auto clp = [&](int i, int kk) { return i ? cl_s[(i - 1) * LD + kk] : 0.f; };
  // accumulator slot (nt, q) of this warp: row i0 + g + 8 (q >> 1), key n0 + key_of(nt, q)
  auto key_of = [&](int nt, int q) { return n0 + 8 * nt + 2 * t + (q & 1); };

  // (2) x1 = 2^clp * (dy S^T), x2 = 2^(cl_last - cl) * (v dS^T); the column sums of k * x2
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + g + 8 * (q >> 1), kk = key_of(nt, q);
      x1[nt][q] *= scan::ex2(clp(i, kk));
      x2[nt][q] *= scan::ex2(clL[kk] - cl_s[i * LD + kk]);
    }
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kk = key_of(nt, e);
      float x = k_s[(i0 + g) * LD + kk] * x2[nt][e] + k_s[(i0 + g + 8) * LD + kk] * x2[nt][2 + e];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (g == 0) kx2_s[R * D + kk] = x;
    }

  // (3) the two 8 x 8 diagonal sub-blocks of row block R, one exponential per (i, j < i,
  //     key): a lane's row rho takes datt's terms of dr from the rows j < rho of its
  //     sub-block and of dk from the rows i > rho, into x1 and x2; att's pairs and the u
  //     bonus are summed over this warp's D/2 keys
#pragma unroll
  for (int hb = 0; hb < 2; ++hb) {
    const int s0 = i0 + 8 * hb, rho = s0 + g;
    float own_cl[X], own_clp[X], own_r[X];
    float bonus = 0.f;
#pragma unroll
    for (int x = 0; x < X; ++x) {
      const int kk = key_of(x >> 1, x);
      own_cl[x] = cl_s[rho * LD + kk];
      own_clp[x] = clp(rho, kk);
      own_r[x] = r_s[rho * LD + kk];
      bonus += own_r[x] * u_s[kk] * k_s[rho * LD + kk];
    }
#pragma unroll 1
    for (int o = 0; o < 8; ++o) {
      const int sig = s0 + o;
      const bool lo = o < g, hi = o > g;
      const float cdr = lo ? datt_s[rho * LD + sig] : 0.f;
      const float cdk = hi ? datt_s[sig * LD + rho] : 0.f;
      float pair = 0.f;
#pragma unroll
      for (int x = 0; x < X; ++x) {
        const int kk = key_of(x >> 1, x);
        const float ks = k_s[sig * LD + kk];
        const float ex = scan::ex2(
            fminf(lo ? own_clp[x] - cl_s[sig * LD + kk] : clp(sig, kk) - own_cl[x], 0.f));
        x1[x >> 1][2 * hb + (x & 1)] += cdr * (ks * ex);
        x2[x >> 1][2 * hb + (x & 1)] += cdk * (r_s[sig * LD + kk] * ex);
        pair += own_r[x] * (ks * ex);
      }
      pair = lo ? pair : 0.f;
      pair += __shfl_xor_sync(0xffffffffu, pair, 1);
      pair += __shfl_xor_sync(0xffffffffu, pair, 2);
      if (t == 0) adg_s[(hf * CH + rho) * 8 + o] = pair;
    }
    bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
    bonus += __shfl_xor_sync(0xffffffffu, bonus, 2);
    if (t == 0) bon_s[hf * CH + rho] = bonus;
  }

  // (4) att of the earlier row blocks J < R (this warp: the 8-column tiles 2q + hf,
  //     q < R) through ref = clp at row i0; and, by the warps hf = 1, the diagonal
  //     block's lower-left 8 x 8 (rows i0+8.., keys j = i0 .. i0+7) through clp at i0+8
  float att[3][4] = {}, low[4] = {};
  if (R > 0) {
    const float* ref = cl_s + (i0 - 1) * LD;
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 8) {
      const int ka = k0 + t, kb = ka + 4, ia = i0 + g, ib = ia + 8;
      const float f0 = ref[ka], f1 = ref[kb];
      const scan::FragA a =
          scan::frag_a(r_s[ia * LD + ka] * scan::ex2(cl_s[(ia - 1) * LD + ka] - f0),
                       r_s[ib * LD + ka] * scan::ex2(cl_s[(ib - 1) * LD + ka] - f0),
                       r_s[ia * LD + kb] * scan::ex2(cl_s[(ia - 1) * LD + kb] - f1),
                       r_s[ib * LD + kb] * scan::ex2(cl_s[(ib - 1) * LD + kb] - f1));
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (q >= R) continue;
        const int o = (8 * (2 * q + hf) + g) * LD;
        scan::mma(att[q], a, scan::frag_b(k_s[o + ka] * scan::ex2(f0 - cl_s[o + ka]),
                                          k_s[o + kb] * scan::ex2(f1 - cl_s[o + kb])));
      }
    }
  }
  if (hf == 1) {
    const float* ref = cl_s + (i0 + 7) * LD;
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 8) {
      const int ka = k0 + t, kb = ka + 4, ib = i0 + 8 + g, o = (i0 + g) * LD;
      const scan::FragA a =
          scan::frag_a(0.f, r_s[ib * LD + ka] * scan::ex2(cl_s[(ib - 1) * LD + ka] - ref[ka]), 0.f,
                       r_s[ib * LD + kb] * scan::ex2(cl_s[(ib - 1) * LD + kb] - ref[kb]));
      scan::mma(low, a, scan::frag_b(k_s[o + ka] * scan::ex2(ref[ka] - cl_s[o + ka]),
                                     k_s[o + kb] * scan::ex2(ref[kb] - cl_s[o + kb])));
    }
  }

  // (5) dv = (k 2^(cl_last - cl)) dS (value columns n0..)
  float dv[NTW][4] = {};
  scan::gemm<NTW>(dv, scan::elem_a([&](int m, int kk) {
                  const int j = i0 + m;
                  return k_s[j * LD + kk] * scan::ex2(clL[kk] - cl_s[j * LD + kk]);
                }),
                scan::elem_b([&](int kk, int n) { return dS_s[kk * LD + n0 + n]; }), 0, D);
  __syncthreads();                   // dS and adg are complete and read: att^T takes dS's tile

  // (6) att^T [j][i]: the earlier blocks, then the diagonal block: its 8 x 8 diagonal
  //     sub-blocks (pairs, the u bonus, zeros above) and the lower-left 8 x 8 (hf = 1)
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (q >= R) continue;
#pragma unroll
    for (int x = 0; x < 4; ++x)
      attT_s[(8 * (2 * q + hf) + 2 * t + (x & 1)) * LD + i0 + g + 8 * (x >> 1)] = att[q][x];
  }
  {
    const int i = i0 + 8 * hf + g;             // hf = 0: sub-block a's rows; 1: b's
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = 2 * t + e;
      const float pair = adg_s[i * 8 + o] + adg_s[(CH + i) * 8 + o];
      attT_s[(i0 + 8 * hf + o) * LD + i] =
          o < g ? pair : (o == g ? bon_s[i] + bon_s[CH + i] : 0.f);
      if (hf == 0)
        attT_s[(i0 + 8 + o) * LD + i] = 0.f;   // j in sub-block b, i in a: above the diagonal
      else
        attT_s[(i0 + o) * LD + i] = low[2 + e];
    }
  }
  __syncthreads();

  // (7) dv += att^T dy over i >= i0 (att_ij = 0 for i < j); dv out
  scan::gemm<NTW>(dv, scan::RowsA(attT_s, LD, i0),
                scan::elem_b([&](int i, int n) { return dy_s[i * LD + n0 + n]; }), i0, CH);
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int j = i0 + g + 8 * x;
    if (j >= valid) continue;
    float* o = p.dv + base + (long long)(t0 + j) * row + n0 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
      *reinterpret_cast<float2*>(o + 8 * nt) = make_float2(dv[nt][2 * x], dv[nt][2 * x + 1]);
  }

  // (8) dr's datt terms: rows i0.. from the earlier blocks through ref = clp at row i0,
  //     then rows i0+8.. from rows i0 .. i0+7 through clp at row i0+8
  if (R > 0) {
    const float* ref = cl_s + (i0 - 1) * LD;
    float acc[NTW][4] = {};
    scan::gemm<NTW>(acc, scan::RowsA(datt_s, LD, i0), scan::elem_b([&](int j, int n) {
                    const int kk = n0 + n;
                    return k_s[j * LD + kk] * scan::ex2(ref[kk] - cl_s[j * LD + kk]);
                  }),
                  0, i0);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + g + 8 * (q >> 1), kk = key_of(nt, q);
        x1[nt][q] += scan::ex2(cl_s[(i - 1) * LD + kk] - ref[kk]) * acc[nt][q];
      }
  }
  {
    const float* ref = cl_s + (i0 + 7) * LD;
    const float* da = datt_s + (i0 + 8 + g) * LD + i0 + t;
    const scan::FragA a = scan::frag_a(0.f, da[0], 0.f, da[4]);
    float acc[NTW][4] = {};
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int kk = n0 + 8 * nt + g, o0 = (i0 + t) * LD + kk, o1 = o0 + 4 * LD;
      scan::mma(acc[nt], a, scan::frag_b(k_s[o0] * scan::ex2(ref[kk] - cl_s[o0]),
                                         k_s[o1] * scan::ex2(ref[kk] - cl_s[o1])));
    }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int q = 2; q < 4; ++q) {
        const int i = i0 + 8 + g, kk = key_of(nt, q);
        x1[nt][q] += scan::ex2(cl_s[(i - 1) * LD + kk] - ref[kk]) * acc[nt][q];
      }
  }

  // (9) dk's datt terms: rows i0.. from the later blocks through ref' = cl at row i0+15,
  //     then rows i0 .. i0+7 from rows i0+8 .. i0+15 through cl at row i0+7
  if (R < 3) {
    const float* ref = cl_s + (i0 + 15) * LD;
    float acc[NTW][4] = {};
    scan::gemm<NTW>(acc, scan::elem_a([&](int m, int i) { return datt_s[i * LD + i0 + m]; }),
                  scan::elem_b([&](int i, int n) {
                    const int kk = n0 + n;
                    return r_s[i * LD + kk] * scan::ex2(cl_s[(i - 1) * LD + kk] - ref[kk]);
                  }),
                  i0 + 16, CH);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = i0 + g + 8 * (q >> 1), kk = key_of(nt, q);
        x2[nt][q] += scan::ex2(ref[kk] - cl_s[j * LD + kk]) * acc[nt][q];
      }
  }
  {
    const float* ref = cl_s + (i0 + 7) * LD;
    const float* da = datt_s + (i0 + 8 + t) * LD + i0 + g;
    const scan::FragA a = scan::frag_a(da[0], 0.f, da[4 * LD], 0.f);
    float acc[NTW][4] = {};
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int kk = n0 + 8 * nt + g, o0 = (i0 + 8 + t) * LD + kk, o1 = o0 + 4 * LD;
      scan::mma(acc[nt], a, scan::frag_b(r_s[o0] * scan::ex2(cl_s[o0 - LD] - ref[kk]),
                                         r_s[o1] * scan::ex2(cl_s[o1 - LD] - ref[kk])));
    }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = i0 + g, kk = key_of(nt, q);
        x2[nt][q] += scan::ex2(ref[kk] - cl_s[j * LD + kk]) * acc[nt][q];
      }
  }
  __syncthreads();                   // dy and att^T are read: dclp and dcl take their tiles

  // (10) dr = x1 + datt_ii u k_i, dk = x2 + datt_jj u r_j; dclp = r x1, dcl = -k x2
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int i = i0 + g + 8 * x;
    const float dd = datt_s[i * LD + i];
    float* odr = p.dr + base + (long long)(t0 + i) * row + n0 + 2 * t;
    float* odk = p.dk + base + (long long)(t0 + i) * row + n0 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int kk = n0 + 8 * nt + 2 * t;
      const float2 rr = *reinterpret_cast<const float2*>(r_s + i * LD + kk);
      const float2 kq = *reinterpret_cast<const float2*>(k_s + i * LD + kk);
      const float2 uu = *reinterpret_cast<const float2*>(u_s + kk);
      const float a0 = x1[nt][2 * x], a1 = x1[nt][2 * x + 1];
      const float b0 = x2[nt][2 * x], b1 = x2[nt][2 * x + 1];
      *reinterpret_cast<float2*>(dclp_s + i * LD + kk) = make_float2(rr.x * a0, rr.y * a1);
      *reinterpret_cast<float2*>(dcl_s + i * LD + kk) = make_float2(-kq.x * b0, -kq.y * b1);
      if (i < valid) {
        *reinterpret_cast<float2*>(odr + 8 * nt) =
            make_float2(a0 + dd * uu.x * kq.x, a1 + dd * uu.y * kq.y);
        *reinterpret_cast<float2*>(odk + 8 * nt) =
            make_float2(b0 + dd * uu.x * rr.x, b1 + dd * uu.y * rr.y);
      }
    }
  }
  __syncthreads();

  // (11) per key column: dlog w_m = last + sum_{i >= m} dcl_i + sum_{i > m} dclp_i, with
  //      last = 2^cl_last sum_v S dS + sum_j k_j x2_j (the terms of the chunk's last
  //      row); dw, and du's partial.  Lane (rg, cs) of a warp takes rows 16 rg .. 16 rg +
  //      15 of column 8 warp + cs; a shuffle scan joins the four row groups
  if (8 * warp < D) {                // warp-uniform
    const int rg = lane >> 3, kk = 8 * warp + (lane & 7), r0 = 16 * rg;
    float a_cl[16], a_clp[16];
    float tot_cl = 0.f, tot_clp = 0.f, du = 0.f;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int m = r0 + q;
      a_cl[q] = dcl_s[m * LD + kk];
      a_clp[q] = dclp_s[m * LD + kk];
      tot_cl += a_cl[q];
      tot_clp += a_clp[q];
      du += datt_s[m * LD + m] * r_s[m * LD + kk] * k_s[m * LD + kk];
    }
    float in_cl = tot_cl, in_clp = tot_clp;  // sums of this row group and the later ones
    float o = __shfl_down_sync(0xffffffffu, in_cl, 8), o2 = __shfl_down_sync(0xffffffffu, in_clp, 8);
    if (rg < 3) in_cl += o, in_clp += o2;
    o = __shfl_down_sync(0xffffffffu, in_cl, 16), o2 = __shfl_down_sync(0xffffffffu, in_clp, 16);
    if (rg < 2) in_cl += o, in_clp += o2;
    float run_cl = __shfl_down_sync(0xffffffffu, in_cl, 8);
    float run_clp = __shfl_down_sync(0xffffffffu, in_clp, 8);
    if (rg == 3) run_cl = 0.f, run_clp = 0.f;
    const float last = sds_s[kk] * scan::ex2(clL[kk]) +
                       ((kx2_s[kk] + kx2_s[D + kk]) + (kx2_s[2 * D + kk] + kx2_s[3 * D + kk]));
#pragma unroll
    for (int q = 15; q >= 0; --q) {
      const int m = r0 + q;
      run_cl += a_cl[q];
      const float dlw = last + run_cl + run_clp;
      run_clp += a_clp[q];
      if (m < valid) {
        const long long off = base + (long long)(t0 + m) * row + kk;
        const float wm = p.w[off];
        p.dw[off] = wm >= 1e-30f ? dlw / wm : 0.f;
      }
    }
    du += __shfl_xor_sync(0xffffffffu, du, 8);
    du += __shfl_xor_sync(0xffffffffu, du, 16);
    if (rg == 0) p.du_part[(((long long)b * p.n_chunks + c) * p.H + h) * D + kk] = du;
  }
}

// ------------------------------------------------------------------ (c) du

// du[h][k] = sum over batch and chunks of du_part, in a fixed order
template <int D>
__global__ void wkv6_bwd_du_reduce_kernel(const Params p) {
  const int h = blockIdx.x, kk = threadIdx.x;
  float acc = 0.f;
  for (int b = 0; b < p.B; ++b)
    for (int c = 0; c < p.n_chunks; ++c)
      acc += p.du_part[(((long long)b * p.n_chunks + c) * p.H + h) * D + kk];
  p.du[h * D + kk] = acc;
}

template <int D>
int occupancy(int kernel, int* threads, int* smem, int* blocks_per_sm) {
  using Sh = Shape<D>;
  cudaError_t err = cudaErrorInvalidValue;
  if (kernel == 0) {
    *threads = ST_THREADS, *smem = (int)Sh::ST_SMEM;
    if ((err = scan::prepare_smem(wkv6_bwd_state_kernel<D>, Sh::ST_SMEM)) == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, wkv6_bwd_state_kernel<D>,
                                                          ST_THREADS, Sh::ST_SMEM);
  } else if (kernel == 1) {
    *threads = CT, *smem = (int)Sh::CHUNK_SMEM;
    if ((err = scan::prepare_smem(wkv6_bwd_chunk_kernel<D>, Sh::CHUNK_SMEM)) == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, wkv6_bwd_chunk_kernel<D>,
                                                          CT, Sh::CHUNK_SMEM);
  } else if (kernel == 2) {
    *threads = D, *smem = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                        wkv6_bwd_du_reduce_kernel<D>, D, 0);
  }
  return err;
}

template <int D>
int launch(const Params& p, cudaStream_t st) {
  using Sh = Shape<D>;
  cudaError_t err = scan::prepare_smem(wkv6_bwd_state_kernel<D>, Sh::ST_SMEM);
  if (err != cudaSuccess) return err;
  wkv6_bwd_state_kernel<D><<<dim3(D / VT, p.B * p.H), ST_THREADS, Sh::ST_SMEM, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = scan::prepare_smem(wkv6_bwd_chunk_kernel<D>, Sh::CHUNK_SMEM)) != cudaSuccess)
    return err;
  wkv6_bwd_chunk_kernel<D><<<dim3(p.n_chunks, p.B * p.H), CT, Sh::CHUNK_SMEM, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkv6_bwd_du_reduce_kernel<D><<<p.H, D, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the workspace wkv6_bwd needs: dS at every 64-row chunk, and du's partials.
long long wkv6_bwd_workspace_floats(int B, int T, int H, int head) {
  const long long nc = (T + CH - 1) / CH;
  return (long long)B * nc * H * head * head + (long long)B * nc * H * head;
}

// Per kernel of wkv6_bwd at head size `head` (0 the state pass, 1 the chunk pass, 2 du's
// sum): the threads of a block, the dynamic shared memory a block takes, and how many
// blocks an SM holds.  Returns a cudaError_t.
int wkv6_bwd_occupancy(int head, int kernel, int* threads, int* smem, int* blocks_per_sm) {
  switch (head) {
    case 32: return occupancy<32>(kernel, threads, smem, blocks_per_sm);
    case 64: return occupancy<64>(kernel, threads, smem, blocks_per_sm);
    default: return cudaErrorInvalidValue;
  }
}

// Returns a cudaError_t: 0 when the three kernels were launched.  All tensors are contiguous
// fp32; K = V = head (32 or 64) and chunk (64) are the compiled sizes, any other is
// refused; S_chunks is wkv6_fwd's workspace; ds_out may be null (zero); `work` holds
// wkv6_bwd_workspace_floats(B, T, H, head).
int wkv6_bwd(const float* r, const float* k, const float* v, const float* w, const float* u,
             const float* S_chunks, const float* dy, const float* ds_out, float* dr, float* dk,
             float* dv, float* dw, float* du, float* ds0, int B, int T, int H, int head,
             int chunk, void* work, void* stream) {
  if (chunk != CH || T <= 0) return cudaErrorInvalidValue;
  const int n_chunks = (T + CH - 1) / CH;
  float* ws = static_cast<float*>(work);
  const Params p{r,  k,  v,  w,  u,   S_chunks, dy, ds_out, dr, dk, dv, dw, du, ds0,
                 ws, ws + (long long)B * n_chunks * H * head * head, B, T, H, n_chunks};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head) {
    case 32: return launch<32>(p, st);
    case 64: return launch<64>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* wkv6_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
