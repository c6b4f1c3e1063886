// Chunked RWKV6 WKV recurrence for Hopper (sm_90a), fp32 on the TF32 tensor cores, with a
// state in and out.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py::wkv6_fwd (body _wkv6_kernel,
// pallas_call at line 92), which starts from a zero state and returns y only; this one
// computes ref.rwkv6_chunked, the function the model calls: it takes the [B,H,K,V] state
// and writes the final one.
//
//   r, k, w [B,T,H,K], v [B,T,H,V], u [H,K], s0 [B,H,K,V] -> y [B,T,H,V], s_out [B,H,K,V]
//
// Per chunk of 64 rows, in log2 units (cl the inclusive cumsum of log2 w down each key
// column, clp the exclusive one):
//   y_i = (r_i * 2^clp_i) S + sum_{j<i} att_ij v_j + (r_i . u k_i) v_i,
//   att_ij = sum_k r_ik k_jk 2^(clp_ik - cl_jk),
//   S' = 2^cl_last * S + sum_j (k_j * 2^(cl_last - cl_j)) v_j^T.
//
// What bounds it on an H100 (SXM, published peaks at a 700 W power limit): at the
// rwkv6-1.6b prefill shape (B=4, T=2048, H=32, K=V=64) its inputs and outputs are 0.34 GB,
// 0.101 ms of device memory; its 7.7e9 flops of products take 0.016 ms at the 495 TFLOP/s
// TF32 tensor-core rate, so once the products run on the tensor cores it is bound by
// bytes, with the exponentials of att next.  What the design does about it:
//   * the chunk loop is split in two kernels under one call, so the card fills: a state
//     pass (one block per (batch, head, 32 value columns): 256 blocks at the main shape)
//     walks the chunks in order and writes each chunk's initial state to a workspace
//     [B, n_chunks, H, K, V] (67 MB), then the final state; an output pass (one block per
//     (batch, head, chunk): 4096 blocks, all independent) computes y from it;
//   * every product runs as 3xTF32 mma.sync (scan_sm90.cuh): the state pass's rank-64
//     update, and the output pass's (r 2^clp) S, att and att v;
//   * att by sub-chunks of 16 rows.  For row block I and an earlier block J < I, with
//     ref_I = clp at I's first row:
//       att_IJ = (r_I * 2^(clp_I - ref_I)) . (k_J * 2^(ref_I - cl_J))^T.
//     ref_I lies between every j in J and every i in I, so for decays w <= 1 (the model's
//     w = exp(-exp(.))) both exponents are <= 0: neither factor overflows, and a factor
//     underflows only where the exact 2^(clp_i - cl_j), which is below it, already lies
//     under fp32's range.  (A reference at the chunk's start would not do: 2^-clp_j
//     overflows once a chunk's decays are strong.)  The four 16 x 16 diagonal blocks are
//     split once more, at their middle row, the same way; only their eight 8 x 8
//     diagonal sub-blocks keep one exponential per (i, j < i, k), spread over the lanes
//     pair by pair: (8 * 28 + 208) * 64 exponentials per chunk and head, not 2016 * 64;
//   * exponentials and logarithms run on the special-function unit, flushing results
//     below 2^-126 to zero: the library's exp2f takes a slow path there, where strong
//     decays send most of att's factors;
//   * the cumsums are parallel: 16 rows a thread, then a warp-shuffle scan across the
//     four row groups of each column;
//   * the ragged last chunk is masked here (rows past T read as r = k = v = 0, w = 1),
//     which keeps the final state exact without padding in device memory;
//   * no atomics and a fixed order of every sum: reruns are bit-identical.
// The head size D = K = V is a template parameter: one instance for each size the repo's
// configs give (64, and 32 in their reduced forms), the extern "C" entry dispatching on it.
// At D = 32 a state-pass block's four warps split its 32 value columns in two halves over
// the two 16-row key blocks, and the shared rows keep their bank-conflict-free strides
// (D + 8 for rows read as [k][m] fragments, D + 4 for [m][k]).

#include <cuda_runtime.h>

#include <cmath>

#include "scan_sm90.cuh"

namespace {

constexpr int NTHREADS = 128;                   // 4 warps
constexpr int CH = 64;                          // rows per chunk
constexpr int VT = 32;                          // value columns of one state-pass block
constexpr float CLAMP2 = 30.f * scan::LOG2E;    // the reference's exponent clamp (30), in log2

// The strides and the state pass's warp split of head size D = K = V.
template <int D>
struct Shape {
  static_assert(D % 32 == 0 && D <= 64, "D is 32 or 64");
  static constexpr int LDK = D + 8;             // state pass: rows read as [k][m] fragments
  static constexpr int LDV = VT + 8;
  static constexpr int LDR = D + 4;             // output pass: rows read as [m][k] fragments
  static constexpr int LDS = D + 8;
  static constexpr int KR = D / 16;             // state pass: 16-row key blocks, one a warp,
  static constexpr int WV = VT * KR / 4;        // and each warp's value columns of the block's VT
  static constexpr int ST_STAGE = 2 * CH * LDK + CH * LDV;    // k, w (then cl), v tile
  static constexpr size_t ST_SMEM = 2 * ST_STAGE * sizeof(float);
  static constexpr int DG = 2 * 8 * 8;          // a warp's two 8 x 8 diagonal sub-blocks
  static constexpr size_t OUT_SMEM = (4 * CH * LDR + D * LDS + D + 4 * DG) * sizeof(float);
};

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* s0;
  float* y;
  float* s_out;
  float* S_chunks;   // [B][n_chunks][H][K][V]: the state at each chunk's start
  int B, T, H, n_chunks;
};

__device__ __forceinline__ float exp2c(float x) { return scan::ex2(fminf(x, CLAMP2)); }

// ------------------------------------------------------------------ (a) state pass

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2) wkv6_state_kernel(const Params p) {
  using Sh = Shape<D>;
  constexpr int LDK = Sh::LDK, LDV = Sh::LDV, ST_STAGE = Sh::ST_STAGE, NTW = Sh::WV / 8;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int v0 = blockIdx.x * VT, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const long long row = (long long)p.H * D;
  const long long base = (long long)b * p.T * row + (long long)h * D;
  const int m0 = 16 * (warp % Sh::KR);         // this warp's key rows
  const int vw = Sh::WV * (warp / Sh::KR);     // and its value columns, from v0

  auto load_chunk = [&](int c, int stage) {
    float* k_s = smem + stage * ST_STAGE;
    const int t0 = c * CH;
    scan::load_rows<CH, D, LDK, NTHREADS>(k_s, p.k + base, row, t0, p.T, tid);
    scan::load_rows<CH, D, LDK, NTHREADS>(k_s + CH * LDK, p.w + base, row, t0, p.T, tid);
    scan::load_rows<CH, VT, LDV, NTHREADS>(k_s + 2 * CH * LDK, p.v + base + v0, row, t0, p.T,
                                           tid);
    scan::cp_async_commit();
  };

  // S[m0 .. m0+15][v0 + vw .. v0 + vw + WV) as NTW accumulator tiles
  float S[NTW][4];
  const long long sidx = (long long)bh * D * D + v0 + vw;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    const float* s = p.s0 + sidx + (m0 + g) * D + 8 * nt + 2 * t;
    const float2 a = *reinterpret_cast<const float2*>(s);
    const float2 c = *reinterpret_cast<const float2*>(s + 8 * D);
    S[nt][0] = a.x, S[nt][1] = a.y, S[nt][2] = c.x, S[nt][3] = c.y;
  }

  load_chunk(0, 0);
  for (int c = 0; c < p.n_chunks; ++c) {
    float* k_s = smem + (c & 1) * ST_STAGE;
    float* cl_s = k_s + CH * LDK;
    const float* v_s = cl_s + CH * LDK;
    {
      float* out = p.S_chunks + (((long long)b * p.n_chunks + c) * p.H + h) * D * D + v0 + vw;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        float* s = out + (m0 + g) * D + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(s) = make_float2(S[nt][0], S[nt][1]);
        *reinterpret_cast<float2*>(s + 8 * D) = make_float2(S[nt][2], S[nt][3]);
      }
    }
    scan::cp_async_wait<0>();
    __syncthreads();            // chunk c has landed; every warp is done with chunk c-1
    if (c + 1 < p.n_chunks) load_chunk(c + 1, (c + 1) & 1);
    scan::log2_cumsum<LDK, NTHREADS, D>(cl_s, p.T - c * CH, tid);
    __syncthreads();

    // S' = 2^cl_last S + kd^T v, kd_jk = k_jk 2^(cl_last,k - cl_jk); A = kd^T [k rows][j]
    const float last0 = cl_s[(CH - 1) * LDK + m0 + g], last1 = cl_s[(CH - 1) * LDK + m0 + g + 8];
    const float d0 = scan::ex2(last0), d1 = scan::ex2(last1);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      S[nt][0] *= d0, S[nt][1] *= d0;
      S[nt][2] *= d1, S[nt][3] *= d1;
    }
#pragma unroll
    for (int kj = 0; kj < CH / 8; ++kj) {
      const int o0 = (8 * kj + t) * LDK + m0 + g, o1 = o0 + 4 * LDK;
      const scan::FragA a = scan::frag_a(k_s[o0] * exp2c(last0 - cl_s[o0]),
                                         k_s[o0 + 8] * exp2c(last1 - cl_s[o0 + 8]),
                                         k_s[o1] * exp2c(last0 - cl_s[o1]),
                                         k_s[o1 + 8] * exp2c(last1 - cl_s[o1 + 8]));
      const float* vr = v_s + (8 * kj + t) * LDV + vw + g;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
        scan::mma(S[nt], a, scan::frag_b(vr[8 * nt], vr[4 * LDV + 8 * nt]));
    }
  }

#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    float* s = p.s_out + sidx + (m0 + g) * D + 8 * nt + 2 * t;
    *reinterpret_cast<float2*>(s) = make_float2(S[nt][0], S[nt][1]);
    *reinterpret_cast<float2*>(s + 8 * D) = make_float2(S[nt][2], S[nt][3]);
  }
}

// ------------------------------------------------------------------ (b) output pass

template <int D>
__global__ void __launch_bounds__(NTHREADS, 3) wkv6_out_kernel(const Params p) {
  using Sh = Shape<D>;
  constexpr int LDR = Sh::LDR, LDS = Sh::LDS, DG = Sh::DG;
  extern __shared__ __align__(16) float smem[];
  float* r_s = smem;                  // [CH][LDR]
  float* k_s = r_s + CH * LDR;
  float* cl_s = k_s + CH * LDR;       // w, then the inclusive log2 cumsum
  float* u_s = cl_s + CH * LDR;       // [D]
  float* dg_s = u_s + D;              // [4 warps][2][8][8]
  float* v_s = dg_s + 4 * DG;         // [CH][LDR]
  float* S_s = v_s + CH * LDR;        // [D][LDS] the state at the chunk's start
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int t0 = c * CH, valid = p.T - t0;
  const long long row = (long long)p.H * D;
  const long long base = (long long)b * p.T * row + (long long)h * D;

  scan::load_rows<CH, D, LDR, NTHREADS>(r_s, p.r + base, row, t0, p.T, tid);
  scan::load_rows<CH, D, LDR, NTHREADS>(k_s, p.k + base, row, t0, p.T, tid);
  scan::load_rows<CH, D, LDR, NTHREADS>(cl_s, p.w + base, row, t0, p.T, tid);
  scan::load_rows<CH, D, LDR, NTHREADS>(v_s, p.v + base, row, t0, p.T, tid);
  scan::load_rows<D, D, LDS, NTHREADS>(
      S_s, p.S_chunks + (((long long)b * p.n_chunks + c) * p.H + h) * D * D, D, 0, D, tid);
  scan::cp_async_commit();
  if (tid < D) u_s[tid] = p.u[(long long)h * D + tid];
  scan::cp_async_wait<0>();
  __syncthreads();
  scan::log2_cumsum<LDR, NTHREADS, D>(cl_s, valid, tid);
  __syncthreads();

  const int i0 = 16 * warp;           // this warp's rows: i0 .. i0+15
  auto clp = [&](int i, int kk) { return i ? cl_s[(i - 1) * LDR + kk] : 0.f; };

  // (1) y = (r * 2^clp) S
  float y[D / 8][4] = {};
#pragma unroll
  for (int kb = 0; kb < D / 8; ++kb) {
    const int k0 = 8 * kb + t, ia = i0 + g, ib = ia + 8;
    const scan::FragA a = scan::frag_a(r_s[ia * LDR + k0] * scan::ex2(clp(ia, k0)),
                                       r_s[ib * LDR + k0] * scan::ex2(clp(ib, k0)),
                                       r_s[ia * LDR + k0 + 4] * scan::ex2(clp(ia, k0 + 4)),
                                       r_s[ib * LDR + k0 + 4] * scan::ex2(clp(ib, k0 + 4)));
    const float* sr = S_s + k0 * LDS + g;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      scan::mma(y[nt], a, scan::frag_b(sr[8 * nt], sr[4 * LDS + 8 * nt]));
  }

  // (2) att of the earlier row blocks J < I, through ref = clp at row i0; and of the
  // diagonal block's lower-left 8 x 8 (rows i0+8.., keys i0..i0+7), through clp at i0+8
  float att[CH / 8 - 2][4] = {};
  float low[4] = {};
#pragma unroll
  for (int kb = 0; kb < D / 8; ++kb) {
    const int k0 = 8 * kb + t, ia = i0 + g, ib = ia + 8;
    if (warp > 0) {
      const float* ref = cl_s + (i0 - 1) * LDR;
      const float f0 = ref[k0], f1 = ref[k0 + 4];
      const scan::FragA a = scan::frag_a(r_s[ia * LDR + k0] * exp2c(clp(ia, k0) - f0),
                                         r_s[ib * LDR + k0] * exp2c(clp(ib, k0) - f0),
                                         r_s[ia * LDR + k0 + 4] * exp2c(clp(ia, k0 + 4) - f1),
                                         r_s[ib * LDR + k0 + 4] * exp2c(clp(ib, k0 + 4) - f1));
#pragma unroll
      for (int nt = 0; nt < CH / 8 - 2; ++nt) {
        if (nt >= 2 * warp) continue;
        const int o = (8 * nt + g) * LDR + k0;
        scan::mma(att[nt], a, scan::frag_b(k_s[o] * exp2c(f0 - cl_s[o]),
                                           k_s[o + 4] * exp2c(f1 - cl_s[o + 4])));
      }
    }
    {
      const float* ref = cl_s + (i0 + 7) * LDR;
      const float f0 = ref[k0], f1 = ref[k0 + 4];
      const scan::FragA a = scan::frag_a(0.f, r_s[ib * LDR + k0] * exp2c(clp(ib, k0) - f0), 0.f,
                                         r_s[ib * LDR + k0 + 4] * exp2c(clp(ib, k0 + 4) - f1));
      const int o = (i0 + g) * LDR + k0;
      scan::mma(low, a, scan::frag_b(k_s[o] * exp2c(f0 - cl_s[o]),
                                     k_s[o + 4] * exp2c(f1 - cl_s[o + 4])));
    }
  }

  // (3) the two 8 x 8 diagonal sub-blocks: 2 x 28 pairs (i, j < i) spread over the lanes,
  // one exponential per pair and key; then the u bonus on the diagonal
  float* dg = dg_s + warp * DG;
#pragma unroll
  for (int q = 0; q < 4; ++q) dg[4 * lane + q] = 0.f;
  __syncwarp();
#pragma unroll
  for (int slot = 0; slot < 2; ++slot) {
    const int pr = lane + 32 * slot;
    if (pr >= 56) continue;
    const int sb = pr / 28, q = pr % 28;
    int ri = (int)((1.f + sqrtf(1.f + 8.f * q)) * 0.5f);
    if (ri * (ri - 1) / 2 > q) --ri;
    if ((ri + 1) * ri / 2 <= q) ++ri;
    const int rj = q - ri * (ri - 1) / 2, i = i0 + 8 * sb + ri, j = i0 + 8 * sb + rj;
    const float* rr = r_s + i * LDR;
    const float* pp = cl_s + (i - 1) * LDR;     // clp of row i (i > j >= 0)
    const float* kr = k_s + j * LDR;
    const float* cr = cl_s + j * LDR;
    float acc = 0.f;
#pragma unroll 16
    for (int kk = 0; kk < D; ++kk) acc = fmaf(rr[kk] * kr[kk], exp2c(pp[kk] - cr[kk]), acc);
    dg[(8 * sb + ri) * 8 + rj] = acc;
  }
  if (lane < 16) {
    const float* rr = r_s + (i0 + lane) * LDR;
    const float* kr = k_s + (i0 + lane) * LDR;
    float acc = 0.f;
#pragma unroll 16
    for (int kk = 0; kk < D; ++kk) acc = fmaf(rr[kk] * u_s[kk], kr[kk], acc);
    dg[lane * 8 + (lane & 7)] = acc;
  }
  __syncwarp();

  // (4) y += att v: the accumulator tiles of att are A operands, k slots (t, t+4) =
  // keys (2t, 2t+1) of each 8-key tile
#pragma unroll
  for (int nt = 0; nt < CH / 8; ++nt) {
    if (nt > 2 * warp + 1) continue;
    float a4[4];
    if (nt == 2 * warp) {               // [[D0, 0], [low, D1]]: keys i0 .. i0+7
      a4[0] = dg[g * 8 + 2 * t], a4[1] = dg[g * 8 + 2 * t + 1];
      a4[2] = low[2], a4[3] = low[3];
    } else if (nt == 2 * warp + 1) {    // keys i0+8 .. i0+15
      a4[0] = 0.f, a4[1] = 0.f;
      a4[2] = dg[(8 + g) * 8 + 2 * t], a4[3] = dg[(8 + g) * 8 + 2 * t + 1];
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) a4[q] = att[nt < CH / 8 - 2 ? nt : 0][q];
    }
    const scan::FragA a = scan::c_as_a(a4);
    const float* vr = v_s + (8 * nt + 2 * t) * LDR + g;
#pragma unroll
    for (int vt = 0; vt < D / 8; ++vt)
      scan::mma(y[vt], a, scan::frag_b(vr[8 * vt], vr[LDR + 8 * vt]));
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + g + 8 * half;
    if (i >= valid) continue;
    float* yr = p.y + base + (long long)(t0 + i) * row + 2 * t;
#pragma unroll
    for (int vt = 0; vt < D / 8; ++vt)
      *reinterpret_cast<float2*>(yr + 8 * vt) = make_float2(y[vt][2 * half], y[vt][2 * half + 1]);
  }
}

template <int D>
int launch(const Params& p, cudaStream_t st) {
  using Sh = Shape<D>;
  cudaError_t err = cudaFuncSetAttribute(wkv6_state_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Sh::ST_SMEM);
  if (err != cudaSuccess) return err;
  wkv6_state_kernel<D><<<dim3(D / VT, p.B * p.H), NTHREADS, Sh::ST_SMEM, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv6_out_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Sh::OUT_SMEM);
  if (err != cudaSuccess) return err;
  wkv6_out_kernel<D><<<dim3(p.n_chunks, p.B * p.H), NTHREADS, Sh::OUT_SMEM, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the workspace wkv6_fwd needs: the state at every 64-row chunk's start.
long long wkv6_workspace_floats(int B, int T, int H, int head) {
  return (long long)B * ((T + CH - 1) / CH) * H * head * head;
}

// Returns a cudaError_t: 0 when both kernels were launched.  All tensors are contiguous
// fp32; K = V = head (32 or 64) and chunk (64) are the compiled sizes, any other is
// refused; `work` holds wkv6_workspace_floats(B, T, H, head) floats.
int wkv6_fwd(const float* r, const float* k, const float* v, const float* w, const float* u,
             const float* s0, float* y, float* s_out, int B, int T, int H, int head, int chunk,
             void* work, void* stream) {
  if (chunk != CH || T <= 0) return cudaErrorInvalidValue;
  const int n_chunks = (T + CH - 1) / CH;
  const Params p{r, k, v, w, u, s0, y, s_out, static_cast<float*>(work), B, T, H, n_chunks};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head) {
    case 32: return launch<32>(p, st);
    case 64: return launch<64>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
