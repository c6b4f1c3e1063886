// Chunked Mamba2 SSD scan for Hopper (sm_90a), fp32 on the TF32 tensor cores, with a
// state in and out.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_ssd.py::ssd_fwd (body _ssd_kernel,
// pallas_call at line 88), which starts from a zero state and returns y only; this one
// computes ref.mamba2_ssd, the function the model calls: it takes the [Bt,H,P,N] state
// and writes the final one.
//
//   x [Bt,T,H,P], dt [Bt,T,H], A [H], B/C [Bt,T,G,N], s0 [Bt,H,P,N]
//     -> y [Bt,T,H,P], s_out [Bt,H,P,N]
//   head h reads group h / (H/G) of B and C (G = 1: every head the same B and C)
//
// What bounds it on an H100 (SXM, published peaks at a 700 W power limit): at the
// zamba2-7b prefill shape (Bt=4, T=2048, H=112, P=N=64) it moves 0.49 GB (x and y
// dominate: 0.146 ms of device memory) and needs 2.3e10 flops of products, 0.047 ms at
// the 495 TFLOP/s TF32 tensor-core rate, so it is bound by bytes once the products run on
// the tensor cores.  What the design does about it:
//   * two kernels, one call.  ssd_gram_kernel computes G = C B^T once per (batch, group,
//     chunk), since B and C do not depend on the head within a group, into a workspace
//     (1 MB a group at the main shape) that stays in L2,
//     stored in the order of the A fragments that read it (one float4 a lane);
//     ssd_scan_kernel runs one block of 4 warps per (batch, head) with the chunk loop
//     inside and the [P,N] state in registers, so no per-chunk state goes to memory;
//   * the sequence is walked in chunks of 32 rows (the function is the same for any chunk
//     length; only rounding differs; 32 rows halve the causal product's share against 64
//     and keep a block small): per chunk and head the three products are
//     y = e^cl (C S^T) + M x and S' = e^cl_last S + (x w)^T B, with
//     M = G * e^(cl_i - cl_j) * dt_j (j <= i), all fp32 products as 3xTF32 mma.sync
//     (scan_sm90.cuh);
//   * warp w owns the 16 head columns p in [16w, 16w+16): y[:, p] and the state rows S[p, :]
//     both stay with it, and the state's accumulator tiles are exactly the B fragments of
//     C S^T, so the state never leaves the registers between chunks; M is built in
//     registers from G's fragments (its causal-zero tiles skipped), never in shared memory;
//   * x, B, C and dt of the next chunk are loaded by cp.async into the second of two
//     stages while the current chunk computes; rows of 72 floats keep every fragment load
//     free of bank conflicts; 55 KB of shared memory and 128 registers a thread let four
//     blocks share an SM, so the 448 blocks of the main shape run in one wave;
//   * exponentials run on the special-function unit, flushing results below 2^-126 to
//     zero: the library's expf takes a slow path there, and e^(cl_i - cl_j) goes there
//     whenever the decay between two rows is strong;
//   * the ragged last chunk is masked here (rows past T read as x = B = C = dt = 0, and
//     are not written), which keeps the final state exact without padding in memory;
//   * for the backward (mamba2_ssd_bwd.cu) it also writes, when asked, the state before
//     every 64 rows to S_chunks [Bt, ceil(T / 64), H, P, N].
// The groups of B and C (1 or 2) are a template parameter too: at one group both
// kernels are the code they were before groups.
// The head and state sizes (P, N) are template parameters, instantiated for (64, 64) and
// for the reduced configs' (32, 16) and chosen by the extern "C" entry: a scan block has a
// warp for every 16 head columns (two at P = 32), and at N = 16 the Gram product's depth
// and the state's width are two 8-column tiles.  Shared rows are max(P, N) + 8 floats
// (8 t + g: no bank conflict) and the Gram kernel's max(N, 32) + 4 (4 g + t), since its
// tile holds [32][N] rows of C and then the [32][32] G.

#include <cuda_runtime.h>

#include <cmath>

#include "scan_sm90.cuh"

namespace {

constexpr int CH = 32;          // rows per chunk
constexpr int RPL = CH / 32;    // cumsum rows per lane
constexpr int G_TILES = (CH / 16) * (CH / 8);   // A fragments of one chunk's G: 2 x 4

template <int N>
constexpr int LDG = (N > CH ? N : CH) + 4;    // the Gram kernel's rows

template <int P, int N>
struct Shape {
  static_assert(P % 16 == 0 && N % 8 == 0 && P <= 64 && N <= 64, "(P, N) up to (64, 64)");
  static constexpr int NTHREADS = 2 * P;                  // a warp per 16 head columns
  static constexpr int LD = (P > N ? P : N) + 8;          // shared row stride, floats
  static constexpr int STAGE = 3 * CH * LD + CH;          // x, B, C, dt
  static constexpr size_t SCAN_SMEM =                     // two stages; per-warp cl, w
      (2 * STAGE + (NTHREADS / 32) * 2 * CH) * sizeof(float);
};

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  const float* s0;
  float* y;
  float* s_out;
  float* S_chunks;  // [Bt][ceil(T/64)][H][P][N] the state before every 64 rows, or null
  float4* G;      // [Bt][NG][n_chunks][G_TILES][32 lanes] A fragments of C B^T
  int Bt, T, H, n_chunks;
  int hpg;        // heads a group of B and C
};

// G = C B^T of one (chunk, batch), rows i and columns j <= i, in fragment order:
// tile (mi, kj), lane (g, t) holds G[16mi + g (+8)][8kj + t (+4)] as a float4.
constexpr int GRAM_THREADS = 32 * (CH / 16);   // a warp per 16 rows of G

template <int N, int NG>
__global__ void __launch_bounds__(GRAM_THREADS) ssd_gram_kernel(const Params p) {
  constexpr int LDG = ::LDG<N>;
  __shared__ __align__(16) float C_s[CH * LDG];
  __shared__ __align__(16) float B_s[CH * LDG];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int chunk = blockIdx.x, bg = blockIdx.y, t0 = chunk * CH;   // bg = b * NG + group
  const long long first = ((long long)(bg / NG) * p.T * NG + bg % NG) * N;
  const float* Cb = p.Cm + first;
  const float* Bb = p.Bm + first;
  scan::load_rows<CH, N, LDG, GRAM_THREADS>(C_s, Cb, NG * N, t0, p.T, tid);
  scan::load_rows<CH, N, LDG, GRAM_THREADS>(B_s, Bb, NG * N, t0, p.T, tid);
  scan::cp_async_commit();
  scan::cp_async_wait<0>();
  __syncthreads();

  const int mi = warp;                  // rows 16mi..16mi+15; columns j < 16mi + 16
  float acc[CH / 8][4] = {};
#pragma unroll
  for (int kb = 0; kb < N / 8; ++kb) {
    const float* c = C_s + (16 * mi + g) * LDG + 8 * kb + t;
    const scan::FragA a = scan::frag_a(c[0], c[8 * LDG], c[4], c[8 * LDG + 4]);
#pragma unroll
    for (int nt = 0; nt < CH / 8; ++nt) {
      if (nt > 2 * mi + 1) continue;
      const float* bb = B_s + (8 * nt + g) * LDG + 8 * kb + t;
      scan::mma(acc[nt], a, scan::frag_b(bb[0], bb[4]));
    }
  }
  // through this warp's own rows of C_s, from the accumulator layout to the A layout
  __syncwarp();
  float* G_s = C_s;
#pragma unroll
  for (int nt = 0; nt < CH / 8; ++nt) {
    float* r = G_s + (16 * mi + g) * LDG + 8 * nt + 2 * t;
    r[0] = acc[nt][0];
    r[1] = acc[nt][1];
    r[8 * LDG] = acc[nt][2];
    r[8 * LDG + 1] = acc[nt][3];
  }
  __syncwarp();
  float4* out = p.G + ((long long)bg * p.n_chunks + chunk) * G_TILES * 32;
#pragma unroll
  for (int kj = 0; kj < CH / 8; ++kj) {
    if (kj > 2 * mi + 1) continue;
    const float* r = G_s + (16 * mi + g) * LDG + 8 * kj + t;
    out[(mi * (CH / 8) + kj) * 32 + lane] = make_float4(r[0], r[8 * LDG], r[4], r[8 * LDG + 4]);
  }
}

template <int P, int N, int NG>
__global__ void __launch_bounds__(Shape<P, N>::NTHREADS, 4) ssd_scan_kernel(const Params p) {
  constexpr int NTHREADS = Shape<P, N>::NTHREADS, LD = Shape<P, N>::LD;
  constexpr int STAGE = Shape<P, N>::STAGE;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const float A = p.A[h];
  const long long row = (long long)p.H * P;                     // x/y: one time step
  const float* xb = p.x + (long long)b * p.T * row + h * P;
  float* yb = p.y + (long long)b * p.T * row + h * P;
  const int grp = NG == 1 ? 0 : h / p.hpg;                      // h's group of B and C
  const float* Bb = p.Bm + ((long long)b * p.T * NG + grp) * N;
  const float* Cb = p.Cm + ((long long)b * p.T * NG + grp) * N;
  const float* dtb = p.dt + (long long)b * p.T * p.H + h;
  float* cl_w = smem + 2 * STAGE + warp * 2 * CH;               // this warp's cumsum
  float* w_w = cl_w + CH;                                       // e^(cl_last - cl_j) dt_j
  const int p0 = 16 * warp;                                     // this warp's head columns

  auto load_chunk = [&](int c, int stage) {
    float* x_s = smem + stage * STAGE;
    const int t0 = c * CH;
    scan::load_rows<CH, P, LD, NTHREADS>(x_s, xb, row, t0, p.T, tid);
    scan::load_rows<CH, N, LD, NTHREADS>(x_s + CH * LD, Bb, NG * N, t0, p.T, tid);
    scan::load_rows<CH, N, LD, NTHREADS>(x_s + 2 * CH * LD, Cb, NG * N, t0, p.T, tid);
    if (tid < CH) {
      const bool in = t0 + tid < p.T;
      scan::cp_async4(x_s + 3 * CH * LD + tid, dtb + (in ? (long long)(t0 + tid) * p.H : 0), in);
    }
    scan::cp_async_commit();
  };

  // the state rows S[p0 .. p0+15][:], as accumulator tiles over n
  float S[N / 8][4];
  {
    const float* s = p.s0 + ((long long)b * p.H + h) * P * N;
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const float2 lo = *reinterpret_cast<const float2*>(s + (p0 + g) * N + 8 * nt + 2 * t);
      const float2 hi = *reinterpret_cast<const float2*>(s + (p0 + g + 8) * N + 8 * nt + 2 * t);
      S[nt][0] = lo.x, S[nt][1] = lo.y, S[nt][2] = hi.x, S[nt][3] = hi.y;
    }
  }

  load_chunk(0, 0);
  for (int c = 0; c < p.n_chunks; ++c) {
    const int t0 = c * CH;
    if (p.S_chunks && t0 % 64 == 0) {
      float* s = p.S_chunks + (((long long)b * ((p.T + 63) / 64) + t0 / 64) * p.H + h) * P * N;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        *reinterpret_cast<float2*>(s + (p0 + g) * N + 8 * nt + 2 * t) =
            make_float2(S[nt][0], S[nt][1]);
        *reinterpret_cast<float2*>(s + (p0 + g + 8) * N + 8 * nt + 2 * t) =
            make_float2(S[nt][2], S[nt][3]);
      }
    }
    const float* x_s = smem + (c & 1) * STAGE;
    const float* B_s = x_s + CH * LD;
    const float* C_s = B_s + CH * LD;
    const float* dt_s = C_s + CH * LD;
    scan::cp_async_wait<0>();
    __syncthreads();              // chunk c has landed; every warp is done with chunk c-1
    if (c + 1 < p.n_chunks) load_chunk(c + 1, (c + 1) & 1);

    // cl = cumsum(A dt) over the chunk (lane: rows RPL l ..), per warp
    float cl_last;
    {
      float v[RPL];
      float run = 0.f;
#pragma unroll
      for (int q = 0; q < RPL; ++q) v[q] = run += A * dt_s[RPL * lane + q];
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const float excl = incl - run;
      cl_last = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        const int i = RPL * lane + q;
        cl_w[i] = excl + v[q];
        w_w[i] = scan::ex(fminf(cl_last - (excl + v[q]), 30.f)) * dt_s[i];
      }
    }
    __syncwarp();

    // y[:, p0..p0+15]: e^cl_i (C_i S^T) + sum_{j <= i} M_ij x_j
    float acc[CH / 16][2][4] = {};
#pragma unroll
    for (int kb = 0; kb < N / 8; ++kb) {
      // k slots (t, t+4) = state columns (8kb + 2t, 8kb + 2t + 1): S's own tiles
      const scan::FragB s0 = scan::frag_b(S[kb][0], S[kb][1]);
      const scan::FragB s1 = scan::frag_b(S[kb][2], S[kb][3]);
#pragma unroll
      for (int mi = 0; mi < CH / 16; ++mi) {
        const float2 u = *reinterpret_cast<const float2*>(C_s + (16 * mi + g) * LD + 8 * kb + 2 * t);
        const float2 v = *reinterpret_cast<const float2*>(C_s + (16 * mi + g + 8) * LD + 8 * kb + 2 * t);
        const scan::FragA a = scan::frag_a(u.x, v.x, u.y, v.y);
        scan::mma(acc[mi][0], a, s0);
        scan::mma(acc[mi][1], a, s1);
      }
    }
#pragma unroll
    for (int mi = 0; mi < CH / 16; ++mi) {
      const float e0 = scan::ex(cl_w[16 * mi + g]), e1 = scan::ex(cl_w[16 * mi + g + 8]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        acc[mi][nt][0] *= e0, acc[mi][nt][1] *= e0;
        acc[mi][nt][2] *= e1, acc[mi][nt][3] *= e1;
      }
    }
    const float4* Gc =
        p.G + ((long long)(b * NG + grp) * p.n_chunks + c) * G_TILES * 32 + lane;
#pragma unroll
    for (int kj = 0; kj < CH / 8; ++kj) {
      const int j0 = 8 * kj;
      float4 gv[CH / 16];
#pragma unroll
      for (int mi = kj / 2; mi < CH / 16; ++mi) gv[mi] = Gc[(mi * (CH / 8) + kj) * 32];
      const float* xr = x_s + (j0 + t) * LD + p0 + g;
      const scan::FragB x0 = scan::frag_b(xr[0], xr[4 * LD]);
      const scan::FragB x1 = scan::frag_b(xr[8], xr[4 * LD + 8]);
      const float cj0 = cl_w[j0 + t], cj1 = cl_w[j0 + t + 4];
      const float dj0 = dt_s[j0 + t], dj1 = dt_s[j0 + t + 4];
#pragma unroll
      for (int mi = kj / 2; mi < CH / 16; ++mi) {
        const int i0 = 16 * mi + g, i1 = i0 + 8;
        const float ci0 = cl_w[i0], ci1 = cl_w[i1];
        auto m = [](float gij, int i, int j, float ci, float cj, float dj) {
          return j <= i ? gij * scan::ex(fminf(ci - cj, 30.f)) * dj : 0.f;
        };
        const scan::FragA a = scan::frag_a(m(gv[mi].x, i0, j0 + t, ci0, cj0, dj0),
                                           m(gv[mi].y, i1, j0 + t, ci1, cj0, dj0),
                                           m(gv[mi].z, i0, j0 + t + 4, ci0, cj1, dj1),
                                           m(gv[mi].w, i1, j0 + t + 4, ci1, cj1, dj1));
        scan::mma(acc[mi][0], a, x0);
        scan::mma(acc[mi][1], a, x1);
      }
    }
#pragma unroll
    for (int mi = 0; mi < CH / 16; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int tt = t0 + 16 * mi + g + 8 * half;
        if (tt >= p.T) continue;
        float* yr = yb + (long long)tt * row + p0 + 2 * t;
        *reinterpret_cast<float2*>(yr) = make_float2(acc[mi][0][2 * half], acc[mi][0][2 * half + 1]);
        *reinterpret_cast<float2*>(yr + 8) =
            make_float2(acc[mi][1][2 * half], acc[mi][1][2 * half + 1]);
      }

    // S'[p0.., :] = e^cl_last S + sum_j (x_j w_j)[p] B_j
    const float decay = scan::ex(cl_last);
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) S[nt][q] *= decay;
#pragma unroll
    for (int kj = 0; kj < CH / 8; ++kj) {
      const int j0 = 8 * kj;
      const float w0 = w_w[j0 + t], w1 = w_w[j0 + t + 4];
      const float* xr = x_s + (j0 + t) * LD + p0 + g;
      const scan::FragA a = scan::frag_a(xr[0] * w0, xr[8] * w0, xr[4 * LD] * w1,
                                         xr[4 * LD + 8] * w1);
      const float* br = B_s + (j0 + t) * LD + g;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
        scan::mma(S[nt], a, scan::frag_b(br[8 * nt], br[4 * LD + 8 * nt]));
    }
  }

  float* s = p.s_out + ((long long)b * p.H + h) * P * N;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    *reinterpret_cast<float2*>(s + (p0 + g) * N + 8 * nt + 2 * t) = make_float2(S[nt][0], S[nt][1]);
    *reinterpret_cast<float2*>(s + (p0 + g + 8) * N + 8 * nt + 2 * t) =
        make_float2(S[nt][2], S[nt][3]);
  }
}


template <int P, int N, int NG>
int launch(const Params& p, cudaStream_t st) {
  using Sh = Shape<P, N>;
  ssd_gram_kernel<N, NG><<<dim3(p.n_chunks, p.Bt * NG), GRAM_THREADS, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_scan_kernel<P, N, NG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::SCAN_SMEM);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<P, N, NG><<<p.Bt * p.H, Sh::NTHREADS, Sh::SCAN_SMEM, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the workspace ssd_fwd needs: G for every (batch row, 32-row chunk); a
// call with G groups passes Bt * G rows.
long long ssd_workspace_floats(int Bt, int T) {
  return (long long)Bt * ((T + CH - 1) / CH) * G_TILES * 32 * 4;
}

// Returns a cudaError_t: 0 when both kernels were launched.  All tensors are contiguous
// fp32; (P, N) = (64, 64) or (32, 16) and chunk 128 are the compiled sizes (the kernel
// walks the chunk in four quarters), any other is refused; `work` holds
// ssd_workspace_floats(Bt, T) floats; s_chunks, if not null, receives the state before
// every 64 rows [Bt, ceil(T / 64), H, P, N]; B and C hold `groups` groups (1 or 2, a
// template parameter of both kernels), each read by H / groups consecutive heads.
int ssd_fwd(const float* x, const float* dt, const float* A, const float* Bm, const float* Cm,
            const float* s0, float* y, float* s_out, float* s_chunks, int Bt, int T, int H,
            int P_, int N_, int chunk, int groups, void* work, void* stream) {
  if (chunk != 128 || T <= 0 || groups < 1 || groups > 2 || H % groups)
    return cudaErrorInvalidValue;
  const int n_chunks = (T + CH - 1) / CH;
  const Params p{x,  dt,      A,  Bm, Cm, s0, y, s_out, s_chunks, static_cast<float4*>(work),
                 Bt, T, H, n_chunks, H / groups};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P_ == 64 && N_ == 64) return groups == 1 ? launch<64, 64, 1>(p, st) : launch<64, 64, 2>(p, st);
  if (P_ == 32 && N_ == 16) return groups == 1 ? launch<32, 16, 1>(p, st) : launch<32, 16, 2>(p, st);
  return cudaErrorInvalidValue;
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
