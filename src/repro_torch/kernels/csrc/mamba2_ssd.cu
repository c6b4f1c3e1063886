// Chunked Mamba2 SSD scan for Hopper (sm_90a), fp32, with a state in and out.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_ssd.py::ssd_fwd (body _ssd_kernel,
// pallas_call at line 88), which starts from a zero state and returns y only; this one
// computes ref.mamba2_ssd, the function the model calls: it takes the [Bt,H,P,N] state
// and writes the final one.
//
//   x [Bt,T,H,P], dt [Bt,T,H], A [H], B/C [Bt,T,N], s0 [Bt,H,P,N]
//     -> y [Bt,T,H,P], s_out [Bt,H,P,N]
//
// What bounds it on an H100 (SXM, published peaks at a 700 W power limit): at the
// zamba2-7b prefill shape (Bt=4, T=2048, H=112, P=N=64, chunk 128) it moves 0.49 GB
// (x and y dominate: 0.147 ms of device memory) and does 2.3e10 flops (0.345 ms at the
// 67 TFLOP/s fp32 rate): per chunk and head the carried-state term C S^T, the causal
// intra-chunk product M x and the rank-c state update are 1e6 flops each, so it is
// bound by operations.  What the design does about it:
//   * one block per (batch, head) with the chunk loop inside and the [P,N] state in
//     shared memory: the Pallas grid's sequential chunk axis becomes a loop, and the
//     448 blocks of the main shape fill the card's 132 SMs;
//   * B and C are read by batch, where the Pallas wrapper broadcasts them to every head
//     in device memory; the x, B, C tiles (32 KB each) and M = (C B^T) * exp(cl_i - cl_j)
//     * dt_j (a [128,128] tile, 64 KB) stay in shared memory, 184 KB in all;
//   * every product is register-tiled (a 16 x 16 thread grid, each thread an 8x8, 8x4 or
//     4x4 tile over shared-memory tiles with padded, conflict-free strides), and the
//     blocks of the causal triangle that are all zero are skipped, not multiplied;
//   * masked pairs are skipped instead of multiplied by a mask, and the ragged last
//     chunk is masked here (rows past T read as x = B = C = dt = 0), which keeps the
//     final state exact without padding in device memory.
// C B^T does not depend on the head, yet each block recomputes it (a third more flops
// than the bound counts), and tensor cores are not used: both are later work.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int NTHREADS = 256;   // 16 x 16 thread grid for every tile

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  const float* s0;
  float* y;
  float* s_out;
  int Bt, T, H;
};

template <int CH, int P, int N>
constexpr size_t smem_floats() {
  // x [CH][P+1], B/C [CH][N+1], M [CH][CH+1], S [P][N+1], cl/dt/w [CH]
  return (size_t)CH * (P + 1) + 2 * (size_t)CH * (N + 1) + (size_t)CH * (CH + 1) +
         (size_t)P * (N + 1) + 3 * CH;
}

template <int CH, int P, int N>
__global__ void __launch_bounds__(NTHREADS) ssd_kernel(const Params p) {
  static_assert(CH == 128 && P % 16 == 0 && N % 16 == 0, "tiling");
  constexpr int LDP = P + 1, LDN = N + 1, LDM = CH + 1;
  constexpr int RA = CH / 16;   // a thread's chunk rows (and M columns): ty, ty+16, ...
  constexpr int PC = P / 16;
  constexpr int NC = N / 16;
  extern __shared__ float smem[];
  float* x_s = smem;                 // [CH][LDP]
  float* B_s = x_s + CH * LDP;       // [CH][LDN]
  float* C_s = B_s + CH * LDN;       // [CH][LDN]
  float* M_s = C_s + CH * LDN;       // [CH][LDM]
  float* S_s = M_s + CH * LDM;       // [P][LDN]
  float* cl_s = S_s + P * LDN;       // [CH] inclusive cumsum of A*dt
  float* dt_s = cl_s + CH;           // [CH]
  float* w_s = dt_s + CH;            // [CH] exp(cl_last - cl_j) * dt_j

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const float A = p.A[h];
  const long long xbase = ((long long)b * p.T * p.H + h) * P;     // x/y row t: + t*H*P
  const long long bcbase = (long long)b * p.T * N;                // B/C row t: + t*N
  const long long sbase = ((long long)b * p.H + h) * P * N;

  for (int idx = tid; idx < P * N; idx += NTHREADS)
    S_s[(idx / N) * LDN + idx % N] = p.s0[sbase + idx];

  for (int t0 = 0; t0 < p.T; t0 += CH) {
    // (1) the chunk's rows; rows past T read as zeros (dt = 0: no decay, no input)
    for (int idx = tid; idx < CH * P; idx += NTHREADS) {
      const int i = idx / P, c = idx % P, t = t0 + i;
      x_s[i * LDP + c] = t < p.T ? p.x[xbase + (long long)t * p.H * P + c] : 0.f;
    }
    for (int idx = tid; idx < CH * N; idx += NTHREADS) {
      const int i = idx / N, c = idx % N, t = t0 + i;
      const bool in = t < p.T;
      B_s[i * LDN + c] = in ? p.Bm[bcbase + (long long)t * N + c] : 0.f;
      C_s[i * LDN + c] = in ? p.Cm[bcbase + (long long)t * N + c] : 0.f;
    }
    if (tid < CH) {
      const int t = t0 + tid;
      dt_s[tid] = t < p.T ? p.dt[((long long)b * p.T + t) * p.H + h] : 0.f;
    }
    __syncthreads();

    // (2) cl = cumsum(A*dt) by one warp (4 rows a lane), then w_j = e^(cl_last-cl_j)*dt_j
    if (tid < 32) {
      float v[CH / 32];
      float run = 0.f;
#pragma unroll
      for (int q = 0; q < CH / 32; ++q) {
        run += A * dt_s[tid * (CH / 32) + q];
        v[q] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      const float last = __shfl_sync(0xffffffffu, v[CH / 32 - 1] + excl, 31);   // cl[CH-1]
#pragma unroll
      for (int q = 0; q < CH / 32; ++q) {
        const int i = tid * (CH / 32) + q;
        cl_s[i] = v[q] + excl;
        w_s[i] = expf(fminf(last - (v[q] + excl), 30.f)) * dt_s[i];
      }
    }
    __syncthreads();

    // (3) M[i,j] = (C_i . B_j) * e^(cl_i - cl_j) * dt_j for j <= i, else 0
    {
      float acc[RA][RA];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int bb = 0; bb < RA; ++bb) acc[a][bb] = 0.f;
      for (int n = 0; n < N; ++n) {
        float ci[RA], bj[RA];
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          ci[a] = C_s[(ty + 16 * a) * LDN + n];
          bj[a] = B_s[(tx + 16 * a) * LDN + n];
        }
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int bb = 0; bb <= a; ++bb) acc[a][bb] = fmaf(ci[a], bj[bb], acc[a][bb]);
      }
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int i = ty + 16 * a;
        const float cli = cl_s[i];
#pragma unroll
        for (int bb = 0; bb < RA; ++bb) {
          const int j = tx + 16 * bb;
          M_s[i * LDM + j] =
              j <= i ? acc[a][bb] * expf(fminf(cli - cl_s[j], 30.f)) * dt_s[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // (4) y = e^cl_i * (C_i S^T) + sum_{j<=i} M[i,j] x_j, rows ty+16a, columns tx+16bb
    {
      float acc[RA][PC];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int bb = 0; bb < PC; ++bb) acc[a][bb] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[RA], sv[PC];
#pragma unroll
        for (int a = 0; a < RA; ++a) cv[a] = C_s[(ty + 16 * a) * LDN + n];
#pragma unroll
        for (int bb = 0; bb < PC; ++bb) sv[bb] = S_s[(tx + 16 * bb) * LDN + n];
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int bb = 0; bb < PC; ++bb) acc[a][bb] = fmaf(cv[a], sv[bb], acc[a][bb]);
      }
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const float e = expf(cl_s[ty + 16 * a]);
#pragma unroll
        for (int bb = 0; bb < PC; ++bb) acc[a][bb] *= e;
      }
      // M is zero above the diagonal: rows below 16*jb see nothing of block jb
      for (int jb = 0; jb < RA; ++jb) {
        for (int jj = 0; jj < 16; ++jj) {
          const int j = 16 * jb + jj;
          float xv[PC];
#pragma unroll
          for (int bb = 0; bb < PC; ++bb) xv[bb] = x_s[j * LDP + tx + 16 * bb];
#pragma unroll
          for (int a = 0; a < RA; ++a) {
            if (a < jb) continue;
            const float m = M_s[(ty + 16 * a) * LDM + j];
#pragma unroll
            for (int bb = 0; bb < PC; ++bb) acc[a][bb] = fmaf(m, xv[bb], acc[a][bb]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int t = t0 + ty + 16 * a;
        if (t >= p.T) continue;
        float* yr = p.y + xbase + (long long)t * p.H * P;
#pragma unroll
        for (int bb = 0; bb < PC; ++bb) yr[tx + 16 * bb] = acc[a][bb];
      }
    }

    // (5) S' = e^cl_last * S + sum_j w_j x_j B_j^T, rows (p) ty+16a, columns (n) tx+16bb
    {
      float acc[PC][NC];
      const float dec = expf(cl_s[CH - 1]);
#pragma unroll
      for (int a = 0; a < PC; ++a)
#pragma unroll
        for (int bb = 0; bb < NC; ++bb) acc[a][bb] = dec * S_s[(ty + 16 * a) * LDN + tx + 16 * bb];
      for (int j = 0; j < CH; ++j) {
        const float wj = w_s[j];
        float xv[PC], bv[NC];
#pragma unroll
        for (int a = 0; a < PC; ++a) xv[a] = x_s[j * LDP + ty + 16 * a] * wj;
#pragma unroll
        for (int bb = 0; bb < NC; ++bb) bv[bb] = B_s[j * LDN + tx + 16 * bb];
#pragma unroll
        for (int a = 0; a < PC; ++a)
#pragma unroll
          for (int bb = 0; bb < NC; ++bb) acc[a][bb] = fmaf(xv[a], bv[bb], acc[a][bb]);
      }
      __syncthreads();          // every read of S, x, B, C, M of this chunk is done
#pragma unroll
      for (int a = 0; a < PC; ++a)
#pragma unroll
        for (int bb = 0; bb < NC; ++bb) S_s[(ty + 16 * a) * LDN + tx + 16 * bb] = acc[a][bb];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += NTHREADS)
    p.s_out[sbase + idx] = S_s[(idx / N) * LDN + idx % N];
}

template <int CH, int P, int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<CH, P, N>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<CH, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<CH, P, N><<<p.Bt * p.H, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the kernel was launched.  All tensors are contiguous
// fp32; P = N = 64 and chunk 128 are the compiled sizes.
int ssd_fwd(const float* x, const float* dt, const float* A, const float* Bm, const float* Cm,
            const float* s0, float* y, float* s_out, int Bt, int T, int H, int P, int N,
            int chunk, void* stream) {
  if (P != 64 || N != 64 || chunk != 128) return cudaErrorInvalidValue;
  const Params p{x, dt, A, Bm, Cm, s0, y, s_out, Bt, T, H};
  return launch<128, 64, 64>(p, static_cast<cudaStream_t>(stream));
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
