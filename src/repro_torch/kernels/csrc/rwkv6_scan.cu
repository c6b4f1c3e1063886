// Chunked RWKV6 WKV recurrence for Hopper (sm_90a), fp32, with a state in and out.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py::wkv6_fwd (body _wkv6_kernel,
// pallas_call at line 92), which starts from a zero state and returns y only; this one
// computes ref.rwkv6_chunked, the function the model calls: it takes the [B,H,K,V] state
// and writes the final one.
//
//   r, k, w [B,T,H,K], v [B,T,H,V], u [H,K], s0 [B,H,K,V] -> y [B,T,H,V], s_out [B,H,K,V]
//
// What bounds it on an H100 (SXM, published peaks at a 700 W power limit): at the
// rwkv6-1.6b prefill shape (B=4, T=2048, H=32, K=V=64, chunk 64) the inputs and
// outputs are 0.34 GB, 0.101 ms of device memory, while the work is 7.7e9 flops
// (0.115 ms at the 67 TFLOP/s fp32 rate) plus 5.8e8 exponentials and logarithms: the
// pairwise decays exp(cl_prev_i - cl_j) of the intra-chunk term are one exponential per
// (i, j < i, k), 2016 x 64 per chunk and head, and they run on the special-function
// units, at a fraction of the fp32 rate.  So it is bound by operations, the exponentials
// first.  What the design does about it:
//   * one block per (batch, head) with the chunk loop inside and the [K,V] state in
//     shared memory: the Pallas grid's sequential chunk axis becomes a loop, so nothing
//     carries between blocks;
//   * the [c,c,K] decay tensor D of the Pallas body (1 MB per chunk) is never formed:
//     each thread computes a 4x4 tile of att[i,j] = sum_k r_ik exp2(cl_prev_ik - cl_jk) k_jk
//     in registers, in log2 units, skipping masked (j >= i) tiles and pairs instead of
//     multiplying by a mask (an unclamped inf * 0 would be NaN); the difference of log
//     cumsums is kept, since factoring it through a chunk reference underflows;
//   * the u-bonus diagonal is written into att[i,i], so y = (r*e^cl_prev) S + att v is two
//     register-tiled products over shared-memory tiles, with the triangle's zero blocks
//     skipped; the state update is a third;
//   * the ragged last chunk is masked here (rows past T read as r = k = v = 0, w = 1),
//     which keeps the final state exact without padding in device memory;
//   * padded row strides keep every column walk free of bank conflicts.
// The exponentials are not shared between the K columns and tensor cores are not used:
// both are later work.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int NTHREADS = 256;               // 16 x 16 thread grid for every tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float CLAMP2 = 30.f * LOG2E;      // the reference's exponent clamp (30), in log2 units

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* s0;
  float* y;
  float* s_out;
  int B, T, H;
};

template <int CH, int D>
constexpr size_t smem_floats() {
  // S, r, k, v, cl, cl_prev, rd (log2 w, then r*e^cl_prev), kd: [.][D+1]; att: [CH][CH+1]; u
  return (size_t)D * (D + 1) + 7 * (size_t)CH * (D + 1) + (size_t)CH * (CH + 1) + D;
}

template <int CH, int D>
__global__ void __launch_bounds__(NTHREADS) wkv6_kernel(const Params p) {
  static_assert(CH % 16 == 0 && D % 16 == 0 && D <= NTHREADS && D + CH <= NTHREADS, "tiling");
  constexpr int LD = D + 1;
  constexpr int LDA = CH + 1;
  constexpr int RA = CH / 16;   // a thread's rows (and att columns): ty, ty+16, ...
  constexpr int DC = D / 16;    // a thread's value/key columns: tx, tx+16, ...
  extern __shared__ float smem[];
  float* S_s = smem;                  // [D][LD]   state, k rows x v columns
  float* r_s = S_s + D * LD;          // [CH][LD]
  float* k_s = r_s + CH * LD;
  float* v_s = k_s + CH * LD;
  float* cl_s = v_s + CH * LD;        // inclusive log2-decay cumsum
  float* clp_s = cl_s + CH * LD;      // exclusive
  float* rd_s = clp_s + CH * LD;      // log2 w, then r * 2^cl_prev
  float* kd_s = rd_s + CH * LD;       // k * 2^(cl_last - cl)
  float* att_s = kd_s + CH * LD;      // [CH][LDA]
  float* u_s = att_s + CH * LDA;      // [D]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const long long row_stride = (long long)p.H * D;         // one time step
  const long long base = ((long long)b * p.T * p.H + h) * D;
  const long long sbase = ((long long)b * p.H + h) * D * D;

  for (int idx = tid; idx < D * D; idx += NTHREADS)
    S_s[(idx / D) * LD + idx % D] = p.s0[sbase + idx];
  if (tid < D) u_s[tid] = p.u[(long long)h * D + tid];

  for (int t0 = 0; t0 < p.T; t0 += CH) {
    // (1) the chunk's rows; rows past T read as r = k = v = 0 and w = 1 (log2 w = 0)
    for (int idx = tid; idx < CH * D; idx += NTHREADS) {
      const int i = idx / D, c = idx % D, t = t0 + i;
      const int o = i * LD + c;
      if (t < p.T) {
        const long long g = base + t * row_stride + c;
        r_s[o] = p.r[g];
        k_s[o] = p.k[g];
        v_s[o] = p.v[g];
        rd_s[o] = log2f(fmaxf(p.w[g], 1e-30f));
      } else {
        r_s[o] = 0.f;
        k_s[o] = 0.f;
        v_s[o] = 0.f;
        rd_s[o] = 0.f;
      }
    }
    __syncthreads();

    // (2) log2-decay cumsums down each key column; the u-bonus diagonal att[i,i]
    if (tid < D) {
      float run = 0.f;
      for (int i = 0; i < CH; ++i) {
        clp_s[i * LD + tid] = run;
        run += rd_s[i * LD + tid];
        cl_s[i * LD + tid] = run;
      }
    } else if (tid < D + CH) {
      const int i = tid - D;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) acc = fmaf(r_s[i * LD + c] * u_s[c], k_s[i * LD + c], acc);
      att_s[i * LDA + i] = acc;
    }
    __syncthreads();

    // (3) att[i, j<i] in registers; r*2^cl_prev and k*2^(cl_last-cl) for (4) and (5)
    {
      float acc[RA][RA];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int bb = 0; bb < RA; ++bb) acc[a][bb] = 0.f;
      for (int c = 0; c < D; ++c) {
        float ri[RA], pi[RA], cj[RA], kj[RA];
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          ri[a] = r_s[(ty + 16 * a) * LD + c];
          pi[a] = clp_s[(ty + 16 * a) * LD + c];
          cj[a] = cl_s[(tx + 16 * a) * LD + c];
          kj[a] = k_s[(tx + 16 * a) * LD + c];
        }
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int bb = 0; bb <= a; ++bb)
            if (bb < a || tx < ty)
              acc[a][bb] = fmaf(ri[a] * kj[bb], exp2f(fminf(pi[a] - cj[bb], CLAMP2)), acc[a][bb]);
      }
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int bb = 0; bb < RA; ++bb) {
          const int i = ty + 16 * a, j = tx + 16 * bb;
          if (j != i) att_s[i * LDA + j] = j < i ? acc[a][bb] : 0.f;
        }
    }
    for (int idx = tid; idx < CH * D; idx += NTHREADS) {
      const int i = idx / D, c = idx % D, o = i * LD + c;
      rd_s[o] = r_s[o] * exp2f(clp_s[o]);
      kd_s[o] = k_s[o] * exp2f(fminf(cl_s[(CH - 1) * LD + c] - cl_s[o], CLAMP2));
    }
    __syncthreads();

    // (4) y = (r * 2^cl_prev) S + att v, rows ty+16a, value columns tx+16bb
    {
      float acc[RA][DC];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int bb = 0; bb < DC; ++bb) acc[a][bb] = 0.f;
      for (int c = 0; c < D; ++c) {
        float rv[RA], sv[DC];
#pragma unroll
        for (int a = 0; a < RA; ++a) rv[a] = rd_s[(ty + 16 * a) * LD + c];
#pragma unroll
        for (int bb = 0; bb < DC; ++bb) sv[bb] = S_s[c * LD + tx + 16 * bb];
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int bb = 0; bb < DC; ++bb) acc[a][bb] = fmaf(rv[a], sv[bb], acc[a][bb]);
      }
      // att is zero above the diagonal: rows below 16*jb see nothing of key block jb
      for (int jb = 0; jb < RA; ++jb) {
        for (int jj = 0; jj < 16; ++jj) {
          const int j = 16 * jb + jj;
          float vv[DC];
#pragma unroll
          for (int bb = 0; bb < DC; ++bb) vv[bb] = v_s[j * LD + tx + 16 * bb];
#pragma unroll
          for (int a = 0; a < RA; ++a) {
            if (a < jb) continue;
            const float av = att_s[(ty + 16 * a) * LDA + j];
#pragma unroll
            for (int bb = 0; bb < DC; ++bb) acc[a][bb] = fmaf(av, vv[bb], acc[a][bb]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int t = t0 + ty + 16 * a;
        if (t >= p.T) continue;
        float* yr = p.y + base + t * row_stride;
#pragma unroll
        for (int bb = 0; bb < DC; ++bb) yr[tx + 16 * bb] = acc[a][bb];
      }
    }

    // (5) S' = 2^cl_last * S + sum_j kd_j v_j^T, rows (keys) ty+16a, columns tx+16bb
    {
      float acc[DC][DC];
#pragma unroll
      for (int a = 0; a < DC; ++a) {
        const float dec = exp2f(cl_s[(CH - 1) * LD + ty + 16 * a]);
#pragma unroll
        for (int bb = 0; bb < DC; ++bb) acc[a][bb] = dec * S_s[(ty + 16 * a) * LD + tx + 16 * bb];
      }
      for (int j = 0; j < CH; ++j) {
        float kv[DC], vv[DC];
#pragma unroll
        for (int a = 0; a < DC; ++a) kv[a] = kd_s[j * LD + ty + 16 * a];
#pragma unroll
        for (int bb = 0; bb < DC; ++bb) vv[bb] = v_s[j * LD + tx + 16 * bb];
#pragma unroll
        for (int a = 0; a < DC; ++a)
#pragma unroll
          for (int bb = 0; bb < DC; ++bb) acc[a][bb] = fmaf(kv[a], vv[bb], acc[a][bb]);
      }
      __syncthreads();          // every read of S, v, att, rd, kd of this chunk is done
#pragma unroll
      for (int a = 0; a < DC; ++a)
#pragma unroll
        for (int bb = 0; bb < DC; ++bb) S_s[(ty + 16 * a) * LD + tx + 16 * bb] = acc[a][bb];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < D * D; idx += NTHREADS)
    p.s_out[sbase + idx] = S_s[(idx / D) * LD + idx % D];
}

template <int CH, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<CH, D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wkv6_kernel<CH, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wkv6_kernel<CH, D><<<p.B * p.H, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the kernel was launched.  All tensors are contiguous
// fp32; K = V = head (64) and chunk (64) are the compiled sizes.
int wkv6_fwd(const float* r, const float* k, const float* v, const float* w, const float* u,
             const float* s0, float* y, float* s_out, int B, int T, int H, int head, int chunk,
             void* stream) {
  if (head != 64 || chunk != 64) return cudaErrorInvalidValue;
  const Params p{r, k, v, w, u, s0, y, s_out, B, T, H};
  return launch<64, 64>(p, static_cast<cudaStream_t>(stream));
}

const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
