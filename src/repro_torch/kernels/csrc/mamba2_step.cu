// One decode step of a Mamba2 layer, fused, for Hopper (sm_90a): the published
// Zamba2 block's layer on the serving path, from its in_proj's output to its
// out_proj's input.
//
// Replaces no TPU kernel: the JAX package's decode step is the per-step recurrence
// ref.mamba2_naive in jnp.  The port's plain version is ref.mamba2_step, which
// PyTorch runs as about 27 launches a layer (the causal conv's update, SiLU, dt's
// softplus, the state's decay and outer-product update, y = s C, D x, the gated
// group norm); a decode step of the 81-layer model issued about 2,900 launches and
// the host, not the card, set its pace.  This kernel is all of it in one launch:
//
//   u [B, W] bf16, W = 2 din + 2 G N + H: z | x | B | C | dt of one token
//   conv_state [B, C, K-1] bf16 (C = din + 2 G N), conv_w [K, C], conv_b [C] bf16
//   dt_bias, A (= -exp(A_log)), D [H] fp32; state [B, H, P, N] fp32
//   norm_w [din] bf16
//   xBC' = silu(conv(conv_state | xBC) + b)          (conv_state <- its last K-1)
//   dt = softplus(dt + dt_bias); s = e^(A dt) s + dt x B^T; y = s C + D x
//   out = norm_w * RMS_group(y * silu(z))            -> out [B, din] bf16
//   head h reads group g = h / (H/G) of B and C; conv_state and state in place
//
// What bounds it on an H100: the fp32 state, read and written once (2 P N 4 bytes
// a head: 117 MB a layer at B 32, H 112, P = N = 64), against 4 P N flops a head:
// device memory's 3.35 TB/s.  The design:
//   * one block of 128 threads per (head, batch row); the state's P x N read and
//     written once as float4s, a warp's 32 loads one contiguous 512 bytes (thread t
//     takes float4 t + 128 j: N/4 lanes a row, P/(512/N) rows a thread), each row's
//     product with C summed over its lanes by shuffles;
//   * the block computes the conv of its head's P x channels and of its group's
//     2 N B and C channels (the group's H/G blocks each compute those 2 N again:
//     a few hundred flops) from the old conv state, and writes the new state of its
//     x channels; the B and C channels' new state is written by the group's last
//     block, once every block of the group has read the old one;
//   * the gated norm needs the whole group's sum of squares: each block writes its
//     y * silu(z) and its partial sum, and the group's last block (an atomic ticket,
//     reset to 0 after) sums the partials in a fixed order (the same sum every run)
//     and writes the group's output, 4 channels a thread at a time; the rounding
//     points are the plain version's
//     (the conv's and SiLU's outputs in bf16, the norm's output in bf16 before the
//     weight).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int K = 4;          // conv width
constexpr int NT = 128;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const __nv_bfloat16* u;
  __nv_bfloat16* conv_state;
  const __nv_bfloat16* conv_w;
  const __nv_bfloat16* conv_b;
  const float* dt_bias;
  const float* A;
  const float* D;
  float* state;
  const __nv_bfloat16* norm_w;
  __nv_bfloat16* out;
  float* v;                   // [B, din] y * silu(z), for the group's last block
  float* psum;                // [B, H] each head's sum of squares of v
  int* count;                 // [B, G] tickets, 0 on entry and on exit
  int B, H, G, din;
  float eps;
};

__device__ __forceinline__ float bf(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf(float x) { return bf(__float2bfloat16(x)); }
__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

template <int P, int N>
__global__ void __launch_bounds__(NT) mamba2_step_kernel(const Params p) {
  constexpr int LPR = N / 4;              // lanes a state row (float4 columns)
  constexpr int RPI = NT / LPR;           // rows a pass of the block
  constexpr int PASSES = P / RPI;
  static_assert(N % 4 == 0 && 32 % LPR == 0 && P % RPI == 0, "(P, N)");
  __shared__ float xs[P], zs[P], bs[N], cs[N], red[NT / 32];
  __shared__ int is_last;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int hpg = p.H / p.G, g = h / hpg;
  const int gn = p.G * N, C = p.din + 2 * gn, W = 2 * p.din + 2 * gn + p.H;
  const __nv_bfloat16* ub = p.u + (long long)b * W;
  const __nv_bfloat16* xbc = ub + p.din;
  __nv_bfloat16* cst = p.conv_state + (long long)b * C * (K - 1);

  // conv over the head's x channels and the group's B, C channels, from the old state
  for (int i = tid; i < P + 2 * N; i += NT) {
    const int c = i < P ? h * P + i
                        : p.din + (i < P + N ? g * N + i - P : gn + g * N + i - P - N);
    float old[K - 1];
#pragma unroll
    for (int k = 0; k < K - 1; ++k) old[k] = bf(cst[c * (K - 1) + k]);
    const float now = bf(xbc[c]);
    float acc = bf(p.conv_b[c]);
#pragma unroll
    for (int k = 0; k < K - 1; ++k) acc = fmaf(bf(p.conv_w[k * C + c]), old[k], acc);
    acc = fmaf(bf(p.conv_w[(K - 1) * C + c]), now, acc);
    const float out = round_bf(silu(round_bf(acc)));
    if (i < P) {
      xs[i] = out;
#pragma unroll
      for (int k = 0; k < K - 2; ++k) cst[c * (K - 1) + k] = __float2bfloat16(old[k + 1]);
      cst[c * (K - 1) + K - 2] = xbc[c];
    } else if (i < P + N) {
      bs[i - P] = out;
    } else {
      cs[i - P - N] = out;
    }
  }
  for (int i = tid; i < P; i += NT) zs[i] = bf(ub[h * P + i]);
  __syncthreads();

  const float xr = bf(ub[2 * p.din + 2 * gn + h]) + p.dt_bias[h];
  const float dt = xr > 20.f ? xr : log1pf(expf(xr));
  const float dA = expf(p.A[h] * dt);
  const int lane = tid % LPR, n0 = 4 * lane;
  const float b0 = bs[n0], b1 = bs[n0 + 1], b2 = bs[n0 + 2], b3 = bs[n0 + 3];
  const float c0 = cs[n0], c1 = cs[n0 + 1], c2 = cs[n0 + 2], c3 = cs[n0 + 3];
  float4* s = reinterpret_cast<float4*>(p.state + ((long long)b * p.H + h) * P * N);
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < PASSES; ++j) {
    const int f = tid + NT * j, row = f / LPR;
    float4 v4 = s[f];
    const float xdt = xs[row] * dt;
    v4.x = fmaf(xdt, b0, v4.x * dA);
    v4.y = fmaf(xdt, b1, v4.y * dA);
    v4.z = fmaf(xdt, b2, v4.z * dA);
    v4.w = fmaf(xdt, b3, v4.w * dA);
    s[f] = v4;
    float dot = fmaf(v4.w, c3, fmaf(v4.z, c2, fmaf(v4.y, c1, v4.x * c0)));
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
    if (lane == 0) {
      const float gated = (dot + p.D[h] * xs[row]) * silu(zs[row]);
      p.v[(long long)b * p.din + h * P + row] = gated;
      sq = fmaf(gated, gated, sq);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(FULL, sq, o);
  if ((tid & 31) == 0) red[tid >> 5] = sq;
  __threadfence();                 // v visible to the group's last block
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) tot += red[w];
    p.psum[(long long)b * p.H + h] = tot;
    __threadfence();
    is_last = atomicAdd(&p.count[b * p.G + g], 1) == hpg - 1;
  }
  __syncthreads();
  if (!is_last) return;

  // the group's last block: the norm over its din / G channels, and B, C's new conv state
  __threadfence();
  float part = 0.f;                // the group's partial sums, a fixed thread each
  for (int j = tid; j < hpg; j += NT) part += __ldcg(p.psum + (long long)b * p.H + g * hpg + j);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
  __syncthreads();
  if ((tid & 31) == 0) red[tid >> 5] = part;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) tot += red[w];
  const int gs = p.din / p.G;
  const float rinv = rsqrtf(tot / gs + p.eps);
  const long long base = (long long)b * p.din + g * gs;
  for (int c = 4 * tid; c < gs; c += 4 * NT) {
    const float4 v4 = __ldcg(reinterpret_cast<const float4*>(p.v + base + c));
    const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p.out[base + c + e] = __float2bfloat16(round_bf(vv[e] * rinv) * bf(p.norm_w[g * gs + c + e]));
  }
  for (int i = tid; i < 2 * N; i += NT) {
    const int c = p.din + (i < N ? g * N + i : gn + g * N + i - N);
#pragma unroll
    for (int k = 0; k < K - 2; ++k) cst[c * (K - 1) + k] = cst[c * (K - 1) + k + 1];
    cst[c * (K - 1) + K - 2] = xbc[c];
  }
  if (tid == 0) p.count[b * p.G + g] = 0;
}

template <int P, int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  mamba2_step_kernel<P, N><<<dim3(p.H, p.B), NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the kernel was launched.  (P, N) = (64, 64) or
// (32, 16); conv width 4; every tensor contiguous, the state and v 16-byte aligned, the
// channels of a group a multiple of 4; v holds B * din floats, psum B * H, count B * G
// ints, all 0.
int mamba2_step(const void* u, void* conv_state, const void* conv_w, const void* conv_b,
                const float* dt_bias, const float* A, const float* D, float* state,
                const void* norm_w, void* out, float* v, float* psum, int* count, int B, int H,
                int G, int din, int P_, int N_, float eps, void* stream) {
  if (B < 1 || G < 1 || H % G || din % (4 * G) || din != H * P_) return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const __nv_bfloat16*>(u), static_cast<__nv_bfloat16*>(conv_state),
                 static_cast<const __nv_bfloat16*>(conv_w),
                 static_cast<const __nv_bfloat16*>(conv_b), dt_bias, A, D, state,
                 static_cast<const __nv_bfloat16*>(norm_w), static_cast<__nv_bfloat16*>(out),
                 v, psum, count, B, H, G, din, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P_ == 64 && N_ == 64) return (int)launch<64, 64>(p, s);
  if (P_ == 32 && N_ == 16) return (int)launch<32, 16>(p, s);
  return (int)cudaErrorInvalidValue;
}

const char* mamba2_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
