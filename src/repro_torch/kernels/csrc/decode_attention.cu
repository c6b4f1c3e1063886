// One-token GQA decode attention over a bf16 K/V cache, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's decode attention,
// src/repro/models/layers.py::attention_decode, is plain jnp einsums that XLA fuses.
// The port's plain path (repro_torch/models/layers.py::attention_decode, kept for the
// CPU, the int8 cache and the sequence split) takes its einsums through PyTorch, which
// copies every layer's whole K and V cache into another layout on every step, all
// Smax slots and not only the valid ones, before two bmm read the copies again.  This
// kernel computes the same function from the cache as it lies:
//
//   q [B,1,H,hd] (bf16 or fp32), k/v [B,Smax,KV,hd] bf16, H = KV*G, G <= 8
//   out[b,h] = softmax_j(scale * q[b,h] . k[b,j,h/G]) . v[b,j,h/G] over j < n_valid,
//   scale the caller's or 1/sqrt(hd)
//   -> out [B,1,H,hd] in q's dtype
//
// Slots at or past n_valid are never read (the SWA ring's validity is the same prefix).
//
// What bounds it on an H100: each valid slot's K and V rows are read once and cost
// 4*G*hd flops against 4*hd bytes, G flops a byte (G = 1 for MHA), far below the
// 67 TFLOP/s fp32 rate's 20 flops a byte: device memory's 3.35 TB/s bounds it.  The
// design streams the valid rows once at full width:
//   * one block per (split of the valid slots, kv head, batch row); the block holds
//     the G query heads of its kv head, so each K/V row is read once for the group.
//     The wrapper picks the number of splits from B*KV and n_valid so that the grid
//     holds at least two blocks for every SM (decode_attention.py: splits): one
//     split at minicpm-2b's decode cell (B*KV = 1,152), several at small batches;
//   * K/V tiles of TS slots come in through 16-byte cp.async into a ring of STAGES
//     shared-memory stages (2 tiles in flight while the third is consumed); rows past
//     the slice are zero-filled by the copy without a read;
//   * LPS lanes share a slot, each holding 8 columns (one 16-byte chunk) of q, so a
//     warp reads 512 contiguous bytes of a tile at once; the dot products are summed
//     over the LPS lanes by shuffles (a whole warp a slot at hd 224, 28 of its lanes
//     reading), with q pre-scaled by log2(e) * scale so that
//     the online softmax runs in base 2 (one ex2 a score), all in fp32;
//   * each of the block's NSL slot lanes keeps its own running (max, sum, out) over
//     its slots; the block merges them in shared memory at the end and, with one
//     split, writes out in q's dtype; with several, it writes fp32 (out, max, sum) to
//     the wrapper's scratch and decode_attn_combine merges the splits (2 launches).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int NTHREADS = 128;
constexpr int STAGES = 3;      // 16 KB a stage: 48 KB, the default dynamic shared-memory limit
constexpr int SPL = 4;         // slots of a tile that each slot lane takes
constexpr int MAX_G = 8;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;              // [B, H, hd], bf16 or fp32 (q_bf16)
  const __nv_bfloat16* k;     // [B, smax, KV, hd]
  const __nv_bfloat16* v;
  void* out;                  // [B, H, hd], q's dtype
  float* part;                // [B, KV, nsplit, G, hd + 2]: out, max, sum (nsplit > 1)
  int B, smax, KV, G, n_valid, nsplit, slice;   // slice: slots a split, a multiple of TS
  int q_bf16;
  float scale_log2;           // log2(e) * the softmax scale
};

template <int HD>
struct Cfg {
  static constexpr int CH = HD / 8;                                  // 16-byte chunks a row
  static constexpr int LPS = CH <= 4 ? 4 : (CH <= 8 ? 8 : (CH <= 16 ? 16 : 32));   // lanes a slot
  static constexpr int NSL = NTHREADS / LPS;                         // slot lanes a block
  static constexpr int TS = NSL * SPL;                               // slots a tile
  static constexpr int STAGE = 2 * TS * HD;                          // bf16 of a stage: K, V
  static constexpr int SMEM = STAGES * STAGE * 2;
  static_assert(HD % 8 == 0 && CH <= 32, "head dim");
  static_assert(SMEM <= 48 * 1024, "above the default dynamic shared-memory limit");
  static_assert(NSL * MAX_G * (HD + 2) * 4 <= SMEM, "the block's merge reuses the ring");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with in == false, 16 zero bytes and no read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit, one instruction (relative error ~2^-22); 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void bf16x8(const uint4 u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <int HD, int GT>
__global__ void __launch_bounds__(NTHREADS) decode_attn_tiles(const Params p) {
  using C = Cfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, sl = tid / C::LPS, c = tid % C::LPS;
  const bool lane_on = c < C::CH;                  // hd 112: 14 of a slot's 16 lanes; 224: 28 of 32
  const int s0 = split * p.slice;
  const int n = min(p.slice, p.n_valid - s0);      // this split's slots, >= 1
  const int ntiles = (n + C::TS - 1) / C::TS;
  const long long row = (long long)p.KV * HD;      // elements from one slot to the next
  const long long first = ((long long)b * p.smax + s0) * row + (long long)kvh * HD;
  const __nv_bfloat16* kb = p.k + first;
  const __nv_bfloat16* vb = p.v + first;

  auto load_tile = [&](int t) {
    __nv_bfloat16* ks = ring + (t % STAGES) * C::STAGE;
    __nv_bfloat16* vs = ks + C::TS * HD;
    for (int idx = tid; idx < C::TS * C::CH; idx += NTHREADS) {
      const int r = idx / C::CH, ch = idx % C::CH, slot = t * C::TS + r;
      const bool in = slot < n;
      const long long off = (in ? (long long)slot * row : 0) + ch * 8;
      cp_async16(ks + r * HD + ch * 8, kb + off, in);
      cp_async16(vs + r * HD + ch * 8, vb + off, in);
    }
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_commit();
  }

  // this lane's 8 columns of each query head of the group, scaled into base 2
  float qf[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[g][e] = 0.f;
    if (g < p.G && lane_on) {
      const long long at = ((long long)(b * p.KV + kvh) * p.G + g) * HD + c * 8;
      if (p.q_bf16) {
        bf16x8(*reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.q) + at),
               qf[g]);
      } else {
        const float4* q4 = reinterpret_cast<const float4*>(static_cast<const float*>(p.q) + at);
        const float4 a = q4[0], b4 = q4[1];
        qf[g][0] = a.x, qf[g][1] = a.y, qf[g][2] = a.z, qf[g][3] = a.w;
        qf[g][4] = b4.x, qf[g][5] = b4.y, qf[g][6] = b4.z, qf[g][7] = b4.w;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[g][e] *= p.scale_log2;
    }
  }

  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_wait<STAGES - 2>();
    __syncthreads();                               // tile t landed; tile t - 1 consumed
    if (t + STAGES - 1 < ntiles) load_tile(t + STAGES - 1);
    cp_commit();
    const __nv_bfloat16* ks = ring + (t % STAGES) * C::STAGE;
    const __nv_bfloat16* vs = ks + C::TS * HD;

    float s[SPL][GT];                              // scores, then probabilities
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      float kf[8];
      if (lane_on) {
        bf16x8(*reinterpret_cast<const uint4*>(ks + (i * C::NSL + sl) * HD + c * 8), kf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qf[g][e], kf[e], d);
        s[i][g] = d;
      }
    }
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const bool valid = t * C::TS + i * C::NSL + sl < n;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int off = C::LPS / 2; off > 0; off >>= 1) s[i][g] += __shfl_xor_sync(FULL, s[i][g], off);
        if (!valid) s[i][g] = -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mt = s[0][g];
#pragma unroll
      for (int i = 1; i < SPL; ++i) mt = fmaxf(mt, s[i][g]);
      const float mn = fmaxf(m[g], mt);
      if (mn == -INFINITY) {                       // no valid slot yet in this lane
#pragma unroll
        for (int i = 0; i < SPL; ++i) s[i][g] = 0.f;
        continue;
      }
      const float alpha = ex2(m[g] - mn);          // 0 while m is -inf
      m[g] = mn;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        s[i][g] = ex2(s[i][g] - mn);
        l[g] += s[i][g];
      }
    }
    if (lane_on) {
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        float vf[8];
        bf16x8(*reinterpret_cast<const uint4*>(vs + (i * C::NSL + sl) * HD + c * 8), vf);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(s[i][g], vf[e], acc[g][e]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                                 // the ring is free for the merge

  // merge the slot lanes: red [NSL][GT][HD], then max and sum [GT][NSL]
  float* red = reinterpret_cast<float*>(smem);
  float* red_m = red + C::NSL * GT * HD;
  float* red_l = red_m + GT * C::NSL;
  if (lane_on) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float4* dst = reinterpret_cast<float4*>(red + (sl * GT + g) * HD + c * 8);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  if (c == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      red_m[g * C::NSL + sl] = m[g];
      red_l[g * C::NSL + sl] = l[g];
    }
  }
  __syncthreads();
  for (int o = tid; o < p.G * HD; o += NTHREADS) {
    const int g = o / HD, d = o % HD;
    float M = -INFINITY;
    for (int j = 0; j < C::NSL; ++j) M = fmaxf(M, red_m[g * C::NSL + j]);
    float L = 0.f, A = 0.f;
    for (int j = 0; j < C::NSL; ++j) {
      const float mj = red_m[g * C::NSL + j];
      if (mj == -INFINITY) continue;               // a lane with no valid slot
      const float w = ex2(mj - M);
      L += red_l[g * C::NSL + j] * w;
      A += red[(j * GT + g) * HD + d] * w;
    }
    const long long r = (long long)(b * p.KV + kvh) * p.G + g;   // the query head's row
    if (p.nsplit == 1) {
      if (p.q_bf16) {
        static_cast<__nv_bfloat16*>(p.out)[r * HD + d] = __float2bfloat16(A / L);
      } else {
        static_cast<float*>(p.out)[r * HD + d] = A / L;
      }
    } else {
      float* dst = p.part + (((long long)(b * p.KV + kvh) * p.nsplit + split) * p.G + g) * (HD + 2);
      dst[d] = A;
      if (d == 0) {
        dst[HD] = M;
        dst[HD + 1] = L;
      }
    }
  }
}

// out[r, d] = sum_s part_s[d] 2^(m_s - M) / sum_s l_s 2^(m_s - M), one thread an element
template <int HD>
__global__ void __launch_bounds__(256) decode_attn_combine(const Params p) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (long long)p.B * p.KV * p.G * HD) return;
  const int d = (int)(idx % HD);
  const long long r = idx / HD;                    // (b * KV + kvh) * G + g
  const long long bk = r / p.G;
  const int g = (int)(r % p.G);
  const float* base = p.part + (bk * p.nsplit * p.G + g) * (HD + 2);
  const long long step = (long long)p.G * (HD + 2);
  float M = -INFINITY;
  for (int s = 0; s < p.nsplit; ++s) M = fmaxf(M, base[s * step + HD]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < p.nsplit; ++s) {
    const float w = ex2(base[s * step + HD] - M);
    L += base[s * step + HD + 1] * w;
    A += base[s * step + d] * w;
  }
  if (p.q_bf16) {
    static_cast<__nv_bfloat16*>(p.out)[idx] = __float2bfloat16(A / L);
  } else {
    static_cast<float*>(p.out)[idx] = A / L;
  }
}

template <int HD, int GT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  decode_attn_tiles<HD, GT><<<dim3(p.nsplit, p.KV, p.B), NTHREADS, Cfg<HD>::SMEM, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return err;
  const long long total = (long long)p.B * p.KV * p.G * HD;
  decode_attn_combine<HD><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_g(const Params& p, cudaStream_t stream) {
  if (p.G == 1) return launch<HD, 1>(p, stream);
  if (p.G <= 2) return launch<HD, 2>(p, stream);
  if (p.G <= 4) return launch<HD, 4>(p, stream);
  return launch<HD, 8>(p, stream);
}

int tile_of(int hd) {
  switch (hd) {
    case 32: return Cfg<32>::TS;
    case 64: return Cfg<64>::TS;
    case 112: return Cfg<112>::TS;
    case 128: return Cfg<128>::TS;
    case 224: return Cfg<224>::TS;
    default: return 0;
  }
}

}  // namespace

extern "C" {

// Slots a tile of the kernel at head dim hd (0: hd not compiled); a split's slots
// are a multiple of it.
int decode_attention_tile(int hd) { return tile_of(hd); }

// Returns a cudaError_t: 0 when the kernels were launched.  q, k, v, out contiguous
// and 16-byte aligned; split s takes slots [s * slice, min((s + 1) * slice, n_valid)),
// each non-empty; part is fp32 scratch of B*KV*nsplit*G*(hd + 2) (unused with one
// split); scale is the softmax scale, 1/sqrt(hd) where it is 0.
int decode_attention(const void* q, const void* k, const void* v, void* out, float* part,
                     int q_bf16, int B, int smax, int KV, int G, int hd, int n_valid,
                     int nsplit, int slice, float scale, void* stream) {
  const int ts = tile_of(hd);
  if (ts == 0 || G < 1 || G > MAX_G || n_valid < 1 || n_valid > smax || nsplit < 1 ||
      slice < ts || slice % ts != 0 || (long long)(nsplit - 1) * slice >= n_valid ||
      (long long)nsplit * slice < n_valid || (nsplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{q, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), out,
           part, B, smax, KV, G, n_valid, nsplit, slice, q_bf16,
           scale > 0.f ? 1.4426950408889634f * scale : 1.4426950408889634f / sqrtf((float)hd)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return (int)dispatch_g<32>(p, s);
    case 64: return (int)dispatch_g<64>(p, s);
    case 112: return (int)dispatch_g<112>(p, s);
    case 224: return (int)dispatch_g<224>(p, s);
    default: return (int)dispatch_g<128>(p, s);
  }
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
