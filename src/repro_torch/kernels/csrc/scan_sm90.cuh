// Tensor-core building blocks for the fp32 chunked scans and their backward
// (mamba2_ssd.cu, rwkv6_scan.cu, *_bwd.cu) on Hopper (sm_90a): fp32 products on the TF32 tensor cores by mma.sync m16n8k8, split
// 3xTF32; exponentials on the special-function unit; cp.async tile loads.
// Plain inline PTX; no CUTLASS.
//
// 3xTF32: each fp32 operand x is split into hi (x rounded to TF32's 19 bits) and
// lo = x - hi, and a product is accumulated in fp32 as lo.hi + hi.lo + hi.hi; the dropped
// lo.lo term and lo's own truncation are ~2^-21 of the product, so the result stays near
// fp32's rounding where one TF32 pass (10-bit mantissa) would leave ~5e-4.
//
// Fragments of mma.m16n8k8.row.col.tf32 (lane = 4 g + t, g = groupID 0..7, t = 0..3):
//   A [16 x 8] (m x k): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B [8 x 8]  (k x n): b0 (t, g), b1 (t+4, g)
//   C [16 x 8] (m x n): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// The k order inside one product is free as long as A and B agree.  A C tile reused as
// an A operand (a product's result feeding the next product) takes k slot t as column
// 2t and slot t+4 as column 2t+1 (`c_as_a`); its B operand then reads rows 2t, 2t+1.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace scan {

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- TF32 split

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// hi: x rounded to its top 19 bits (half an ulp of TF32 added to the magnitude, then
// truncated); lo = x - hi exactly, handed over as fp32 bits, whose low 13 bits the tensor
// cores ignore (a truncation of lo, 2^-21 of x at most)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// A from an accumulator tile, k slots (t, t+4) = columns (2t, 2t+1)
__device__ __forceinline__ FragA c_as_a(const float (&c)[4]) {
  return frag_a(c[0], c[2], c[1], c[3]);
}

// ---------------------------------------------------------------- exponentials

// 2^x, e^x and log2(x) on the special-function unit, results below 2^-126 flushed to zero
// (relative error ~2^-22).  The library's exp2f/expf take a slow path for results in
// fp32's subnormal range, which the decays of a scan reach all the time.
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float ex(float x) { return ex2(x * LOG2E); }   // e^x
__device__ __forceinline__ float lg2(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// ---------------------------------------------------------------- mma

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A B in fp32 (3xTF32, small terms first)
__device__ __forceinline__ void mma(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// ---------------------------------------------------------------- WKV6 log-decay cumsum

// In place: s[i][c] (64 x W, row stride LD; W a multiple of 8) holds w; afterwards the
// inclusive cumsum of log2(max(w, 1e-30)) down each column.  Rows at or past `valid`
// count as w = 1.  A warp takes 8 columns at a time: lane (rg, cs) sums rows
// 16rg..16rg+15 of column cs, then a shuffle scan across the four row groups.  The caller
// synchronises before and after.
template <int LD, int NTHREADS, int W>
__device__ __forceinline__ void log2_cumsum(float* s, int valid, int tid) {
  const int warp = tid >> 5, lane = tid & 31, rg = lane >> 3, cs = lane & 7;
#pragma unroll
  for (int c0 = 0; c0 < W; c0 += 8 * (NTHREADS / 32)) {
    if (c0 + 8 * warp >= W) continue;      // warp-uniform: the shuffles below see all lanes
    float* col = s + 16 * rg * LD + c0 + 8 * warp + cs;
    float v[16];
    float run = 0.f;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      run += 16 * rg + q < valid ? lg2(fmaxf(col[q * LD], 1e-30f)) : 0.f;
      v[q] = run;
    }
    float incl = run;
    float o = __shfl_up_sync(0xffffffffu, incl, 8);
    if (rg >= 1) incl += o;
    o = __shfl_up_sync(0xffffffffu, incl, 16);
    if (rg >= 2) incl += o;
    const float excl = incl - run;
#pragma unroll
    for (int q = 0; q < 16; ++q) col[q * LD] = v[q] + excl;
  }
}

// ---------------------------------------------------------------- generic warp product

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four (two) 8 x 8 b16 matrices, read as 8 rows of 4 floats each: lane l gives the address
// of row l % 8 of matrix l / 8, and receives element (l / 4, l % 4) of each matrix: the
// layout of an mma.m16n8k8.tf32 fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// A warp's C[16 x 8 NT] += A[16 x K] B[K x 8 NT] (3xTF32) over k in [k_begin, k_end)
// (multiples of 8) and n-tiles nt < nt_end (a triangular operand's zero blocks are left
// out this way).  a(k0)
// gives the A fragment of columns k0 .. k0+7, b(k0, nt) the B fragment of rows k0 .. k0+7
// and n-tile nt.  Accumulator slot q of tile nt holds C[m][n] with m = g + 8 (q >> 1),
// n = 8 nt + 2 t + (q & 1).  The backward kernels build their products from it (the
// forwards hand-place their fragments).
template <int NT, typename PA, typename PB>
__device__ __forceinline__ void gemm(float (&acc)[NT][4], const PA& a, const PB& b, int k_begin,
                                     int k_end, int nt_end = NT) {
#pragma unroll 2
  for (int k0 = k_begin; k0 < k_end; k0 += 8) {
    const FragA fa = a(k0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      if (nt < nt_end) mma(acc[nt], fa, b(k0, nt));
  }
}

// A operand: rows r0 .. r0+15 of a row-major fp32 tile (row stride ld floats, rows
// 16-byte aligned), one ldmatrix a fragment; with `scale`, row m is multiplied by scale[m]
// before the split (xs = x dt formed, and rounded, as the function forms it)
struct RowsA {
  const float* p;
  const float* scale;
  __device__ RowsA(const float* tile, int ld, int r0, const float* scale_ = nullptr)
      : scale(scale_) {
    const int lane = threadIdx.x & 31;
    p = tile + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 4 * (lane >> 4);
  }
  __device__ FragA operator()(int k0) const {
    uint32_t r[4];
    ldsm_x4(r, p + k0);
    float a[4] = {__uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
                  __uint_as_float(r[3])};
    if (scale) {
      const int g = (threadIdx.x & 31) >> 2;
      a[0] *= scale[g], a[1] *= scale[g + 8], a[2] *= scale[g], a[3] *= scale[g + 8];
    }
    return frag_a(a[0], a[1], a[2], a[3]);
  }
};

// B operand stored transposed, B[k][n] = tile[(n0 + n) * ld + k]: one ldmatrix a fragment;
// with `scale`, column n is multiplied by scale[n] before the split
struct ColsB {
  const float* p;
  const float* scale;
  int ld;
  __device__ ColsB(const float* tile, int ld_, int n0, const float* scale_ = nullptr)
      : scale(scale_), ld(ld_) {
    const int lane = threadIdx.x & 31;
    p = tile + (n0 + (lane & 7)) * ld + 4 * ((lane >> 3) & 1);
  }
  __device__ FragB operator()(int k0, int nt) const {
    uint32_t r[2];
    ldsm_x2(r, p + 8 * nt * ld + k0);
    float b0 = __uint_as_float(r[0]), b1 = __uint_as_float(r[1]);
    if (scale) {
      const float s = scale[8 * nt + ((threadIdx.x & 31) >> 2)];
      b0 *= s, b1 *= s;
    }
    return frag_b(b0, b1);
  }
};

// A and B read element by element through a(m, k) and b(k, n) (elem_a, elem_b)
template <typename F>
struct ElemA {
  F f;
  __device__ FragA operator()(int k0) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    return frag_a(f(g, k0 + t), f(g + 8, k0 + t), f(g, k0 + t + 4), f(g + 8, k0 + t + 4));
  }
};
template <typename F>
struct ElemB {
  F f;
  __device__ FragB operator()(int k0, int nt) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    return frag_b(f(k0 + t, 8 * nt + g), f(k0 + t + 4, 8 * nt + g));
  }
};

template <typename F>
__device__ __forceinline__ ElemA<F> elem_a(F f) {
  return {f};
}
template <typename F>
__device__ __forceinline__ ElemB<F> elem_b(F f) {
  return {f};
}

// Calls f(m, n, value) for every element of a gemm accumulator.
template <int NT, typename F>
__device__ __forceinline__ void for_each_acc(const float (&acc)[NT][4], F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) f(g + 8 * (q >> 1), 8 * nt + 2 * t + (q & 1), acc[nt][q]);
}

// ---------------------------------------------------------------- launch

// Lets `kernel` take `smem` bytes of dynamic shared memory, with the largest shared-memory
// carveout, so that as many blocks fit an SM as the bytes allow.
template <typename K>
cudaError_t prepare_smem(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// ---------------------------------------------------------------- cp.async

// 16 bytes from global to shared; zeros instead when `in` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared; zero instead when `in` is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [t0, t0 + ROWS) of a [*, W] fp32 slab with `stride` floats between rows, into
// shared rows of LD floats; rows at or past T read as zeros.  W % 4 == 0.
template <int ROWS, int W, int LD, int NTHREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long stride, int t0,
                                          int T, int tid) {
  constexpr int V = W / 4;
#pragma unroll
  for (int idx = tid; idx < ROWS * V; idx += NTHREADS) {
    const int i = idx / V, c = (idx % V) * 4;
    const bool in = t0 + i < T;
    cp_async16(dst + i * LD + c, src + (in ? (long long)(t0 + i) * stride + c : 0), in);
  }
}

}  // namespace scan
