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

// In place: s[i][c] (64 x 64, row stride LD) holds w; afterwards the inclusive cumsum of
// log2(max(w, 1e-30)) down each column.  Rows at or past `valid` count as w = 1.  A warp
// takes 8 columns at a time: lane (rg, cs) sums rows 16rg..16rg+15 of column cs, then a
// shuffle scan across the four row groups.  The caller synchronises before and after.
template <int LD, int NTHREADS>
__device__ __forceinline__ void log2_cumsum(float* s, int valid, int tid) {
  const int warp = tid >> 5, lane = tid & 31, rg = lane >> 3, cs = lane & 7;
#pragma unroll
  for (int c0 = 0; c0 < 64; c0 += 8 * (NTHREADS / 32)) {
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

// A warp's C[16 x 8 NT] += A[16 x K] B[K x 8 NT] (3xTF32), its operands read through
// a(m, k) and b(k, n); K % 8 == 0.  Accumulator slot q of tile nt holds C[m][n] with
// m = g + 8 (q >> 1), n = 8 nt + 2 t + (q & 1).  The backward kernels build their
// products from it (the forwards hand-place their fragments).
template <int NT, int K, typename FA, typename FB>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    const FragA fa = frag_a(a(g, k0 + t), a(g + 8, k0 + t), a(g, k0 + t + 4), a(g + 8, k0 + t + 4));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma(acc[nt], fa, frag_b(b(k0 + t, 8 * nt + g), b(k0 + t + 4, 8 * nt + g)));
  }
}

// Calls f(m, n, value) for every element of a warp_gemm accumulator.
template <int NT, typename F>
__device__ __forceinline__ void for_each_acc(const float (&acc)[NT][4], F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) f(g + 8 * (q >> 1), 8 * nt + 2 * t + (q & 1), acc[nt][q]);
}

// ---------------------------------------------------------------- cp.async

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
