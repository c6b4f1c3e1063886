// Positional-weighted modular checksum of a buffer of 32-bit words, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/checksum.py::checksum (kernel body
// _checksum_kernel, pallas_call at line 44): the digest (sum_i (i+1)*x_i, sum_i x_i)
// mod 2^32 over x as uint32 words.  The Pallas kernel writes one (weighted, plain)
// pair per block of `block` words and the wrapper combines them as
// sum_b weighted_b + (b*block)*plain_b; since b*block + (local index) is the global
// index, and every product and sum is taken mod 2^32 (associative and commutative in
// unsigned arithmetic), any order of summation gives the same bits.  So here each
// thread sums (i+1)*x_i and x_i over the words it reads in uint32, the block sums
// its threads, and one atomicAdd per block and word adds that into the output,
// which the wrapper zeroes.  The result is the same for every `block`: one launch.
//
// What bounds it on an H100: each word is read once and costs two integer
// multiply-adds, so the 3.35 TB/s of device memory bounds it.  The design reads
// 16 bytes a thread per load (uint4) in a grid-stride loop, four loads in flight
// per thread, with a scalar head up to the first 16-byte boundary and a scalar tail.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;     // 8 blocks on each of the H100's 132 SMs

__device__ __forceinline__ void add_vec(const uint4 x, uint32_t i0, uint32_t& w, uint32_t& s) {
  // i0 is the word index of x.x, truncated to 32 bits like the reference's uint32 index
  w += (i0 + 1u) * x.x + (i0 + 2u) * x.y + (i0 + 3u) * x.z + (i0 + 4u) * x.w;
  s += x.x + x.y + x.z + x.w;
}

__global__ void __launch_bounds__(NTHREADS)
checksum_kernel(const uint32_t* __restrict__ x, long long n, long long head, uint32_t* out) {
  const long long gt = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * NTHREADS;
  const long long nvec = (n - head) / 4;
  const long long tail = head + 4 * nvec;            // first word after the vectors
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint32_t w = 0u, s = 0u;

  long long v = gt;
  for (; v + 3 * stride < nvec; v += 4 * stride) {   // four 16-byte loads in flight
    const uint4 a = xv[v], b = xv[v + stride], c = xv[v + 2 * stride], d = xv[v + 3 * stride];
    add_vec(a, (uint32_t)(head + 4 * v), w, s);
    add_vec(b, (uint32_t)(head + 4 * (v + stride)), w, s);
    add_vec(c, (uint32_t)(head + 4 * (v + 2 * stride)), w, s);
    add_vec(d, (uint32_t)(head + 4 * (v + 3 * stride)), w, s);
  }
  for (; v < nvec; v += stride) add_vec(xv[v], (uint32_t)(head + 4 * v), w, s);
  // the scalar words: [0, head) before the first 16-byte boundary, [tail, n) after
  for (long long j = gt; j < head + (n - tail); j += stride) {
    const long long i = j < head ? j : tail + (j - head);
    const uint32_t xi = x[i];
    w += ((uint32_t)i + 1u) * xi;
    s += xi;
  }

#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    w += __shfl_xor_sync(0xffffffffu, w, m);
    s += __shfl_xor_sync(0xffffffffu, s, m);
  }
  __shared__ uint32_t part[2][NTHREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = w;
    part[1][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    w = lane < NTHREADS / 32 ? part[0][lane] : 0u;
    s = lane < NTHREADS / 32 ? part[1][lane] : 0u;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      w += __shfl_xor_sync(0xffffffffu, w, m);
      s += __shfl_xor_sync(0xffffffffu, s, m);
    }
    if (lane == 0) {
      atomicAdd(out, w);
      atomicAdd(out + 1, s);
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the kernel was launched.  x holds n >= 1 words;
// out holds 2 words, zeroed by the caller on the same stream.
int tensor_checksum(const void* x, long long n, void* out, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  long long head = (long long)(((16u - (addr & 15u)) & 15u) / 4u);
  if (addr % 4u != 0u) return (int)cudaErrorMisalignedAddress;
  if (head > n) head = n;
  const long long nvec = (n - head) / 4;
  long long blocks = (nvec + NTHREADS - 1) / NTHREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  checksum_kernel<<<(unsigned)blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), n, head, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

const char* tensor_checksum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
