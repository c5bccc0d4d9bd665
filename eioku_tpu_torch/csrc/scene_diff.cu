// Scene-difference scores for a chain of flattened HSV planes.
//
// Replaces the Pallas TPU kernel eioku_tpu/ops/scene_diff.py `_diff_kernel`
// (reached through `_pallas_pair_diff` and `scene_scores`).
//
// Computes, for a row-major float32 chain [n, d]:
//     out[i] = sum_k |chain[i+1, k] - chain[i, k]| / d      for i in [0, n-1)
//
// Bound: memory. A main-path call (n = 257, d = 96*160*3 = 46,080) reads
// 47.4 MB and writes 1 KB, about 14 us at the H100's 3.35 TB/s; the
// arithmetic (3 operations per element) is negligible.
//
// Design: one block per adjacent pair, 512 threads, 16-byte float4 loads with
// neighbouring threads on neighbouring addresses. 256 pairs x 512 threads
// fill the 132 SMs about twice over, enough loads in flight to approach the
// memory rate. Each interior row is read by two blocks (as the second row of
// pair i-1 and the first of pair i); those blocks run at nearly the same time
// and the 50 MB L2 serves the second read. Sums stay in fp32 registers and
// are reduced with warp shuffles, then across warps through shared memory;
// the mean divides by the true d. When d is not a multiple of 4 (or the base
// is not 16-byte aligned) a scalar loop covers the row, so any d works.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
pair_abs_diff_kernel(const float* __restrict__ chain, float* __restrict__ out,
                     int d, int vectorized) {
  const int pair = blockIdx.x;
  const float* a = chain + static_cast<size_t>(pair) * d;
  const float* b = a + d;
  float acc = 0.f;
  if (vectorized) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    const int d4 = d >> 2;
    for (int i = threadIdx.x; i < d4; i += kThreads) {
      const float4 x = __ldg(a4 + i);
      const float4 y = __ldg(b4 + i);
      acc += fabsf(y.x - x.x) + fabsf(y.y - x.y) + fabsf(y.z - x.z) + fabsf(y.w - x.w);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) acc += fabsf(__ldg(b + i) - __ldg(a + i));
  }

  __shared__ float partial[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  acc = warp_sum(acc);
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? partial[lane] : 0.f;
    acc = warp_sum(acc);
    if (lane == 0) out[pair] = acc / static_cast<float>(d);
  }
}

}  // namespace

// chain: device float32 [n, d], contiguous. out: device float32 [n - 1].
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int eioku_scene_diff(const void* chain, void* out, int n, int d, void* stream) {
  if (n < 2 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int vectorized = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(chain) % 16 == 0);
  pair_abs_diff_kernel<<<n - 1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(chain), static_cast<float*>(out), d, vectorized);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* eioku_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
