// The tail of a residual branch and the next LayerNorm: the Whisper decoder
// step's fused normalisation (K5).
//
// Added with no Pallas counterpart: the JAX package leaves the decoder's
// layer norms and adds to XLA, outside any kernel. In the port's plain
// PyTorch each of a step's 97 LayerNorms is about ten eager kernels (an fp32
// cast, two means, subtractions, a square, rsqrt, a cast, gamma and beta) and
// each residual branch ends in two more (the linear's bias add, the residual
// add): ~1,260 kernels a large-v3 step, each on 40 x 1280 values. This kernel
// does one branch's tail and the next LayerNorm in one launch. It computes
// what ops/add_layer_norm.py `add_layer_norm_plain` computes, summation order
// aside, for rows of width d in the element type T:
//     x = T(x + T(y + b))                      in place; y, b optional (b needs y)
//     mu = mean(x), var = mean((x - mu)^2)     fp32, population variance
//     n = T((x - mu) * rsqrt(var + eps))       fp32, rounded to T
//     h = T(T(n * w) + beta)                   gamma, then beta, each rounded to T
// the rounding points of the port's `Linear` bias add, its residual add and
// models/layers.py `layer_norm`. Every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn: no contracted FMA), as the eager kernels round them.
//
// Bound: launch. At the cell's step (40 rows x 1280, bf16) a call moves
// 417 KB (x read and written, y read, h written; b, gamma and beta read):
// 0.12 us at 3.35 TB/s, against a launch floor of ~1 us. So the design aims
// at the shortest latency, not bandwidth:
// - one block a row, one thread a 16-byte vector of it (160 threads for a
//   16-bit row of 1280, 320 for fp32): every load of the call (x, y, b,
//   gamma, beta) is issued at once, one trip to memory, and each thread's
//   serial work is 8 (or 4) values. Replayed from a CUDA graph at the
//   cell's shape, 2.5 us a call against 5.1 us for an earlier design (one
//   warp a row, 40 values a lane, the same loads), timed in turns on one
//   H100 SXM: the lanes' serial arithmetic, not memory, set that one's time;
// - the mean and the variance in two passes over the registers (not a
//   one-pass sum of squares): xor shuffles within each warp, then the warps'
//   sums in warp order through shared memory, one barrier a pass. No
//   atomics: the result is the same bit for bit on every run, eager or
//   replayed from a CUDA graph;
// - the residual row is written back only where it was changed (y given).
// Widths: any multiple of 8 from 8 to 1280 (every Whisper width, 384-1280);
// types: bf16, f16 and fp32.
// Tolerance against the plain version: x bit for bit (elementwise, the same
// roundings); h where the fp32 statistics, summed in another order, move the
// normalised value across a rounding boundary of T: one ulp of T of n at the
// row's scale, carried through gamma and beta (four in fp32, where n keeps
// every last bit of mu and of rsqrtf's result).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWidth = 1280;
constexpr int kMaxThreads = kMaxWidth / 4;  // an fp32 row of 1280: 320 vectors of 16 bytes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// x rounded to T (round to nearest even), back in fp32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 bytes of T, loaded and stored as one vector access
template <typename T> struct alignas(16) Pack {
  static constexpr int kN = 16 / sizeof(T);
  T t[kN];
};

template <typename T> __device__ __forceinline__ Pack<T> load16(const T* p) {
  return *reinterpret_cast<const Pack<T>*>(p);
}
template <typename T> __device__ __forceinline__ void store16(T* p, const Pack<T>& v) {
  *reinterpret_cast<Pack<T>*>(p) = v;
}

struct Params {
  void* x;               // [rows, d] residual stream, row stride x_row
  const void* y;         // [rows, d] a linear's product before its bias, or null
  const void* b;         // [d] its bias, or null
  const void* w;         // [d] gamma
  const void* beta;      // [d]
  void* h;               // [rows, d] the normalised rows, row stride h_row
  long long x_row, y_row, h_row;  // elements between rows
  int rows;
  int width;
  float eps;
};

// The sum of v over the block, the same in every thread: warps by xor
// shuffles, then the warps' sums in warp order through `partial`.
__device__ __forceinline__ float block_sum(float v, float* partial) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) total = __fadd_rn(total, partial[i]);
  return total;
}

template <typename T, bool kHasY, bool kHasB>
__global__ void __launch_bounds__(kMaxThreads) add_layer_norm_kernel(const Params p) {
  constexpr int kVec = Pack<T>::kN;
  __shared__ float partial[2][kMaxThreads / 32];  // the mean's and the variance's
  const long long row = blockIdx.x;
  const int c = static_cast<int>(threadIdx.x) * kVec;  // this thread's vector of the row
  const bool live = c < p.width;
  T* __restrict__ x = static_cast<T*>(p.x) + row * p.x_row + c;
  Pack<T> xv, yv, bv, wv, ev;
  if (live) {
    xv = load16(x);
    if constexpr (kHasY) yv = load16(static_cast<const T*>(p.y) + row * p.y_row + c);
    if constexpr (kHasB) bv = load16(static_cast<const T*>(p.b) + c);
    wv = load16(static_cast<const T*>(p.w) + c);
    ev = load16(static_cast<const T*>(p.beta) + c);
  }
  float s[kVec];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    float v = 0.f;
    if (live) {
      v = to_f(xv.t[j]);
      if constexpr (kHasY) {
        float t = to_f(yv.t[j]);
        if constexpr (kHasB) t = round_to<T>(__fadd_rn(t, to_f(bv.t[j])));
        v = round_to<T>(__fadd_rn(v, t));
        xv.t[j] = from_f<T>(v);
      }
      sum = __fadd_rn(sum, v);
    }
    s[j] = v;
  }
  if constexpr (kHasY) {
    if (live) store16(x, xv);
  }
  const float inv = 1.0f / static_cast<float>(p.width);
  const float mean = __fmul_rn(block_sum(sum, partial[0]), inv);
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    s[j] = __fsub_rn(s[j], mean);
    if (live) sq = __fadd_rn(sq, __fmul_rn(s[j], s[j]));
  }
  const float rstd = rsqrtf(__fadd_rn(__fmul_rn(block_sum(sq, partial[1]), inv), p.eps));
  if (live) {
    Pack<T> out;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float n = round_to<T>(__fmul_rn(s[j], rstd));
      const float g = round_to<T>(__fmul_rn(n, to_f(wv.t[j])));
      out.t[j] = from_f<T>(__fadd_rn(g, to_f(ev.t[j])));
    }
    store16(static_cast<T*>(p.h) + row * p.h_row + c, out);
  }
}

template <typename T>
int launch_typed(const Params& p, cudaStream_t stream) {
  // one thread a 16-byte vector of the row, in whole warps
  const int threads = (p.width / Pack<T>::kN + 31) / 32 * 32;
  if (p.y == nullptr)
    add_layer_norm_kernel<T, false, false><<<p.rows, threads, 0, stream>>>(p);
  else if (p.b == nullptr)
    add_layer_norm_kernel<T, true, false><<<p.rows, threads, 0, stream>>>(p);
  else
    add_layer_norm_kernel<T, true, true><<<p.rows, threads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// x: [rows][width] through its row stride, updated in place where y is given;
// y: [rows][width] through its row stride, or null (the LayerNorm alone); b,
// w, beta: [width], b null for no bias (and null whenever y is); h: [rows]
// [width] through its row stride. strides (elements): x row, y row, h row,
// each a multiple of 16 bytes; every pointer 16-byte aligned. width: a
// multiple of 8 from 8 to 1280. dtype: 0 fp32, 1 bf16, 2 f16. Launches on
// `stream`, does not synchronise; returns a CUDA error code
// (cudaErrorInvalidValue for what the kernel cannot take).
extern "C" int eioku_add_layer_norm(void* x, const void* y, const void* b, const void* w,
                                    const void* beta, void* h, int rows, int width,
                                    const long long* strides, float eps, int dtype,
                                    void* stream) {
  if (rows < 1 || width < 8 || width > kMaxWidth || width % 8 != 0 || dtype < 0 || dtype > 2 ||
      (b != nullptr && y == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == 0 ? 4 : 2;
  if (!aligned16(x) || !aligned16(y) || !aligned16(b) || !aligned16(w) || !aligned16(beta) ||
      !aligned16(h) || w == nullptr || beta == nullptr || h == nullptr || x == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 3; ++i)
    if (strides[i] < 0 || strides[i] * elem % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.y = y;
  p.b = b;
  p.w = w;
  p.beta = beta;
  p.h = h;
  p.x_row = strides[0];
  p.y_row = strides[1];
  p.h_row = strides[2];
  p.rows = rows;
  p.width = width;
  p.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(p, s);
  if (dtype == 2) return launch_typed<__half>(p, s);
  return launch_typed<float>(p, s);
}

extern "C" const char* eioku_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
