// Exact greedy class-aware NMS keep mask over score-sorted candidates.
//
// Replaces the Pallas TPU kernel eioku_tpu/ops/nms.py `_nms_kernel` (reached
// through `nms_keep_mask`), and also serves the route the JAX package runs
// through `nms_fixed` (models/yolo/postprocess.py), so the port has one NMS.
//
// Per image b, with candidates already sorted by descending score:
//     keep[i] = score[i] > 0  and  no kept j < i has the same class and
//               IoU(j, i) > iou_threshold
// which is the unique greedy solution, the same one the JAX Jacobi fixpoint
// reaches.
//
// Bound: neither bytes (K = 256, B = 64: 408 KB in, 16 KB out) nor fp32
// operations (at most K^2/2 IoUs of ~14 operations each) is large; the
// kernel is latency-bound by the K sequential steps of the greedy order.
//
// Design: one block per image. Boxes, areas, classes and the keep flags sit
// in shared memory (25 bytes per candidate: 25.6 KB at K = 1024; dynamic
// shared memory above 48 KB is opted into up to the 227 KB limit). Step i
// runs in rank order: when candidate i is still kept, the threads stride over
// j > i and clear keep[j] for each same-class j whose IoU exceeds the
// threshold; one barrier per step. Within a step each j belongs to exactly
// one thread, and keep[i] is never written during step i, so there is no
// race. Any K works.
//
// Exactness: the keep mask must equal the reference bit for bit, so the IoU
// rounds exactly as `_iou_matrix` rounds it -- area = max(x2-x1,0)*max(y2-y1,0),
// inter = max(min-max,0)*max(min-max,0), union = (a_i + a_j) - inter,
// iou = inter / max(union, 1e-9) -- with the _rn intrinsics so that no
// multiply-add is contracted and the division is IEEE (the file is also
// compiled with -fmad=false).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBytesPerCandidate = 16 + 4 + 4 + 1;  // box, area, class, keep
constexpr int kMaxSharedBytes = 232448;             // 227 KB opt-in limit

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                const int* __restrict__ classes, uint8_t* __restrict__ keep_out,
                int k, float iou_threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* box = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(box + k);
  int* cls = reinterpret_cast<int*>(area + k);
  uint8_t* keep = reinterpret_cast<uint8_t*>(cls + k);

  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const float4 v = boxes[base + i];
    box[i] = v;
    area[i] = __fmul_rn(fmaxf(__fsub_rn(v.z, v.x), 0.f), fmaxf(__fsub_rn(v.w, v.y), 0.f));
    cls[i] = classes[base + i];
    keep[i] = scores[base + i] > 0.f;
  }
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    if (keep[i]) {  // block-uniform: every thread reads the same flag after the barrier
      const float4 bi = box[i];
      const float ai = area[i];
      const int ci = cls[i];
      for (int j = i + 1 + threadIdx.x; j < k; j += kThreads) {
        if (!keep[j] || cls[j] != ci) continue;
        const float4 bj = box[j];
        const float iw = fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 0.f);
        const float ih = fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 0.f);
        const float inter = __fmul_rn(iw, ih);
        const float uni = __fsub_rn(__fadd_rn(ai, area[j]), inter);
        const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-9f));
        if (iou > iou_threshold) keep[j] = 0;
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < k; i += kThreads) keep_out[base + i] = keep[i];
}

}  // namespace

// boxes: device float32 [b, k, 4] xyxy (16-byte aligned), scores: float32
// [b, k] (0 = padding), classes: int32 [b, k], keep: uint8 [b, k] (0/1).
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int eioku_nms_keep(const void* boxes, const void* scores, const void* classes,
                              void* keep, int b, int k, float iou_threshold, void* stream) {
  if (b < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = k * kBytesPerCandidate + 16;
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_keep_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const int*>(classes), static_cast<uint8_t*>(keep), k, iou_threshold);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* eioku_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
