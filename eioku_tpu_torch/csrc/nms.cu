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
// Bound: neither bytes (K = 256, B = 64: 408 KB in, 16 KB out: 0.12 us at
// 3.35 TB/s) nor fp32 operations (the IoUs this data needs, ~14 operations
// each) is large. The greedy order is a chain of dependent decisions, and
// each of the two launches costs about 0.9 us (an empty kernel replayed from
// a CUDA graph, chip_smoke.py): the kernel is bound by latency, and where
// most candidates share a class, by the instructions of its IoU tests.
//
// Design, in two launches with no barrier per rank:
//
// 1. nms_mask_kernel, one block of 128 threads per tile pair (row tile r,
//    column tile c >= r) and image, the upper triangle walked row by row:
//    the suppression bitmask. Two threads own candidate i = 64 r + t, each
//    over one half of the tile's columns. For c > r they set bit u of word
//    c when j = 64 c + u has i's class and IoU(i, j) > threshold. On the
//    diagonal (c = r) the word is i's column instead: bit u for each u < t
//    of the tile, of i's class, whose IoU with i exceeds the threshold (the
//    IoU is symmetric bit for bit). A thread first builds the 32-bit set of
//    its half's columns of its class, so a warp walks the most any of its
//    threads has, not all 32. Invalid columns carry a class no valid row
//    has and invalid rows test nothing, so padding costs no IoU. The IoU
//    test divides only within a relative 2^-20 of the threshold (see
//    suppresses()). The mask is stored word major, mask[b][c][i]: a block's
//    64 words are one coalesced 512-byte store. The diagonal blocks also
//    write each tile's validity word by ballot.
// 2. nms_scan_kernel, one warp per image: the greedy order, word by word,
//    with no barrier at all. Lane l owns the "removed" words l, l + 32, ...
//    in registers. For word w the warp takes alive = valid_w & ~removed_w.
//    Inside the word, lane l holds ranks l and l + 32 with their column
//    words; from kept = alive, rounds of two ballots drop every rank that
//    a kept rank removes, until nothing changes: as many rounds as the
//    word's longest chain of removals, plus one, where a find-first-set
//    walk takes one dependent step per kept box (measured slower; see
//    PERF.md). Then each lane ORs the kept rows' words into its own removed
//    words: independent shared-memory loads, no chain. The rows of tile w
//    (words w.. of ranks 64 w..64 w + 63) are staged into shared memory
//    with cp.async two tiles ahead of their use, so no step waits on L2.
//    Invalid candidates are never alive, so their rows are never used;
//    words past the last valid candidate are not scanned.
//
// Limits: K <= 10,240 (five removed words per lane; the two staged tiles
// take 2 * 65 * 8 bytes per word, 166 KB at that K), so every top-K of a
// 640 x 640 detector (8,400 anchors) runs. The scratch the wrapper
// allocates holds B * W * 64 W mask words and B * W validity words,
// W = ceil(K / 64).
//
// Exactness: the keep mask must equal the reference bit for bit, so the IoU
// rounds exactly as `_iou_matrix` rounds it -- area = max(x2-x1,0)*max(y2-y1,0),
// inter = max(min-max,0)*max(min-max,0), union = (a_i + a_j) - inter,
// iou = inter / max(union, 1e-9) -- with the _rn intrinsics so that no
// multiply-add is contracted and the division is IEEE (the file is also
// compiled with -fmad=false).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;                         // ranks per mask word
constexpr int kMaskThreads = 2 * kTile;           // two threads per row of a tile
constexpr int kMaxSlots = 5;                      // removed words per scan lane
constexpr int kMaxWords = 32 * kMaxSlots;         // 160 words
constexpr int kMaxK = kTile * kMaxWords;          // 10,240 candidates
constexpr int kStride = kTile + 1;                // one pad word: no bank conflicts
constexpr int kNoClass = -2147483647 - 1;         // class of an invalid column
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float box_area(float4 v) {
  return __fmul_rn(fmaxf(__fsub_rn(v.z, v.x), 0.f), fmaxf(__fsub_rn(v.w, v.y), 0.f));
}

// IoU(i, j) > thr for a pair with intersection `inter` and union `uni`,
// decided without the division where the quotient lies clearly on one side.
// With lo = thr (1 - 2^-21) and hi = thr (1 + 2^-21), each rounded, and
// products rounded to nearest (relative error <= 2^-24, no underflow for
// u >= 1e-9 and thr >= 2^-60): inter > u * hi implies inter / u >
// thr (1 + 2^-23) >= the float after thr, so the rounded quotient exceeds
// thr; inter < u * lo implies inter / u < thr, so it does not. Only pairs
// in the band between (relative width ~2^-20) divide, and the IEEE
// quotient decides as in the reference. lo = hi = NaN sends every pair to
// the division (eioku_nms_keep does so for thr outside [2^-60, 1]).
__device__ __forceinline__ bool suppresses(float inter, float uni, float thr, float lo,
                                           float hi) {
  const float u = fmaxf(uni, 1e-9f);
  if (inter > __fmul_rn(u, hi)) return true;
  if (inter < __fmul_rn(u, lo)) return false;
  return __fdiv_rn(inter, u) > thr;
}

// First row-major index of row tile r among the tile pairs (r, c >= r).
__device__ __forceinline__ int row_start(int r, int words) {
  return r * words - r * (r - 1) / 2;
}

__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                const int* __restrict__ classes, u64* __restrict__ mask,
                u64* __restrict__ valid_words, int k, int words, float iou_threshold,
                float thr_lo, float thr_hi) {
  // blockIdx.x walks the upper triangle of tile pairs row by row: the float
  // root of row_start(r) = p is exact to within one row, fixed up after
  const int p = blockIdx.x, b = blockIdx.y;
  const float w2 = 2.f * words + 1.f;
  int row_tile = static_cast<int>(0.5f * (w2 - sqrtf(w2 * w2 - 8.f * p)));
  while (row_tile > 0 && row_start(row_tile, words) > p) --row_tile;
  while (row_start(row_tile + 1, words) <= p) ++row_tile;
  const int col_tile = row_tile + p - row_start(row_tile, words);
  __shared__ float4 cbox[kTile];
  __shared__ float carea[kTile];
  __shared__ __align__(16) int ccls[kTile];

  // every global load first: threads 0..63 load column j of the tile; the
  // pair of threads 2 t, 2 t + 1 takes candidate i = 64 r + t, each over
  // one half of the columns (half h, columns 32 h..32 h + 31)
  const int tid = threadIdx.x, t = tid >> 1, h = tid & 1;
  const size_t base = static_cast<size_t>(b) * k;
  const int j = col_tile * kTile + tid, i = row_tile * kTile + t;
  float4 bj = make_float4(0.f, 0.f, 0.f, 0.f), bi = bj;
  bool valid_col = false, valid_row = false;
  int cj = kNoClass, ci = kNoClass;
  if (tid < kTile && j < k) {
    bj = boxes[base + j];
    valid_col = scores[base + j] > 0.f;
    cj = classes[base + j];
  }
  if (i < k) {
    bi = boxes[base + i];
    valid_row = scores[base + i] > 0.f;
    ci = classes[base + i];
  }
  if (tid < kTile) {
    cbox[tid] = bj;
    carea[tid] = box_area(bj);
    ccls[tid] = valid_col ? cj : kNoClass;
    if (col_tile == row_tile) {  // warps 0 and 1, j == i: the tile's validity word
      const unsigned half = __ballot_sync(kFull, valid_col);
      if ((tid & 31) == 0)
        reinterpret_cast<unsigned*>(valid_words + static_cast<size_t>(b) * words)
            [2 * row_tile + (tid >> 5)] = half;
    }
  }
  const bool any_col = __syncthreads_or(valid_col);

  unsigned bits = 0u;
  if (any_col && valid_row) {
    const float ai = box_area(bi);
    // the half's columns of i's class: a warp then walks the most any of
    // its threads has, not all 32
    unsigned same = 0u;
    const int4* c4 = reinterpret_cast<const int4*>(ccls) + 8 * h;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int4 c = c4[q];
      same |= (static_cast<unsigned>(c.x == ci) | static_cast<unsigned>(c.y == ci) << 1 |
               static_cast<unsigned>(c.z == ci) << 2 | static_cast<unsigned>(c.w == ci) << 3)
              << (4 * q);
    }
    // on the diagonal the word is rank t's column: the ranks before it in
    // the tile that remove it (the IoU is symmetric, bit for bit)
    if (col_tile == row_tile) {
      const int before = t - 32 * h;  // columns of this half that precede t
      same &= before >= 32 ? ~0u : before <= 0 ? 0u : (1u << before) - 1;
    }
    while (same) {
      const int v = __ffs(same) - 1;
      same &= same - 1;
      const int u = 32 * h + v;
      const float4 bu = cbox[u];
      const float iw = fmaxf(__fsub_rn(fminf(bi.z, bu.z), fmaxf(bi.x, bu.x)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(bi.w, bu.w), fmaxf(bi.y, bu.y)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(ai, carea[u]), inter);
      if (suppresses(inter, uni, iou_threshold, thr_lo, thr_hi)) bits |= 1u << v;
    }
  }
  // half h of word (col_tile, i): the block's 128 halves are one coalesced
  // 512-byte store
  reinterpret_cast<unsigned*>(mask)
      [2 * ((static_cast<size_t>(b) * words + col_tile) * (words * kTile) + i) + h] = bits;
}

__device__ __forceinline__ void cp_async8(u64* dst, const u64* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

// Stage tile c (words c..last of ranks 64 c..64 c + 63) into buffer c & 1
// as one cp.async group; the group is empty when c > last, so that every
// call commits exactly one.
__device__ __forceinline__ void stage_tile(u64* stage, const u64* mask, int c, int last,
                                           int words, int lane) {
  u64* dst = stage + static_cast<size_t>(c & 1) * words * kStride;
  const int kp = words * kTile;
  for (int v = c; v <= last; ++v) {
    const u64* src = mask + static_cast<size_t>(v) * kp + c * kTile;
    cp_async8(dst + v * kStride + lane, src + lane);
    cp_async8(dst + v * kStride + lane + 32, src + lane + 32);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const u64* __restrict__ mask, const u64* __restrict__ valid_words,
                uint8_t* __restrict__ keep, int k, int words) {
  extern __shared__ __align__(16) u64 stage[];  // [2][words][kStride]
  const int lane = threadIdx.x, b = blockIdx.x;
  const u64* m = mask + static_cast<size_t>(b) * words * words * kTile;
  const size_t base = static_cast<size_t>(b) * k;

  // tiles 0 and 1 go in flight before the validity words are read
  stage_tile(stage, m, 0, words - 1, words, lane);
  stage_tile(stage, m, 1, words - 1, words, lane);
  u64 removed[kMaxSlots], valid[kMaxSlots];
  int last = -1;  // the last word that holds a valid candidate
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    const int v = lane + 32 * s;
    valid[s] = v < words ? valid_words[static_cast<size_t>(b) * words + v] : 0ull;
    removed[s] = 0ull;
    const unsigned any = __ballot_sync(kFull, valid[s] != 0ull);
    if (any) last = 32 * s + 31 - __clz(static_cast<int>(any));
  }

  for (int w = 0; w <= last; ++w) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tiles 0..w have landed
    __syncwarp();
    const u64* cur = stage + static_cast<size_t>(w & 1) * words * kStride;

    // word w's valid and removed bits live in lane w & 31, slot w >> 5
    u64 own = 0ull;
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s)
      if (s == (w >> 5)) own = valid[s] & ~removed[s];
    const u64 alive = __shfl_sync(kFull, own, w & 31);

    // the greedy order inside word w: lane l holds ranks l and l + 32 and
    // their column words (the ranks before them that remove them); from
    // kept = alive, a rank stays while no kept rank removes it. Rank t is
    // final after t + 1 rounds, so this ends with the greedy set, in as
    // many rounds as the word's longest chain of removals, plus one
    const u64* diag = cur + w * kStride;
    const u64 by0 = diag[lane], by1 = diag[lane + 32];
    const bool alive0 = (alive >> lane) & 1ull, alive1 = (alive >> (lane + 32)) & 1ull;
    u64 kept = alive;
    for (;;) {
      const unsigned lo = __ballot_sync(kFull, alive0 && !(by0 & kept));
      const unsigned hi = __ballot_sync(kFull, alive1 && !(by1 & kept));
      const u64 next = static_cast<u64>(hi) << 32 | lo;
      if (next == kept) break;
      kept = next;
    }

    const int r = w * kTile + lane;
    if (r < k) keep[base + r] = static_cast<uint8_t>((kept >> lane) & 1ull);
    if (r + 32 < k) keep[base + r + 32] = static_cast<uint8_t>((kept >> (lane + 32)) & 1ull);

    // the kept rows of word w remove what they overlap in later words
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s) {
      const int v = lane + 32 * s;
      if (v > w && v <= last) {
        const u64* col = cur + v * kStride;
        u64 acc = 0ull;
#pragma unroll
        for (int t = 0; t < kTile; ++t)
          if ((kept >> t) & 1ull) acc |= col[t];
        removed[s] |= acc;
      }
    }
    __syncwarp();  // every lane is done with buffer w & 1 before it is refilled
    stage_tile(stage, m, w + 2, last, words, lane);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int r = (last + 1) * kTile + lane; r < k; r += 32) keep[base + r] = 0;
}

__global__ void empty_kernel() {}

}  // namespace

// boxes: device float32 [b, k, 4] xyxy (16-byte aligned), scores: float32
// [b, k] (0 = padding), classes: int32 [b, k], keep: uint8 [b, k] (0/1),
// scratch: b * W * (64 W + 1) 64-bit words, W = ceil(k / 64).
// Launches both kernels on `stream`, does not synchronise; returns
// cudaGetLastError().
extern "C" int eioku_nms_keep(const void* boxes, const void* scores, const void* classes,
                              void* keep, void* scratch, int b, int k, float iou_threshold,
                              void* stream) {
  if (b < 1 || b > 65535 || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int words = (k + kTile - 1) / kTile;
  u64* mask = static_cast<u64*>(scratch);
  u64* valid = mask + static_cast<size_t>(b) * words * words * kTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float thr_lo = nanf(""), thr_hi = thr_lo;  // see suppresses()
  if (iou_threshold >= 0x1p-60f && iou_threshold <= 1.f) {
    thr_lo = iou_threshold * (1.f - 0x1p-21f);
    thr_hi = iou_threshold * (1.f + 0x1p-21f);
  }
  nms_mask_kernel<<<dim3(words * (words + 1) / 2, b), kMaskThreads, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const int*>(classes), mask, valid, k, words, iou_threshold, thr_lo, thr_hi);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = 2 * words * kStride * static_cast<int>(sizeof(u64));
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_scan_kernel<<<b, 32, smem, s>>>(mask, valid, static_cast<uint8_t*>(keep), k, words);
  return static_cast<int>(cudaGetLastError());
}

// One empty kernel on `stream`: its time replayed from a CUDA graph is the
// launch floor that K2's times are read against (chip_smoke.py).
extern "C" int eioku_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* eioku_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
