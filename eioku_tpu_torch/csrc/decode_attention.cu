// Decoder attention for one query position: Whisper's beam-search step.
//
// Added with no Pallas counterpart: the JAX package leaves decoder attention
// to XLA, outside any kernel. In the port's plain PyTorch the step's two
// attention calls per layer scale, cast and transpose whole K/V caches every
// step (~18 GB a step at large-v3's batched decode, ~20 kernels a layer);
// this kernel reads each cache once, in place, and does the same arithmetic.
// It computes what ops/decode_attention.py `decode_attention_plain` computes,
// summation order aside:
//     qs = T(q * hd^-0.25), ks = T(k * hd^-0.25)   rounded to the element type T
//     s_j = sum_d qs_d ks_jd                        in fp32 (exact products for 16-bit T)
//     p_j = T(exp(s_j - max s) / sum_j exp(...))    fp32 softmax over the whole live row,
//                                                   normalised, then rounded to T
//     o   = T(sum_j p_j v_j)                        accumulated in fp32
// for q [B*G, 1, H*64] against k, v [B, n, H*64], where each group of G
// consecutive query rows (a window's beams) reads one K/V row. Only frames
// 0..pos are read when a device position is given (the self-attention cache,
// whose later positions the plain version masks at -1e30 and so weights
// exactly 0); otherwise all n (the encoder's frames).
//
// Bound: bytes. At the cell's cross-attention (8 windows x 1500 frames x
// 1280, G = 5 beams a window) a layer reads 61.4 MB of K and V once:
// 0.018 ms at 3.35 TB/s; the products are 2 x 5 x 1500 x 1280 x 2 = 38 MFLOP,
// ~2.5 FLOP a byte, far below the tensor cores' ridge. Self-attention at
// pos 127 (40 rows x 128 positions x 1280) reads 26.2 MB, 0.0078 ms.
//
// Design (sm_90):
// - grid (splits, H, B): one thread-block cluster of `splits` blocks (1-8)
//   per (K/V row, head); block r of the cluster takes frames [r*c, (r+1)*c)
//   of the live ones, c = ceil(live / splits), read from the device position
//   at run time, so one grid serves every position and a CUDA graph captures
//   it. The wrapper picks the smallest cluster that gives ~3 blocks an SM:
//   3 for the cell's cross-attention (160 (window, head) pairs, 500 frames a
//   block), 1 for its self-attention (800 (row, head) pairs).
// - loads: K, then V, stream through a ring of kStages tiles in shared
//   memory by cp.async (16 bytes a thread a tile, neighbouring threads on
//   neighbouring addresses; a frame's 64-element head row is 128 B in 16-bit
//   types, 256 B in fp32: 8 or 16 threads a row). A thread copies and reads
//   back only its own bytes, so the ring needs no barrier, and kStages - 1
//   tiles stay in flight. V's first tiles load while the softmax runs.
//   Holding a block's whole chunk at once instead (an earlier design) takes
//   ~2.4 waves of blocks at the cross-attention, whose 61 MB of K/V is twice
//   the card's shared memory, each block's loads idle during its softmax:
//   56-60 us a layer there against 37-38 us streamed (H100 SXM, bf16,
//   replayed from a CUDA graph).
// - scores on CUDA cores: each thread holds its 8 (or 4) dims of the G scaled
//   queries in registers, scales and rounds its K elements in registers, and
//   the row's partial dots are summed by xor shuffles. A 5 x 64 by 64 x 1500
//   product at ~2.5 FLOP a byte leaves the tensor cores nothing to win, and
//   FMAs keep the fp32 products exact without a layout for mma.
// - softmax across the cluster: each block's row maxima, then its sums of
//   exp(s - max), go through distributed shared memory; every block combines
//   the ranks in the same order, so all use one max and one sum, and P is
//   normalised before it is rounded to T (no online rescaling of rounded P).
//   The block's G x chunk fp32 scores stay in shared memory (10 KB at the
//   cell's cross-attention).
// - P V: each thread accumulates its rows' p_j v_j for its dims in fp32; rows
//   are reduced by shuffles, warps through shared memory in warp order, and
//   the cluster's blocks through distributed shared memory in rank order,
//   each block writing a share of the G x 64 outputs. No atomics: the result
//   is the same bit for bit on every run, eager or replayed.
// Tolerance against the plain version: 1 ulp of T at the output plus
// 2^-8 (bf16) or 2^-11 (f16) x sum_j p_j |v_j|, since an fp32 score that sums
// in another order may round its p_j to the neighbouring T value; fp32 within
// 2e-5 absolute. bf16, f16 and fp32; head dim 64 (every Whisper variant) and
// G up to 8 a launch (the wrapper launches larger groups in slices of 8).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kHeadDim = 64;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;
constexpr int kMaxSplits = 8;
constexpr int kStages = 4;  // K or V tiles in flight per block

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Params {
  const void* q;  // query row (w * group + g) of this launch's slice, [.., H * 64]
  const void* k;
  const void* v;
  void* o;
  long long q_row, o_row;        // elements between query (output) rows
  long long k_batch, k_frame;    // elements between K/V rows and frames
  long long v_batch, v_frame;
  const long long* pos;          // the last live frame, on the device; null: all live
  int frames;                    // n: frames in the cache
  int group;                     // query rows per K/V row (G of the whole call)
  int chunk_max;                 // ceil(frames / splits): the shared-memory chunk
  float scale;                   // hd^-0.25
};

// Dynamic shared memory: [the ring: kStages tiles of K or V, one 16-byte
// copy a thread each; later the cross-warp sums] [scores, G x chunk_max fp32].
constexpr size_t kRingBytes = static_cast<size_t>(kStages) * kThreads * 16;
static_assert(kWarps * kMaxGroup * kHeadDim * sizeof(float) <= kRingBytes,
              "the cross-warp sums reuse the ring");

template <int G>
__host__ __device__ constexpr size_t smem_bytes(int chunk_max) {
  return kRingBytes + static_cast<size_t>(G) * chunk_max * sizeof(float);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(const Params p) {
  constexpr int kVec = 16 / sizeof(T);          // elements a 16-byte copy moves
  constexpr int kRowThreads = kHeadDim / kVec;  // threads on one frame's head row: 8 or 16
  constexpr int kWarpRows = 32 / kRowThreads;   // frames a warp covers at once: 4 or 2
  constexpr int kTileRows = kWarpRows * kWarps; // frames a ring stage holds

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = lane % kRowThreads;         // this thread's 16 bytes of a head row
  const int row = warp * kWarpRows + lane / kRowThreads;  // its frame within a tile

  int live = p.frames;
  if (p.pos != nullptr) {
    const long long last = *p.pos;
    live = static_cast<int>(last + 1 < 1 ? 1 : (last + 1 > p.frames ? p.frames : last + 1));
  }
  const int chunk = (live + splits - 1) / splits;
  const int first = rank * chunk;
  const int count = max(0, min(chunk, live - first));
  const int tiles = (count + kTileRows - 1) / kTileRows;

  extern __shared__ __align__(16) unsigned char smem[];
  T* s_ring = reinterpret_cast<T*>(smem);
  float* s_red = reinterpret_cast<float*>(smem);  // the ring again, once V is consumed
  float* s_p = reinterpret_cast<float*>(smem + kRingBytes);
  __shared__ float s_max[G], s_sum[G];
  const int cm = p.chunk_max;

  // A thread copies, and later reads, only its own 16 bytes of each stage:
  // the ring needs no barrier. One commit group a tile, empty past the last.
  T* const slot0 = s_ring + row * kHeadDim + col * kVec;
  constexpr int kStageElems = kTileRows * kHeadDim;
  const size_t head_off = static_cast<size_t>(head) * kHeadDim + col * kVec;
  const T* k_src = static_cast<const T*>(p.k) + b * p.k_batch + first * p.k_frame + head_off;
  const T* v_src = static_cast<const T*>(p.v) + b * p.v_batch + first * p.v_frame + head_off;
  auto issue = [&](const T* src, long long stride, int t) {
    const int r = t * kTileRows + row;
    if (r < count) cp_async16(slot0 + (t % kStages) * kStageElems, src + r * stride);
    cp_async_commit();
  };

  for (int t = 0; t < kStages - 1; ++t) issue(k_src, p.k_frame, t);

  // the G queries' dims of this thread, scaled and rounded to T
  float qs[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        static_cast<const T*>(p.q) + (static_cast<long long>(b) * p.group + g) * p.q_row +
        head_off);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) qs[g][i] = round_to<T>(to_f(e[i]) * p.scale);
  }

  // scores, a tile at a time: a frame's partial dots over its kRowThreads
  // threads, summed by shuffles
  for (int t = 0; t < tiles; ++t) {  // uniform in the block
    issue(k_src, p.k_frame, t + kStages - 1);
    cp_async_wait<kStages - 1>();
    const int r = t * kTileRows + row;
    float dot[G];
#pragma unroll
    for (int g = 0; g < G; ++g) dot[g] = 0.f;
    if (r < count) {
      const uint4 raw = *reinterpret_cast<const uint4*>(slot0 + (t % kStages) * kStageElems);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float ks = round_to<T>(to_f(e[i]) * p.scale);
#pragma unroll
        for (int g = 0; g < G; ++g) dot[g] = fmaf(qs[g][i], ks, dot[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int off = kRowThreads / 2; off > 0; off >>= 1)
        dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
    }
    if (r < count && col == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) s_p[g * cm + r] = dot[g];
    }
  }
  // V's first tiles load while the softmax runs
  for (int t = 0; t < kStages - 1; ++t) issue(v_src, p.v_frame, t);
  __syncthreads();

  // softmax over the whole live row: warp g owns query g
  for (int g = warp; g < G; g += kWarps) {
    float m = -INFINITY;
    for (int j = lane; j < count; j += 32) m = fmaxf(m, s_p[g * cm + j]);
    m = warp_max(m);
    if (lane == 0) s_max[g] = m;
  }
  cluster.sync();
  for (int g = warp; g < G; g += kWarps) {
    float m = -INFINITY;
    for (int rk = 0; rk < splits; ++rk) m = fmaxf(m, *cluster.map_shared_rank(&s_max[g], rk));
    float sum = 0.f;
    for (int j = lane; j < count; j += 32) {
      const float e = expf(s_p[g * cm + j] - m);
      s_p[g * cm + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) s_sum[g] = sum;
  }
  cluster.sync();
  for (int g = warp; g < G; g += kWarps) {
    float total = 0.f;
    for (int rk = 0; rk < splits; ++rk) total += *cluster.map_shared_rank(&s_sum[g], rk);
    for (int j = lane; j < count; j += 32) s_p[g * cm + j] = round_to<T>(s_p[g * cm + j] / total);
  }
  __syncthreads();

  // P V, a tile at a time: this thread's frames and dims in fp32
  float acc[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    issue(v_src, p.v_frame, t + kStages - 1);
    cp_async_wait<kStages - 1>();
    const int r = t * kTileRows + row;
    if (r < count) {
      const uint4 raw = *reinterpret_cast<const uint4*>(slot0 + (t % kStages) * kStageElems);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pg = s_p[g * cm + r];
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[g][i] = fmaf(pg, to_f(e[i]), acc[g][i]);
      }
    }
  }
  cp_async_wait<0>();
  // rows by shuffles, then warps in warp order through the ring's bytes
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < kVec; ++i)
#pragma unroll
      for (int off = kRowThreads; off < 32; off <<= 1)
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
  __syncthreads();  // every thread is done with the ring
  if (lane < kRowThreads) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        s_red[(warp * G + g) * kHeadDim + col * kVec + i] = acc[g][i];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < G * kHeadDim; t += kThreads) {
    float s = s_red[t];
    for (int w = 1; w < kWarps; ++w) s += s_red[w * G * kHeadDim + t];
    s_red[t] = s;  // the block's partial, in warp 0's slot
  }
  // the cluster's blocks in rank order, each block writing a share of the outputs
  cluster.sync();
  for (int t = rank + threadIdx.x * splits; t < G * kHeadDim; t += kThreads * splits) {
    float s = 0.f;
    for (int rk = 0; rk < splits; ++rk) s += *cluster.map_shared_rank(&s_red[t], rk);
    const int g = t / kHeadDim;
    static_cast<T*>(p.o)[(static_cast<long long>(b) * p.group + g) * p.o_row +
                         static_cast<size_t>(head) * kHeadDim + t % kHeadDim] = from_f<T>(s);
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

template <typename T, int G>
int launch_group(const Params& p, int heads, int batch, int splits, cudaStream_t stream) {
  const size_t bytes = smem_bytes<G>(p.chunk_max);
  static size_t configured = 0;  // per instantiation; set before any capture by the first call
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel<T, G>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, heads, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, G>, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const Params& p, int g, int heads, int batch, int splits, cudaStream_t s) {
  switch (g) {
    case 1: return launch_group<T, 1>(p, heads, batch, splits, s);
    case 2: return launch_group<T, 2>(p, heads, batch, splits, s);
    case 3: return launch_group<T, 3>(p, heads, batch, splits, s);
    case 4: return launch_group<T, 4>(p, heads, batch, splits, s);
    case 5: return launch_group<T, 5>(p, heads, batch, splits, s);
    case 6: return launch_group<T, 6>(p, heads, batch, splits, s);
    case 7: return launch_group<T, 7>(p, heads, batch, splits, s);
    case 8: return launch_group<T, 8>(p, heads, batch, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// q: query rows [group rows of each of `batch` K/V rows][heads * head_dim], this
// launch's `rows` (1-8) of each group starting at q and o (the caller offsets
// them); k, v: [batch][frames][heads * head_dim] through their strides. pos:
// device int64, the last live frame, or null for all. strides (elements):
// q row, o row, k batch, k frame, v batch, v frame, each a multiple of 16
// bytes. dtype: 0 fp32, 1 bf16, 2 f16. Launches on `stream`, does not
// synchronise; returns a CUDA error code (cudaErrorInvalidValue for what the
// kernel cannot take).
extern "C" int eioku_decode_attention(const void* q, const void* k, const void* v, void* o,
                                      const void* pos, int batch, int heads, int frames,
                                      int group, int rows, int head_dim,
                                      const long long* strides, float scale, int splits,
                                      int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || frames < 1 || group < 1 ||
      rows < 1 || rows > kMaxGroup || rows > group || head_dim != kHeadDim || splits < 1 ||
      splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 6; ++i)
    if (strides[i] < 0 || strides[i] * elem % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_row = strides[0];
  p.o_row = strides[1];
  p.k_batch = strides[2];
  p.k_frame = strides[3];
  p.v_batch = strides[4];
  p.v_frame = strides[5];
  p.pos = static_cast<const long long*>(pos);
  p.frames = frames;
  p.group = group;
  p.chunk_max = (frames + splits - 1) / splits;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(p, rows, heads, batch, splits, s);
  if (dtype == 2) return launch_typed<__half>(p, rows, heads, batch, splits, s);
  return launch_typed<float>(p, rows, heads, batch, splits, s);
}

extern "C" const char* eioku_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
