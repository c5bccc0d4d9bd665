// Forward attention with an online softmax over [B, H, S, D] inputs.
//
// Replaces the Pallas TPU kernel eioku_tpu/ops/flash_attention.py
// `_flash_kernel` (reached through `flash_attention`). It computes what that
// kernel computes:
//     s = (q . k) * scale in fp32; s = MASK_VALUE (-0.7 * FLT_MAX, not -inf)
//     where col >= lengths[b] or, when causal, col > row; running max m, sum
//     l and accumulator acc in fp32 across KV tiles (acc = acc * alpha + p V,
//     l = l * alpha + sum p, alpha = exp(m_prev - m_next)); out = acc / l,
//     and 0 where l == 0 (a row with no valid key returns zeros, not NaN).
// KV tiles wholly beyond lengths[b] are skipped, and, when causal, tiles
// wholly above the diagonal. Any S works (the ragged edge is masked here, the
// wrapper pads nothing); D is 32 or 64.
//
// Bound at the Whisper encoder's shape [4, 20, 1500, 64] bf16:
// 4*B*H*S^2*D = 46.1 GFLOP, 46.6 us at the 989 TFLOP/s dense bf16 peak, against
// 61 MB (q, k, v read once, o written once) and 18 us of bytes: bound by
// operations. Its 1.8e8 exponentials cost about as much again on the SFUs.
//
// Design (a first version that is right, not yet fast):
// - one block per (64-row query tile, head, batch row); the TPU's sequential
//   KV grid axis becomes a loop over 64-key tiles inside the block, with the
//   K and V tiles staged in shared memory;
// - bf16 (`flash_bf16_mma`): 4 warps, 16 query rows each. Q K^T runs on the
//   tensor cores (mma.sync m16n8k16 bf16, fp32 accumulation): bf16 products
//   are exact in fp32, so S differs from the fp32 plain version only in the
//   order of the sums. P is NOT rounded to bf16 before P V: each p is split
//   into p_hi = bf16(p) and p_lo = bf16(p - p_hi), and P V = P_hi V + P_lo V,
//   two mma.sync with fp32 accumulation, so P carries about 16 significant
//   bits (relative error below 2^-16) instead of bf16's 8. The output is
//   rounded to bf16 once, from fp32, as the plain version rounds it. So
//   each bf16 output lies within 1 bf16 ulp of the plain version plus
//   2^-16 * sum_j p_j |v_j| (the split P and the summation order, visible
//   only where the output cancels to near zero): the tolerance the tests
//   and chip_smoke.py hold it to;
// - fp32 (`flash_simt`): 64 threads, one query row each, q and acc in
//   registers, fp32 FMAs throughout (no TF32), so it holds 2e-5 absolute
//   against the plain version like the Pallas kernel's own tests.
// Later work (ROADMAP): wgmma with TMA-fed K/V rings and exp2 with a folded
// scale, to approach the operations bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr int kTile = 64;  // query rows per block and keys per KV tile

struct Strides {  // element strides of batch, head and sequence; D is dense
  long long b, h, s;
};

__device__ __forceinline__ int kv_tiles(const int* lengths, int b, int skv,
                                        bool causal, int q_tile) {
  int valid = skv;
  if (lengths != nullptr) valid = min(valid, lengths[b]);
  valid = max(valid, 0);
  int n = (valid + kTile - 1) / kTile;
  // a tile is run only when its first key lies on or below the tile's last
  // query row, as the Pallas kernel's below_diag test
  if (causal) n = min(n, q_tile + 1);
  return n;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores for Q K^T and for P V (P split into two bf16 terms)

template <int D>
struct BfTile {
  static constexpr int kStride = D + 8;  // bf16 elements per smem row (pads banks)
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two bf16 in one register: `lo` (the lower k or column index) in bits 0-15
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// p -> (hi, lo) with hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 xh = __float2bfloat16_rn(x), yh = __float2bfloat16_rn(y);
  hi = pack_bf16(xh, yh);
  lo = pack_bf16(__float2bfloat16_rn(x - __bfloat162float(xh)),
                 __float2bfloat16_rn(y - __bfloat162float(yh)));
}

// rows [row0, row0 + 64) of a [*, D] bf16 matrix into smem, zeros past `rows`
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long stride_s, int row0,
                                               int rows, int tid, int nthreads) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < kTile * kChunks; i += nthreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride_s + c * 8);
    *reinterpret_cast<uint4*>(dst + r * BfTile<D>::kStride + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(128)
flash_bf16_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               const int* __restrict__ lengths, int sq, int skv, Strides qs,
               Strides ks, Strides vs, Strides os, float scale, bool causal) {
  constexpr int kStride = BfTile<D>::kStride;
  constexpr int kKSteps = D / 16;  // mma k-steps over the head dim for Q K^T
  constexpr int kDTiles = D / 8;   // 8-wide output column tiles for P V
  __shared__ __align__(16) __nv_bfloat16 q_s[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 k_s[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kTile * kStride];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment group and thread-in-group
  const int q_tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = q_tile * kTile;
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;

  load_tile_bf16<D>(q_s, qp, qs.s, q0, sq, tid, 128);
  __syncthreads();
  // this warp's 16 query rows as A fragments, once
  uint32_t qa[kKSteps][4];
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;  // rows within the tile
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(q_s + r_lo * kStride + c);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(q_s + r_hi * kStride + c);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(q_s + r_lo * kStride + c + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(q_s + r_hi * kStride + c + 8);
  }

  float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.f, 0.f};
  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  const int row_g[2] = {q0 + r_lo, q0 + r_hi};  // absolute query rows
  int valid = skv;
  if (lengths != nullptr) valid = min(valid, lengths[b]);
  const int n_tiles = kv_tiles(lengths, b, skv, causal, q_tile);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D>(k_s, kp, ks.s, k0, skv, tid, 128);
    load_tile_bf16<D>(v_s, vp, vs.s, k0, skv, tid, 128);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = k_s + (nt * 8 + g) * kStride + t4 * 2;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(s[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b0, b1);
      }
    }
    // scale, mask, tile row max
    float m_cur[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nt * 8 + t4 * 2 + (i & 1);
        const int r = i >> 1;
        float x = s[nt][i] * scale;
        if (col >= valid || (causal && col > row_g[r])) x = kMaskValue;
        s[nt][i] = x;
        m_cur[r] = fmaxf(m_cur[r], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 threads of a fragment group hold one row's 64 columns
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 1));
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 2));
      const float m_next = fmaxf(m_row[r], m_cur[r]);
      alpha[r] = expf(m_row[r] - m_next);
      m_row[r] = m_next;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[nt][i] - m_row[i >> 1]);
        s[nt][i] = p;
        sum[i >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_row[r] = alpha[r] * l_row[r] + sum[r];
    }
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    // P V: key step j covers keys 16j..16j+15; the S fragments of n-tiles
    // 2j and 2j+1 are exactly the A fragment of that step
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t ah[4], al[4];
      split_pair(s[2 * j][0], s[2 * j][1], ah[0], al[0]);
      split_pair(s[2 * j][2], s[2 * j][3], ah[1], al[1]);
      split_pair(s[2 * j + 1][0], s[2 * j + 1][1], ah[2], al[2]);
      split_pair(s[2 * j + 1][2], s[2 * j + 1][3], ah[3], al[3]);
      const __nv_bfloat16* v0 = v_s + (j * 16 + t4 * 2) * kStride + g;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const __nv_bfloat16* vc = v0 + dt * 8;
        const uint32_t b0 = pack_bf16(vc[0], vc[kStride]);
        const uint32_t b1 = pack_bf16(vc[8 * kStride], vc[9 * kStride]);
        mma_bf16(acc[dt], ah[0], ah[1], ah[2], ah[3], b0, b1);
        mma_bf16(acc[dt], al[0], al[1], al[2], al[3], b0, b1);
      }
    }
  }

  // out = acc / l, zero where l == 0
  __nv_bfloat16* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row_g[r] >= sq) continue;
    const float inv = l_row[r] == 0.f ? 1.f : 1.f / l_row[r];
    __nv_bfloat16* orow = op + row_g[r] * os.s + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      const uint32_t packed = pack_bf16(__float2bfloat16_rn(acc[dt][2 * r] * inv),
                                        __float2bfloat16_rn(acc[dt][2 * r + 1] * inv));
      *reinterpret_cast<uint32_t*>(orow + dt * 8) = packed;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: one query row per thread, fp32 FMAs

template <int D>
__global__ void __launch_bounds__(kTile)
flash_simt(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           const int* __restrict__ lengths, int sq, int skv, Strides qs,
           Strides ks, Strides vs, Strides os, float scale, bool causal) {
  __shared__ __align__(16) float k_s[kTile][D];
  __shared__ __align__(16) float v_s[kTile][D];
  const int tid = threadIdx.x;
  const int q_tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int row = q_tile * kTile + tid;
  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row < sq ? qp[row * qs.s + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  int valid = skv;
  if (lengths != nullptr) valid = min(valid, lengths[b]);
  const int n_tiles = kv_tiles(lengths, b, skv, causal, q_tile);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    for (int i = tid; i < kTile * D; i += kTile) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < skv;
      k_s[r][d] = in ? kp[(k0 + r) * ks.s + d] : 0.f;
      v_s[r][d] = in ? vp[(k0 + r) * vs.s + d] : 0.f;
    }
    __syncthreads();
    float s[kTile];
    float m_cur = kMaskValue;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], k_s[j][d], dot);
      float x = dot * scale;
      const int col = k0 + j;
      if (col >= valid || (causal && col > row)) x = kMaskValue;
      s[j] = x;
      m_cur = fmaxf(m_cur, x);
    }
    const float m_next = fmaxf(m, m_cur);
    const float alpha = expf(m - m_next);
    m = m_next;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      s[j] = expf(s[j] - m);
      sum += s[j];
    }
    l = alpha * l + sum;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(s[j], v_s[j][d], acc[d]);
    }
  }
  if (row >= sq) return;
  const float inv = l == 0.f ? 1.f : 1.f / l;
  float* orow = o + b * os.b + h * os.h + row * os.s;
#pragma unroll
  for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
}

template <typename Kernel, typename T>
int launch(Kernel kernel, int threads, const void* q, const void* k, const void* v,
           void* o, const void* lengths, int b, int h, int sq, int skv,
           const long long* st, float scale, int causal, void* stream) {
  const dim3 grid((sq + kTile - 1) / kTile, h, b);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<const int*>(lengths), sq, skv, qs, ks, vs, os,
      scale, causal != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, h, sq, d], k and v [b, h, skv, d], o [b, h, sq, d] on the device, each
// addressed through element strides (batch, head, seq) with d dense; for bf16
// every row start must be 16-byte aligned (the wrapper checks). dtype: 0 fp32,
// 1 bf16. lengths: int32 [b] valid KV lengths, or null for all. strides: 12
// values, (b, h, s) of q, k, v, o. Launches on `stream`, does not
// synchronise; returns cudaGetLastError().
extern "C" int eioku_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, const void* lengths, int b, int h,
                                     int sq, int skv, int d, const long long* strides,
                                     float scale, int causal, int dtype, void* stream) {
  if (b < 1 || h < 1 || sq < 1 || skv < 1 || h > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (d == 64)
      return launch<decltype(&flash_bf16_mma<64>), __nv_bfloat16>(
          flash_bf16_mma<64>, 128, q, k, v, o, lengths, b, h, sq, skv, strides, scale,
          causal, stream);
    if (d == 32)
      return launch<decltype(&flash_bf16_mma<32>), __nv_bfloat16>(
          flash_bf16_mma<32>, 128, q, k, v, o, lengths, b, h, sq, skv, strides, scale,
          causal, stream);
  } else if (dtype == 0) {
    if (d == 64)
      return launch<decltype(&flash_simt<64>), float>(
          flash_simt<64>, kTile, q, k, v, o, lengths, b, h, sq, skv, strides, scale,
          causal, stream);
    if (d == 32)
      return launch<decltype(&flash_simt<32>), float>(
          flash_simt<32>, kTile, q, k, v, o, lengths, b, h, sq, skv, strides, scale,
          causal, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* eioku_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
