// Forward attention with an online softmax over [B, H, S, D] inputs.
//
// Replaces the Pallas TPU kernel eioku_tpu/ops/flash_attention.py
// `_flash_kernel` (reached through `flash_attention`). It computes what that
// kernel computes:
//     s = (q . k) * scale in fp32; s = MASK_VALUE (-0.7 * FLT_MAX, not -inf)
//     where col >= lengths[b] or, when causal, col > row; running max m, sum
//     l and accumulator acc in fp32 across KV tiles (acc = acc * alpha + p V,
//     l = l * alpha + sum p); out = acc / l, and 0 where l == 0 (a row with
//     no valid key returns zeros, not NaN).
// KV tiles wholly beyond lengths[b] are skipped, and, when causal, tiles
// wholly above the diagonal (tile t runs iff t * block_k <= (q_tile + 1) *
// block_q - 1, the Pallas kernel's below_diag test). Any S works; D is 32 or
// 64.
//
// Bound at the Whisper encoder's shape [4, 20, 1500, 64] bf16:
// 4*B*H*S^2*D = 46.1 GFLOP, 46.6 us at the 989 TFLOP/s dense bf16 peak, against
// 61 MB (q, k, v read once, o written once) and 18 us of bytes: bound by
// operations. Its 1.8e8 exponentials take about as long again on the SFUs
// (16 MUFU.EX2 per SM per clock), so they have to overlap the products.
//
// bf16 (`flash_bf16_hopper`), designed for Hopper:
// - one block of 512 threads per (192-row query tile, head, batch row):
//   warpgroup 0 is the producer (setmaxnreg.dec to 32 registers; one thread
//   issues the TMA loads), warpgroups 1-3 are consumers (setmaxnreg.inc to
//   160), each owning 64 query rows. Three consumers rather than two keep
//   the tensor cores fed while the others run their softmax, and put the
//   encoder's 640 blocks in 4.85 waves of 132 SMs rather than 960 in 7.27;
// - TMA with 4-D tensor maps (D, H, S, B) built on the host from the
//   wrapper's strides, so [B, S, H, D] views go in without a transpose. Q is
//   loaded once; K and V come in 128-key tiles through a 3-stage ring in
//   dynamic shared memory, each tile with its own "full" mbarrier and each
//   stage with an "empty" mbarrier the 384 consumer threads arrive on. The
//   TMA's zero fill past S stands for the ragged edge (1500 = 11*128 + 92);
//   col >= lengths[b] is still masked in registers. Swizzle 128 B (D = 64)
//   or 64 B (D = 32), matched by the wgmma shared-memory descriptors;
// - wgmma for both products with fp32 accumulation: S = Q K^T as
//   m64n128k16 from shared memory (both K-major); O += P V as m64nDk16 with
//   A = P from registers (the S accumulator fragment packed to bf16 pairs is
//   exactly the A fragment) and B = V from shared memory, transposed (V's
//   tile is keys x D, D contiguous);
// - the softmax in the exp2 domain: x = s * (scale * log2 e), MASK_VALUE set
//   after that scaling on the tiles that need a mask; on the others the
//   scale folds into one FFMA per score. p = exp2(x - m), alpha =
//   exp2(m_prev - m_next); m per row after a quad shuffle, l kept per thread
//   and reduced once;
// - intra-warpgroup overlap: each iteration issues tile t's Q K^T and tile
//   t-1's P V back to back, waits for the first, and runs tile t's softmax
//   while P V still runs on the tensor cores;
// - epilogue out = acc * (1 / l), 0 where l == 0, rounded once to bf16 and
//   stored through the output's strides.
// Numerics: P is rounded to bf16 once before P V (the recipe of
// scaled_dot_product_attention's own kernels); l is summed from the fp32 p
// before rounding. Q K^T on bf16 inputs has exact products. Each bf16
// output therefore lies within 1 bf16 ulp of the plain version (fp32 from
// the same inputs, rounded once) plus 2^-8 * sum_j p_j |v_j|: 2^-9 for the
// rounding of each p, doubled for the order of the fp32 sums and exp2's
// approximation. That is the tolerance the tests and chip_smoke.py hold it
// to.
//
// fp32 (`flash_simt`): one block of 64 threads per 64-row query tile, one
// query row each, q and acc in registers, fp32 FMAs throughout (no TF32), so
// it holds 2e-5 absolute against the plain version like the Pallas kernel's
// own tests. It serves compute_dtype float32, not the bf16 main path.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // element strides of batch, head and sequence; D is dense
  long long b, h, s;
};

// KV tiles a (query tile, batch row) runs: none past the valid length and,
// when causal, none whose first key lies above the tile's last query row
__device__ __forceinline__ int kv_tiles(int valid, bool causal, int q_tile,
                                        int block_q, int block_k) {
  int n = (valid + block_k - 1) / block_k;
  if (causal) n = min(n, ((q_tile + 1) * block_q - 1) / block_k + 1);
  return n;
}

__device__ __forceinline__ int valid_keys(const int* lengths, int b, int skv) {
  int valid = skv;
  if (lengths != nullptr) valid = min(valid, lengths[b]);
  return max(valid, 0);
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA, mbarriers, wgmma

constexpr int kBlock = 128;  // keys per KV tile
constexpr int kStages = 3;   // K/V ring depth
constexpr int kWGs = 3;      // consumer warpgroups, 64 query rows each
constexpr int kBlockQ = 64 * kWGs;  // query rows per block
constexpr int kThreads = 128 * (kWGs + 1);  // and the producer warpgroup
constexpr int kConsumers = 128 * kWGs;
// registers per thread after setmaxnreg: 128 * 32 + 384 * 160 = 64 Ki
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;

template <int D>
struct HopperTile {
  static constexpr int kRowBytes = D * 2;             // = the swizzle width
  static constexpr int kQBytes = kBlockQ * kRowBytes;
  static constexpr int kTileBytes = kBlock * kRowBytes;  // one K or V tile
  static constexpr int kAtomBytes = 8 * kRowBytes;     // 8 rows: the descriptors' SBO
  static constexpr uint64_t kLayout = D == 64 ? 1 : 2;  // descriptor: 128 B / 64 B swizzle
  // Q, kStages K tiles, kStages V tiles, then the mbarriers; 1024 B of slack
  // to align the tiles to the 128 B swizzle's 1024 B period
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kSmemBytes = kBarOffset + 8 * (1 + 3 * kStages) + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed. No
// __trap() after a bound on the polls: its block, shared by the producer's
// and the consumers' code, makes ptxas hold the consumers to the launch's
// 128 registers instead of setmaxnreg's 160, and they spill.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map (D, H, S, B) into shared memory; completion
// counts the box's bytes (out-of-bounds rows zero-filled) on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int h, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(h), "r"(s), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor: start address, LBO 16 B (unused by these
// swizzled layouts), SBO = the stride between 8-row groups, swizzle mode
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo_bytes,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of wgmma operands across the
// asynchronous issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define EIOKU_F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define EIOKU_F16(a, i) \
  EIOKU_F4(a, i), EIOKU_F4(a, i + 4), EIOKU_F4(a, i + 8), EIOKU_F4(a, i + 12)

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory, K-major
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : EIOKU_F16(d, 0), EIOKU_F16(d, 16), EIOKU_F16(d, 32), EIOKU_F16(d, 48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] (registers) B[16 x 64] (shared memory, N-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : EIOKU_F16(d, 0), EIOKU_F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 32] += A[64 x 16] (registers) B[16 x 32] (shared memory, N-major)
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : EIOKU_F16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef EIOKU_F16
#undef EIOKU_F4

// S = Q K^T for this warpgroup's 64 rows and one 128-key tile: D / 16 steps
// of 16 along the head dim, each 32 B further into the swizzled rows
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t q_desc,
                                         uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n128k16_ss(s, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
}

// O += P V over one 128-key tile: 8 steps of 16 keys, each 16 V rows further
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[32],
                                         uint64_t v_desc) {
  constexpr uint64_t kStep = (16 * 2 * D) >> 4;  // 16 rows of V, in 16 B units
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if constexpr (D == 64)
      wgmma_m64n64k16_rs(o, p + 4 * j, v_desc + j * kStep);
    else
      wgmma_m64n32k16_rs(o, p + 4 * j, v_desc + j * kStep);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 -> one register of two bf16, `lo` in bits 0-15
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator fragment of a 64 x 128 wgmma: thread (warp w, lane l) holds
// s[4n + 2i + j] = S[16w + l/4 + 8i][8n + 2(l%4) + j]. Running max across
// the quad of threads sharing a row, then p = exp2(x - m) in place, with x
// the score in the exp2 domain; l (per thread, partial over its columns) and
// alpha = exp2(m_prev - m_next) per row. A masked tile scales first and sets
// MASK_VALUE from column `lim[i]` of this thread's columns on (the first key
// past `valid`, or when causal past the row); an unmasked one (scale > 0)
// takes the max of the raw scores and folds the scale into one FFMA per
// score. Maxima and sums run in four chains per row.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale_log2, const int (&lim)[2]) {
  if (kMask) {
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[4 * n + e] * scale_log2;
        s[4 * n + e] = 8 * n + (e & 1) < lim[e >> 1] ? x : kMaskValue;
      }
    }
  }
  const float mul = kMask ? 1.f : scale_log2;  // s * mul is x
  float neg_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = s[4 * (k >> 1) + 2 * i + (k & 1)];
#pragma unroll
    for (int n = 2; n < 16; n += 2) {
#pragma unroll
      for (int k = 0; k < 4; ++k) c[k] = fmaxf(c[k], s[4 * (n + (k >> 1)) + 2 * i + (k & 1)]);
    }
    float mx = fmaxf(fmaxf(c[0], c[1]), fmaxf(c[2], c[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_next = fmaxf(m[i], mx * mul);
    alpha[i] = ex2(m[i] - m_next);  // 0 on the first tile (m = -inf)
    m[i] = m_next;
    neg_m[i] = -m_next;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 16; n += 2) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int idx = 4 * (n + (k >> 1)) + 2 * i + (k & 1);
        const float p = ex2(fmaf(s[idx], mul, neg_m[i]));
        s[idx] = p;
        c[k] += p;
      }
    }
    l[i] = l[i] * alpha[i] + ((c[0] + c[1]) + (c[2] + c[3]));
  }
}

// P rounded to bf16 once: keys 16j..16j+15 of the S fragment are the A
// fragment of P V's step j
__device__ __forceinline__ void pack_p(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) p[4 * j + r] = pack_bf16(s[8 * j + 2 * r], s[8 * j + 2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_hopper(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  __nv_bfloat16* __restrict__ o, const int* __restrict__ lengths, int sq,
                  int skv, Strides os, float scale_log2, bool causal) {
  using T = HopperTile<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
                        ~1023u;
  const uint32_t q_s = base;
  const uint32_t bars = base + T::kBarOffset;
  const uint32_t q_full = bars;
  auto k_tile = [&](int st) { return base + T::kQBytes + st * T::kTileBytes; };
  auto v_tile = [&](int st) {
    return base + T::kQBytes + (kStages + st) * T::kTileBytes;
  };
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * kStages + st); };

  const int q_tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int valid = valid_keys(lengths, b, skv);
  const int n_tiles = kv_tiles(valid, causal, q_tile, kBlockQ, kBlock);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if/else for the whole kernel: the roles never reconverge, so
  // ptxas honours setmaxnreg
  if (threadIdx.x < 128) {
    // producer: Q once, then K and V tiles into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      tma_load(q_s, &tm_q, q_full, h, q_tile * kBlockQ, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        mbar_wait(empty(st), ((t / kStages) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(k_full(st), T::kTileBytes);
        tma_load(k_tile(st), &tm_k, k_full(st), h, t * kBlock, b);
        mbar_expect_tx(v_full(st), T::kTileBytes);
        tma_load(v_tile(st), &tm_v, v_full(st), h, t * kBlock, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int ct = threadIdx.x - 128;
    const int wg = ct / 128;  // this warpgroup's query rows: 64 * wg ..
    const int warp = (ct % 128) / 32, lane = ct % 32;
    const int first_row = q_tile * kBlockQ + wg * 64;
    const int row0 = first_row + warp * 16 + lane / 4;  // and row0 + 8
    const int lane_col = 2 * (lane % 4);
    const uint64_t q_desc = smem_desc(q_s + wg * 64 * T::kRowBytes, T::kAtomBytes, T::kLayout);
    auto k_desc = [&](int st) { return smem_desc(k_tile(st), T::kAtomBytes, T::kLayout); };
    auto v_desc = [&](int st) { return smem_desc(v_tile(st), T::kAtomBytes, T::kLayout); };
    // a tile needs the mask if it holds keys past `valid` or, when causal,
    // keys above this warpgroup's first row (and the general path if scale <= 0)
    auto masked = [&](int t) {
      return (t + 1) * kBlock > valid || (causal && (t + 1) * kBlock - 1 > first_row) ||
             !(scale_log2 > 0.f);
    };
    float s[64], o_acc[D / 2];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = 0u;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

    // the softmax of tile t, masked where needed: this thread's columns are
    // t * 128 + lane_col + 8n + j, masked from the row's key limit on
    auto softmax = [&](int t) {
      if (!masked(t)) {
        const int none[2] = {0, 0};
        softmax_tile<false>(s, m, l, alpha, scale_log2, none);
        return;
      }
      int lim[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        lim[i] = (causal ? min(valid, row0 + 8 * i + 1) : valid) - t * kBlock - lane_col;
      softmax_tile<true>(s, m, l, alpha, scale_log2, lim);
    };

    mbar_wait(q_full, 0);  // always: the block must not exit with Q in flight
    if (n_tiles > 0) {
      mbar_wait(k_full(0), 0);
      fence_regs(s);
      wg_fence();
      issue_qk<D>(s, q_desc, k_desc(0));
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      softmax(0);
      pack_p(p, s);
    }
    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % kStages, prev = (t - 1) % kStages;
      mbar_wait(k_full(st), (t / kStages) & 1);
      mbar_wait(v_full(prev), ((t - 1) / kStages) & 1);
      fence_regs(s);
      fence_regs(o_acc);
      fence_regs(p);
      wg_fence();
      issue_qk<D>(s, q_desc, k_desc(st));  // tile t's scores
      wg_commit();
      issue_pv<D>(o_acc, p, v_desc(prev));  // tile t-1's P V, still running ...
      wg_commit();
      wg_wait<1>();
      fence_regs(s);
      softmax(t);  // ... while tile t's softmax runs
      wg_wait<0>();
      fence_regs(o_acc);
      fence_regs(p);
      mbar_arrive(empty(prev));
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o_acc[4 * n + 0] *= alpha[0];
        o_acc[4 * n + 1] *= alpha[0];
        o_acc[4 * n + 2] *= alpha[1];
        o_acc[4 * n + 3] *= alpha[1];
      }
      pack_p(p, s);
    }
    if (n_tiles > 0) {
      const int last = (n_tiles - 1) % kStages;
      mbar_wait(v_full(last), ((n_tiles - 1) / kStages) & 1);
      fence_regs(o_acc);
      fence_regs(p);
      wg_fence();
      issue_pv<D>(o_acc, p, v_desc(last));
      wg_commit();
      wg_wait<0>();
      fence_regs(o_acc);
      mbar_arrive(empty(last));
    }

    // out = acc / l, zero where l == 0
    __nv_bfloat16* op = o + b * os.b + h * os.h;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int row = row0 + 8 * i;
      if (row >= sq) continue;
      const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
      __nv_bfloat16* orow = op + row * os.s + lane_col;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16(o_acc[4 * n + 2 * i] * inv, o_acc[4 * n + 2 * i + 1] * inv);
    }
  }
}

// A 4-D tensor map (D, H, S, B) over a bf16 [B, H, S, D] view with element
// strides st = (b, h, s), D dense; boxes of one head's `rows` rows
template <int D>
int encode_map(CUtensorMap* map, const void* ptr, int h, int s, int b,
               const long long* st, int rows) {
  const cuuint64_t row = D * 2;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(h),
                        static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  // a dimension of extent 1 is never stepped: any legal stride will do
  cuuint64_t strides[3] = {h > 1 ? static_cast<cuuint64_t>(st[1]) * 2 : row,
                           s > 1 ? static_cast<cuuint64_t>(st[2]) * 2 : row,
                           b > 1 ? static_cast<cuuint64_t>(st[0]) * 2 : row};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(D), 1, static_cast<cuuint32_t>(rows), 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
      box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_hopper(const void* q, const void* k, const void* v, void* o,
                  const void* lengths, int b, int h, int sq, int skv,
                  const long long* st, float scale, int causal, void* stream) {
  using T = HopperTile<D>;
  CUtensorMap mq, mk, mv;
  int err = encode_map<D>(&mq, q, h, sq, b, st, kBlockQ);
  if (err == 0) err = encode_map<D>(&mk, k, h, skv, b, st + 3, kBlock);
  if (err == 0) err = encode_map<D>(&mv, v, h, skv, b, st + 6, kBlock);
  if (err != 0) return err;
  auto kernel = flash_bf16_hopper<D>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, h, b);
  kernel<<<grid, kThreads, T::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<const int*>(lengths), sq,
      skv, Strides{st[9], st[10], st[11]}, scale * kLog2e, causal != 0);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32: one query row per thread, fp32 FMAs

constexpr int kTile = 64;  // query rows per block and keys per KV tile

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
  const int valid = valid_keys(lengths, b, skv);
  const int n_tiles = kv_tiles(valid, causal, q_tile, kTile, kTile);

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

template <int D>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                const void* lengths, int b, int h, int sq, int skv, const long long* st,
                float scale, int causal, void* stream) {
  const dim3 grid((sq + kTile - 1) / kTile, h, b);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  flash_simt<D><<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<const int*>(lengths), sq, skv, qs, ks, vs, os, scale, causal != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, h, sq, d], k and v [b, h, skv, d], o [b, h, sq, d] on the device, each
// addressed through element strides (batch, head, seq) with d dense; for bf16
// every base pointer must be 16-byte aligned and every stride a multiple of 8
// elements (the TMA's rules; the wrapper checks). dtype: 0 fp32, 1 bf16.
// lengths: int32 [b] valid KV lengths, or null for all. strides: 12 values,
// (b, h, s) of q, k, v, o. Launches on `stream`, does not synchronise;
// returns cudaGetLastError() (cudaErrorInvalidValue if a tensor map is
// refused).
extern "C" int eioku_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, const void* lengths, int b, int h,
                                     int sq, int skv, int d, const long long* strides,
                                     float scale, int causal, int dtype, void* stream) {
  if (b < 1 || h < 1 || sq < 1 || skv < 1 || h > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (d == 64)
      return launch_hopper<64>(q, k, v, o, lengths, b, h, sq, skv, strides, scale, causal,
                               stream);
    if (d == 32)
      return launch_hopper<32>(q, k, v, o, lengths, b, h, sq, skv, strides, scale, causal,
                               stream);
  } else if (dtype == 0) {
    if (d == 64)
      return launch_simt<64>(q, k, v, o, lengths, b, h, sq, skv, strides, scale, causal,
                             stream);
    if (d == 32)
      return launch_simt<32>(q, k, v, o, lengths, b, h, sq, skv, strides, scale, causal,
                             stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* eioku_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
