// The bfloat16 instantiation of flash_attention: both products on
// Hopper's tensor cores (wgmma), K and V brought in by TMA. Included by
// flash_attention.cu, whose float32 instantiation keeps its CUDA-core
// design; the arithmetic both compute is the one stated there (the TPU
// kernel's _flash_kernel).
//
// What bounds it on an H100: operations. At gemma-2b's prefill (B = 4,
// S = 1024, H = 8, Hkv = 1, hd = 256) the two products over the kept
// causal pairs are 17.2 GFLOP, 0.0174 ms at 989 TFLOP/s dense bfloat16,
// against 37.7 MB of q, k, v and o (11.3 us at 3.35 TB/s). This kernel
// does 1.5 times that work (P v twice, below): 25.8 GFLOP, 0.0261 ms.
//
// The design. A block owns 128 query rows of one (batch, head): two
// consumer warpgroups (warps 0-7), 64 rows each, compute on the same K
// and V tiles, and one producer warpgroup (warps 8-11) loads them; the
// producer gives its registers to the consumers (setmaxnreg: 24 and 240
// a thread). The grid is flat and issues the query tiles with the most
// key tiles first across every (batch, head): with the causal mask the
// work per block runs from 2 to 2 S / 128 tiles, and issuing them head by
// head left SMs idle at the end.
// - Loads. The producer's first thread issues TMA copies
//   (cp.async.bulk.tensor, tensor maps built on the host over q, k, v in
//   the model's [B, S, heads, hd] layout through their strides: no GQA
//   copy, and rows past S arrive as zeros) of the two Q tiles once and of
//   the K and V tiles of 64 keys into a ring of kStages stages, each
//   tracked by a "full" mbarrier (transaction bytes) and released by an
//   "empty" one that all 256 consumers arrive on; the next tile is in flight
//   while the consumers compute. Tiles land in the 128-byte swizzled
//   layout (64-byte at hd = 32) that wgmma's matrix descriptors read: a
//   [64 x hd] tile is hd/64 column blocks of 64 rows x 128 bytes.
// - S = Q K^T: hd/16 wgmma.m64n64k16 with both operands K-major in shared
//   memory, float32 accumulators (32 a thread). q and k are exact in
//   bfloat16, so the products are exact and the sum is float32. The
//   scale 1/sqrt(hd) is applied to S in float32 after the product.
// - Softmax in registers: the mask (causal, window, keys past S) to
//   -1e30, the row max over the four threads that share a row (a tree in
//   each thread, then two shuffles), p = exp(s - m) where kept and 0
//   elsewhere, corr = exp(m_old - m_new), l and the accumulator rescaled:
//   the TPU kernel's arithmetic, in float32, with the exponentials taken
//   in base 2 (scale * log2(e) folded into one multiply, then ex2.approx:
//   p within ~1e-6 of exp's at |s| <= 30, far inside the tolerance). The
//   softmax's dependent instructions, not the tensor cores, are the
//   critical path (two warps to a scheduler hide little latency), so the
//   mask is computed only on tiles that cross the diagonal, the window's
//   edge or S, the row reductions are trees, not chains, and while one
//   warpgroup runs its softmax the other's wgmma run.
// - O += P V: the S accumulator's fragment is the A-register fragment of
//   wgmma, so P never goes through shared memory. Rounding P to bfloat16
//   once would leave the reference's float32 P V by up to 2^-9 max|v|;
//   instead P = P_hi + P_lo with P_hi = bf16(P) and P_lo = bf16(P - P_hi)
//   (the residual is at most 2^-17 |P|), and both go through
//   wgmma.m64n64k16 (n32 at hd = 32) into the same float32 accumulator,
//   V read MN-major (the transpose bit of 16-bit types). The accumulator
//   is hd/2 floats a thread (128 at hd = 256).
// - Key tiles above the causal diagonal or before the window are never
//   loaded; o = acc / max(l, 1e-30) is stored as bfloat16 from registers.
// Shared memory at hd = 256: Q 64 KB and two stages of K and V, 192 KB;
// one block of 384 threads per SM.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

#include "../../csrc/wgmma.cuh"

namespace {  // internal linkage: the kernel's symbols are this library's own
namespace flash_sm90 {

constexpr int kWGs = 2;                      // consumer warpgroups a block
constexpr int kRowsWG = 64;                  // query rows of a warpgroup
constexpr int kBlockQ = kWGs * kRowsWG;      // query rows per block
constexpr int kBlockK = 64;                  // keys per tile
constexpr int kStages = 2;                   // K/V ring
constexpr int kConsumers = 128 * kWGs;
constexpr int kThreads = kConsumers + 128;   // and one producer warpgroup
// registers a thread after setmaxnreg: the producer gives back what the
// consumers take (3 x 128 x 168 = 128 x 24 + 256 x 240, within 65,536)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  CUtensorMap tq, tk, tv;  // (hd, heads, S, B) boxes of (E, 1, 64, 1)
  __nv_bfloat16* o;
  long long o_sb, o_ss, o_sh;
  int S;
  int H;       // query heads
  int group;   // H / Hkv
  int causal;
  int window;        // 0: none
  float scale_log2;  // 1/sqrt(hd) * log2(e)
};

template <int HD>
struct Cfg {
  static constexpr int E = HD < 64 ? HD : 64;            // elements of a swizzled row
  static constexpr int SW = 2 * E;                        // its bytes: the swizzle span
  static constexpr uint64_t kLayout = SW == 128 ? 1 : 2;  // descriptor: 128B or 64B swizzle
  static constexpr int NB = HD / E;                       // column blocks of a tile
  static constexpr int kBlockBytes = 64 * SW;             // one [64 x E] column block
  static constexpr int kTile = NB * kBlockBytes;          // one [64 x HD] tile
  static constexpr int ON = E / 2;                        // accumulator floats per block
  static constexpr int kSmem = (kWGs + 2 * kStages) * kTile + 1024 + 64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

using repro_wgmma::desc;
using repro_wgmma::fence_regs;
using repro_wgmma::wg_commit;
using repro_wgmma::wg_fence;
using repro_wgmma::wg_wait;

// D[64 x 64] += A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (the accumulator
// fragment layout), B MN-major in shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32], A in registers (the accumulator
// fragment layout), B MN-major in shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// is key kpos kept for query qpos: causal, inside the window, before S
// (bitwise, so that the compiler makes predicates and no branches)
__device__ __forceinline__ bool keeps(const Params& p, int qpos, int kpos) {
  return (kpos < p.S) & (!p.causal | (kpos <= qpos)) & ((p.window <= 0) | (kpos > qpos - p.window));
}

// the 16 values of row half rh (s[4j + 2rh + c]) folded by op as a tree:
// four levels of independent operations instead of a chain of fifteen,
// written out so that every value stays in a register
template <int RH, typename Op>
__device__ __forceinline__ float row_reduce(const float (&s)[32], Op op) {
  const float a0 = op(s[0 + 2 * RH], s[16 + 2 * RH]), a1 = op(s[1 + 2 * RH], s[17 + 2 * RH]);
  const float a2 = op(s[4 + 2 * RH], s[20 + 2 * RH]), a3 = op(s[5 + 2 * RH], s[21 + 2 * RH]);
  const float a4 = op(s[8 + 2 * RH], s[24 + 2 * RH]), a5 = op(s[9 + 2 * RH], s[25 + 2 * RH]);
  const float a6 = op(s[12 + 2 * RH], s[28 + 2 * RH]), a7 = op(s[13 + 2 * RH], s[29 + 2 * RH]);
  return op(op(op(a0, a4), op(a1, a5)), op(op(a2, a6), op(a3, a7)));
}

// 2^x, flushing results below 2^-126 to 0 (p that small adds nothing)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__device__ __forceinline__ void pv(float (&o)[Cfg<HD>::ON], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 32)
    wgmma_rs_m64n32k16(o, a, db);
  else
    wgmma_rs_m64n64k16(o, a, db);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bf16(const __grid_constant__ Params p) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  auto sQ = [&](int w) { return base + (uint32_t)(w * C::kTile); };
  auto sK = [&](int s) { return base + (uint32_t)((kWGs + 2 * s) * C::kTile); };
  auto sV = [&](int s) { return base + (uint32_t)((kWGs + 2 * s + 1) * C::kTile); };
  const uint32_t bars = base + (uint32_t)((kWGs + 2 * kStages) * C::kTile);
  const uint32_t bar_q = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStages + s); };

  // one flat grid, ordered longest rows first across every (batch, head):
  // block i takes query tile nq - 1 - i / (B H), so the long causal tiles
  // start first and the short ones fill in behind them
  const int tid = threadIdx.x;
  const int bh = gridDim.x / ((p.S + kBlockQ - 1) / kBlockQ);  // B * H
  const int q0 = (gridDim.x / bh - 1 - (int)blockIdx.x / bh) * kBlockQ;
  const int h = (int)blockIdx.x % bh % p.H, b = (int)blockIdx.x % bh / p.H;
  const int hk = h / p.group;
  const int last = p.causal ? min(q0 + kBlockQ - 1, p.S - 1) : p.S - 1;
  const int first = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kt0 = first / kBlockK, kt1 = last / kBlockK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      mbar_expect_tx(bar_q, kWGs * C::kTile);
      for (int w = 0; w < kWGs; ++w)
        for (int c = 0; c < C::NB; ++c)
          tma_load(sQ(w) + c * C::kBlockBytes, &p.tq, bar_q, c * C::E, h, q0 + w * kRowsWG, b);
      for (int kt = kt0, i = 0; kt <= kt1; ++kt, ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);  // the first pass is free
        mbar_expect_tx(full(s), 2 * C::kTile);
        for (int c = 0; c < C::NB; ++c) {
          tma_load(sK(s) + c * C::kBlockBytes, &p.tk, full(s), c * C::E, hk, kt * kBlockK, b);
          tma_load(sV(s) + c * C::kBlockBytes, &p.tv, full(s), c * C::E, hk, kt * kBlockK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns query rows qw .. qw + 63 and computes on
  // the tiles from its own first to its own last; on the block's other
  // tiles it only releases the stage. Thread t holds rows r0 and r0 + 8
  // and, in each 8-wide column block of an accumulator, columns c0, c0 + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = tid / 128, lane = tid & 31;
  const int qw = q0 + wg * kRowsWG;
  const int r0 = ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const int own0 = p.window > 0 ? max(0, qw - p.window + 1) / kBlockK : 0;
  const int own1 = qw >= p.S ? -1 : (p.causal ? min(qw + kRowsWG - 1, p.S - 1) : p.S - 1) / kBlockK;
  float o[C::NB][C::ON];
#pragma unroll
  for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
    for (int i = 0; i < C::ON; ++i) o[nb][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int kt = kt0, i = 0; kt <= kt1; ++kt, ++i) {
    const int st = i % kStages;
    mbar_wait(full(st), (i / kStages) & 1);
    if (kt < own0 || kt > own1) {
      mbar_arrive(empty(st));
      continue;
    }

    float s[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) s[k] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) {
      const uint32_t off = (k / (C::E / 16)) * C::kBlockBytes + (k % (C::E / 16)) * 32;
      wgmma_ss_m64n64k16(s, desc(sQ(wg) + off, 16, 8 * C::SW, C::kLayout),
                         desc(sK(st) + off, 16, 8 * C::SW, C::kLayout));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(s);

    // scores in base 2: t = s * scale * log2(e), masked to -1e30 on the
    // tiles that cross the diagonal, the window's edge or S; then the
    // running max m (base 2), p = 2^(t - m) where kept and 0 elsewhere,
    // corr = 2^(m_old - m_new): the reference's exp(s scale - m) in base 2.
    // s[4j + 2rh + c] is (row r0 + 8rh, key 8j + c0 + c).
    const int k0 = kt * kBlockK;
    const bool edge = (p.causal && k0 + kBlockK - 1 > qw) ||
                      (p.window > 0 && k0 <= qw + kRowsWG - 1 - p.window) ||
                      k0 + kBlockK > p.S;
    if (edge) {
#pragma unroll
      for (int idx = 0; idx < 32; ++idx)
        s[idx] = keeps(p, qw + r0 + 8 * ((idx >> 1) & 1), k0 + 8 * (idx >> 2) + c0 + (idx & 1))
                     ? s[idx] * p.scale_log2
                     : kNegInf;
    } else {
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) s[idx] *= p.scale_log2;
    }
    const auto fmax2 = [](float a, float b) { return fmaxf(a, b); };
    const auto add2 = [](float a, float b) { return a + b; };
    float mx[2] = {row_reduce<0>(s, fmax2), row_reduce<1>(s, fmax2)}, corr[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(kFull, mx[rh], 1));
      mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(kFull, mx[rh], 2));
      const float m_new = fmaxf(m[rh], mx[rh]);
      corr[rh] = ex2(m[rh] - m_new);
      m[rh] = m_new;
    }
    if (edge) {
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) {
        const int rh = (idx >> 1) & 1;
        s[idx] = keeps(p, qw + r0 + 8 * rh, k0 + 8 * (idx >> 2) + c0 + (idx & 1))
                     ? ex2(s[idx] - m[rh])
                     : 0.f;
      }
    } else {
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) s[idx] = ex2(s[idx] - m[(idx >> 1) & 1]);
    }
    l[0] = l[0] * corr[0] + row_reduce<0>(s, add2);
    l[1] = l[1] * corr[1] + row_reduce<1>(s, add2);
#pragma unroll
    for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
      for (int i = 0; i < C::ON; ++i) o[nb][i] *= corr[(i >> 1) & 1];

    // P = P_hi + P_lo as A fragments: register r of the 16-key block kk
    // holds P at s[8kk + 2r] and s[8kk + 2r + 1]
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a0 = s[8 * kk + 2 * r], a1 = s[8 * kk + 2 * r + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(a0, a1);
        const float2 hf = __bfloat1622float2(h2);
        hi[kk][r] = bf16x2_bits(h2);
        lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(a0 - hf.x, a1 - hf.y));
      }
#pragma unroll
    for (int nb = 0; nb < C::NB; ++nb) fence_regs(o[nb]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < C::NB; ++nb) {
        const uint64_t dv = desc(sV(st) + nb * C::kBlockBytes + kk * 16 * C::SW, C::kBlockBytes,
                                 8 * C::SW, C::kLayout);
        pv<HD>(o[nb], hi[kk], dv);
        pv<HD>(o[nb], lo[kk], dv);
      }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int nb = 0; nb < C::NB; ++nb) fence_regs(o[nb]);
    mbar_arrive(empty(st));
  }

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    l[rh] += __shfl_xor_sync(kFull, l[rh], 1);
    l[rh] += __shfl_xor_sync(kFull, l[rh], 2);
    l[rh] = fmaxf(l[rh], 1e-30f);
  }
  __nv_bfloat16* out = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int qpos = qw + r0 + 8 * rh;
    if (qpos >= p.S) continue;
#pragma unroll
    for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
      for (int j = 0; j < C::ON / 4; ++j) {
        const int i = 4 * j + 2 * rh;
        *reinterpret_cast<__nv_bfloat162*>(out + qpos * p.o_ss + nb * C::E + 8 * j + c0) =
            __floats2bfloat162_rn(o[nb][i] / l[rh], o[nb][i + 1] / l[rh]);
      }
  }
}

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// already loaded: the library links no libcuda of its own
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (lib) fn = reinterpret_cast<EncodeFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a map over [B, S, heads, hd] through its strides (elements), as dims
// (hd, heads, S, B), boxes of (E, 1, 64, 1), swizzled as wgmma reads them
template <int HD>
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, long long sb,
              long long ss, long long sh) {
  using C = Cfg<HD>;
  const EncodeFn encode = encode_fn();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::E, 1, (cuuint32_t)kBlockK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const long long* qs, const void* k, const long long* ks,
           const void* v, const long long* vs, void* o, const long long* os, int B, int S,
           int H, int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  Params p{};
  if (!make_map<HD>(&p.tq, q, B, S, H, qs[0], qs[1], qs[2]) ||
      !make_map<HD>(&p.tk, k, B, S, Hkv, ks[0], ks[1], ks[2]) ||
      !make_map<HD>(&p.tv, v, B, S, Hkv, vs[0], vs[1], vs[2]))
    return (int)cudaErrorInvalidValue;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = os[0], p.o_ss = os[1], p.o_sh = os[2];
  p.S = S, p.H = H, p.group = H / Hkv, p.causal = causal, p.window = window;
  p.scale_log2 = scale * 1.4426950408889634f;
  const long long blocks = (long long)((S + kBlockQ - 1) / kBlockQ) * H * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bf16<HD><<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace flash_sm90
}  // namespace
