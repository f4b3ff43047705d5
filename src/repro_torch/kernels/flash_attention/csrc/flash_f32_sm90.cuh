// The float32 instantiation of flash_attention: both products on the
// tensor cores as split TF32 (3xTF32) mma.sync, K and V brought in by
// cp.async. Included by flash_attention.cu; the arithmetic is the one
// stated there (the TPU kernel's _flash_kernel).
//
// What bounds it on an H100: operations. At gemma-2b's prefill (B = 4,
// S = 1024, H = 8, Hkv = 1, hd = 256) the two products over the kept
// causal pairs are 17.2 GFLOP, 0.0347 ms at 495 TFLOP/s dense TF32,
// against 75.5 MB of q, k, v and o (22.5 us at 3.35 TB/s). This kernel
// does three TF32 products for each float32 one (below): 51.5 GFLOP of
// its own, 0.104 ms.
//
// Why split TF32: ../../csrc/tf32x3.cuh (one TF32 product would leave the
// reference's float32 tolerance, 2e-5, by two orders of magnitude).
//
// The design. A block owns 64 query rows of one (batch, head), 16 rows (the
// M of mma.m16n8k8) to a warp, and walks the 64-key tiles from the
// window's first to the causal diagonal (the TPU kernel's
// pl.when(relevant) skip). A warp takes at most 128 columns of o: at
// hd = 256 two warps share 16 rows, each computing Q K^T over its half of
// the dimensions, the two halves summed through shared memory, and P V
// for its half of the columns; so every warp holds 64 accumulators of o
// and an SM runs 8 warps at each head_dim. One flat grid issues the query
// tiles with the most key tiles first across every (batch, head).
// - Loads. cp.async (16-byte copies, rows past S filled with zeros) of the
//   Q tile once, scaled by 1/sqrt(hd) in place in float32, and of the K
//   and V tiles: V of tile t is in flight while Q K_t^T is computed, K of
//   tile t + 1 while P V_t is.
// - S = Q K^T: per 16 dimensions a warp reads its Q rows and the 64 key
//   rows as 16-byte vectors (rows padded to hd + 16 floats: the 8 lanes of
//   a read phase fall in 8 bank groups), the dimensions taken in the
//   order the vector gives them (both operands alike, so the dot product
//   is unchanged), and issues the 48 products term by term across the 8
//   independent 8-key accumulators, so that no product waits on the one
//   before it. A warp skips the 8-key blocks past its own last row
//   (causal) or before its first row's window.
// - Softmax in registers, in float32: the mask (causal, window, keys past
//   S) to -1e30 on the tiles that cross an edge, the row max over the four
//   lanes that share a row, p = exp(s - m) where kept and 0 elsewhere,
//   corr = exp(m_old - m_new), l and the accumulator rescaled; the
//   exponentials in base 2 (__expf: ex2.approx of x log2(e), within 3e-6
//   relative of expf at |x| <= 30, far inside the tolerance).
// - O += P V: the S accumulator is the A fragment of the next mma, read
//   with the keys in the order the accumulator holds them (lane t holds
//   keys 2t, 2t + 1 of each 8-key block), so P never goes through shared
//   memory; the V rows are read in that order (rows padded to hd + 4
//   floats: conflict-free 4-byte reads), and the products again go term
//   by term across the 16 column blocks.
// - o = acc / max(l, 1e-30), stored from registers.
// The query heads of a KV head are not folded into one block's rows: at a
// fixed 64-row tile the fold changes neither the number of key tiles nor
// the K/V bytes a tile brings per row; the 8 heads of gemma-2b's KV head
// are neighbours in the grid and share the K/V tiles in L2 instead.
// Shared memory at hd = 256: Q and K 69,632 bytes each, V 66,560 and the
// score exchange 16,384; one block of 256 threads per SM (two blocks of
// 128 at hd = 128).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/tf32x3.cuh"

namespace {  // internal linkage: the kernel's symbols are this library's own
namespace flash_f32 {

constexpr int kBlockQ = 64;  // query rows per block, 16 to a warp
constexpr int kBlockK = 64;           // keys per tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int S, H;
  int group;   // H / Hkv
  int causal;
  int window;  // 0: none
  float scale;
};

template <int HD>
struct Cfg {
  static constexpr int DW = HD < 128 ? HD : 128;  // columns of o (and dims of Q K^T) a warp takes
  static constexpr int WPR = HD / DW;             // warps that share 16 rows
  static constexpr int kThreads = 4 * 32 * WPR;
  static constexpr int LDQ = HD + 16;  // Q and K rows: 16-byte reads without conflicts
  static constexpr int LDV = HD + 4;   // V rows: 4-byte reads without conflicts
  static constexpr int kXch = WPR > 1 ? 4 * 16 * kBlockK : 0;  // floats of the score exchange
  static constexpr int kSmem =
      (int)sizeof(float) * (kBlockQ * LDQ + kBlockK * (LDQ + LDV) + kXch);
  static constexpr int kMinBlocks = HD == 256 ? 1 : 2;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

using repro_tf32::mma;
using repro_tf32::split;

__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

// is key kpos kept for query qpos: causal, inside the window, before S
__device__ __forceinline__ bool keeps(const Params& p, int qpos, int kpos) {
  return (kpos < p.S) & (!p.causal | (kpos <= qpos)) & ((p.window <= 0) | (kpos > qpos - p.window));
}

// rows 0 .. 63 of a [S, hd] slab (row stride ss) from row r0 into dst
// (row stride ld), 16 bytes at a time; rows past S as zeros
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, long long ss,
                                          int r0, int S) {
  constexpr int C = HD / 4;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < kBlockK * C; e += Cfg<HD>::kThreads) {
    const int r = e / C, c = e % C;
    const bool in = r0 + r < S;
    cp_async16(dst + r * ld + 4 * c, in ? src + (r0 + r) * ss + 4 * c : src, in);
  }
  cp_async_commit();
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::kThreads, Cfg<HD>::kMinBlocks)
    flash_fwd(const Params p) {
  using C = Cfg<HD>;
  constexpr int LDQ = C::LDQ, LDV = C::LDV, DW = C::DW, NB = DW / 8;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBlockQ * LDQ;
  float* sV = sK + kBlockK * LDQ;
  float* sX = sV + kBlockK * LDV;  // [4 slabs][32 scores][32 lanes] at hd = 256

  // one flat grid, ordered longest rows first across every (batch, head):
  // block i takes query tile nq - 1 - i / (B H)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab = warp & 3, half = warp >> 2;  // rows 16 slab ..; columns half DW ..
  const int g = lane >> 2, t = lane & 3;
  const int nq = (p.S + kBlockQ - 1) / kBlockQ;
  const int bh = gridDim.x / nq;  // B * H
  const int q0 = (nq - 1 - (int)blockIdx.x / bh) * kBlockQ;
  const int h = (int)blockIdx.x % bh % p.H, b = (int)blockIdx.x % bh / p.H;
  const int hk = h / p.group;
  const float* qg = p.q + b * p.q_sb + h * p.q_sh;
  const float* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vg = p.v + b * p.v_sb + hk * p.v_sh;

  const int last = p.causal ? min(q0 + kBlockQ - 1, p.S - 1) : p.S - 1;
  const int first = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kt0 = first / kBlockK, kt1 = last / kBlockK;

  load_tile<HD>(sQ, LDQ, qg, p.q_ss, q0, p.S);
  load_tile<HD>(sK, LDQ, kg, p.k_ss, kt0 * kBlockK, p.S);
  cp_async_wait_all();
  // q * scale in float32, each thread on the chunks it copied
  for (int e = tid; e < kBlockQ * HD / 4; e += C::kThreads) {
    float4* c = reinterpret_cast<float4*>(sQ + (e / (HD / 4)) * LDQ + 4 * (e % (HD / 4)));
    const float4 v = *c;
    *c = make_float4(v.x * p.scale, v.y * p.scale, v.z * p.scale, v.w * p.scale);
  }
  __syncthreads();

  // this warp's rows r0 .. r0 + 15; lane (g, t) holds rows r0 + g and
  // r0 + g + 8 and, in each 8-wide block of an accumulator, columns 2t, 2t + 1
  const int r0 = q0 + 16 * slab;
  const int lastw = r0 >= p.S ? -1 : p.causal ? min(r0 + 15, p.S - 1) : p.S - 1;
  float o[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nb][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float* qp = sQ + (16 * slab + g) * LDQ + half * DW + 4 * t;
  const float* kp = sK + g * LDQ + half * DW + 4 * t;
  const float* vp = sV + 2 * t * LDV + half * DW + g;

  for (int kt = kt0; kt <= kt1; ++kt) {
    const int k0 = kt * kBlockK;
    load_tile<HD>(sV, LDV, vg, p.v_ss, k0, p.S);

    // the 8-key blocks [jlo, jhi) that hold a kept key for some row of the warp
    const int jhi = min(8, max(0, (lastw - k0 + 8) >> 3));
    const int wlo = p.window > 0 ? r0 - p.window + 1 - k0 : 0;
    const int jlo = wlo > 0 ? min(8, wlo >> 3) : 0;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll 1
    for (int d = 0; d < DW; d += 16) {
      const float4 qa = *reinterpret_cast<const float4*>(qp + d);
      const float4 qb = *reinterpret_cast<const float4*>(qp + 8 * LDQ + d);
      // two steps of 8 dimensions: (4t, 4t + 1) and (4t + 2, 4t + 3)
      uint32_t ah[2][4], al[2][4];
      split(qa.x, ah[0][0], al[0][0]);
      split(qb.x, ah[0][1], al[0][1]);
      split(qa.y, ah[0][2], al[0][2]);
      split(qb.y, ah[0][3], al[0][3]);
      split(qa.z, ah[1][0], al[1][0]);
      split(qb.z, ah[1][1], al[1][1]);
      split(qa.w, ah[1][2], al[1][2]);
      split(qb.w, ah[1][3], al[1][3]);
      uint32_t bh[8][4], bl[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(kp + 8 * j * LDQ + d);
        split(kv.x, bh[j][0], bl[j][0]);
        split(kv.y, bh[j][1], bl[j][1]);
        split(kv.z, bh[j][2], bl[j][2]);
        split(kv.w, bh[j][3], bl[j][3]);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j >= jlo && j < jhi) mma(s[j], al[k], bh[j][2 * k], bh[j][2 * k + 1]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j >= jlo && j < jhi) mma(s[j], ah[k], bl[j][2 * k], bl[j][2 * k + 1]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j >= jlo && j < jhi) mma(s[j], ah[k], bh[j][2 * k], bh[j][2 * k + 1]);
      }
    }
    if constexpr (C::WPR == 2) {  // S = (dims of half 0) + (dims of half 1)
      float* xb = sX + slab * 16 * kBlockK + lane;
      if (half) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) xb[(4 * j + i) * 32] = s[j][i];
      }
      pair_sync(1 + slab);
      if (!half) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[j][i] += xb[(4 * j + i) * 32];
            xb[(4 * j + i) * 32] = s[j][i];
          }
      }
      pair_sync(1 + slab);
      if (half) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] = xb[(4 * j + i) * 32];
      }
    }

    // mask on the tiles that cross the diagonal, the window's edge or S;
    // s[j][2rh + c] is (row r0 + g + 8 rh, key k0 + 8j + 2t + c)
    const bool edge = (p.causal && k0 + kBlockK - 1 > r0) ||
                      (p.window > 0 && k0 <= r0 + 15 - p.window) || k0 + kBlockK > p.S;
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!keeps(p, r0 + g + 8 * (i >> 1), k0 + 8 * j + 2 * t + (i & 1))) s[j][i] = kNegInf;
    }
    float corr[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * rh], s[j][2 * rh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[rh], mx);
      corr[rh] = __expf(m[rh] - m_new);
      m[rh] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rh = i >> 1;
        const bool kept = !edge || keeps(p, r0 + g + 8 * rh, k0 + 8 * j + 2 * t + (i & 1));
        s[j][i] = kept ? __expf(s[j][i] - m[rh]) : 0.f;
        rs[rh] += s[j][i];
      }
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      o[nb][0] *= corr[0];
      o[nb][1] *= corr[0];
      o[nb][2] *= corr[1];
      o[nb][3] *= corr[1];
    }

    cp_async_wait_all();
    __syncthreads();  // V_t in place; every warp is done with K_t
    if (kt < kt1) load_tile<HD>(sK, LDQ, kg, p.k_ss, k0 + kBlockK, p.S);

    // O += P V: A column t of 8-key block j is key 8j + 2t, column t + 4 key 8j + 2t + 1
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < jlo || j >= jhi) continue;
      uint32_t ph[4], pl[4];
      split(s[j][0], ph[0], pl[0]);
      split(s[j][2], ph[1], pl[1]);
      split(s[j][1], ph[2], pl[2]);
      split(s[j][3], ph[3], pl[3]);
      uint32_t vh[NB][2], vl[NB][2];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        split(vp[8 * j * LDV + 8 * nb], vh[nb][0], vl[nb][0]);
        split(vp[(8 * j + 1) * LDV + 8 * nb], vh[nb][1], vl[nb][1]);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma(o[nb], pl, vh[nb][0], vh[nb][1]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma(o[nb], ph, vl[nb][0], vl[nb][1]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma(o[nb], ph, vh[nb][0], vh[nb][1]);
    }
    cp_async_wait_all();
    __syncthreads();  // K_t+1 in place; every warp is done with V_t
  }

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    l[rh] += __shfl_xor_sync(kFull, l[rh], 1);
    l[rh] += __shfl_xor_sync(kFull, l[rh], 2);
    l[rh] = fmaxf(l[rh], 1e-30f);
  }
  float* out = p.o + b * p.o_sb + h * p.o_sh + half * DW;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int qpos = r0 + g + 8 * rh;
    if (qpos >= p.S) continue;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      *reinterpret_cast<float2*>(out + qpos * p.o_ss + 8 * nb + 2 * t) =
          make_float2(o[nb][2 * rh] / l[rh], o[nb][2 * rh + 1] / l[rh]);
  }
}

template <int HD>
int launch(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<HD>;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long blocks = (long long)((p.S + kBlockQ - 1) / kBlockQ) * p.H * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd<HD><<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace flash_f32
}  // namespace
