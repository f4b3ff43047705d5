// flash_attention: causal streaming-softmax attention in the model's
// layout, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py::
// _flash_kernel (pallas_call in flash_attention_bh) together with its
// wrapper's GQA copies (ops.py: jnp.repeat of k and v, moveaxis to
// [B*H, S, hd]). It computes, for each batch b, query head h and row i,
//
//   o[b,i,h,:] = sum_j softmax_j(mask(q[b,i,h,:] * scale . k[b,j,hk,:])) v[b,j,hk,:]
//
// with hk = h / (H / Hkv), scale = 1/sqrt(hd) applied to q before the
// product, entries outside the causal diagonal, the sliding window or the
// sequence set to -1e30 and their probabilities to 0, a float32 running
// max m, normaliser l and accumulator, and acc / max(l, 1e-30) stored in
// the input's dtype: the TPU kernel's arithmetic.
//
// Layout. q is read as [B, S, H, hd] and k, v as [B, S, Hkv, hd] through
// their strides (elements; the last dimension contiguous), and o is
// written as [B, S, H, hd]: no repeat and no transpose copy.
//
// Two instantiations. bfloat16 inputs run on the tensor cores, with TMA
// loads and the products split so as to keep this arithmetic's float32
// tolerance (flash_bf16_sm90.cuh says how). float32 inputs run the design
// below, on the CUDA cores: TF32 tensor cores would leave the reference's
// float32 arithmetic.
//
// Work split (float32). The TPU walks a sequential (BH, q block, kv block) grid and
// carries m, l, acc in scratch from one kv step to the next. Here one
// block of 256 threads owns (b, h, 64 query rows) and loops over the
// 64-row KV tiles itself, from the window's first tile to the causal
// diagonal only (the TPU kernel's pl.when(relevant) skip). Blocks are
// issued longest rows first. Each of the 8 warps owns 8 query rows: lane
// c scores keys c and c + 32 of the tile for each row, the row max and
// sum are warp shuffles, and lane c accumulates output columns c, c + 32,
// ... of each row in registers (8 x hd/32 floats).
//
// Shared memory (float32): the scaled Q tile, the K
// and V tiles, rows padded to hd + 4 floats so that 16-byte loads of
// neighbouring rows fall in different banks, and each warp's 8 x 64
// probabilities. At hd = 256 that is 216,064 bytes, requested as dynamic
// shared memory above 48 KB with cudaFuncSetAttribute; one block per SM.
//
// What bounds the float32 kernel on an H100: operations. At gemma-2b's
// prefill (B = 4, S = 1024, H = 8, Hkv = 1, hd = 256, float32) the two
// products are 17.2 GFLOP after the causal halving, 0.256 ms at 67
// TFLOP/s on the CUDA cores, against 75.5 MB of q, k, v, o (22.5 us at
// 3.35 TB/s). It runs both products as float32 FMAs on the CUDA cores,
// fed from shared memory; register tiles, or 3xTF32 split products, and
// one KV tile shared by all query heads of a KV head are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "../../csrc/dtypes.cuh"
#include "flash_bf16_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 64;                 // query rows per block
constexpr int kBlockK = 64;                 // keys per KV tile
constexpr int kRows = kBlockQ / kWarps;     // query rows per warp
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

using repro_dtypes::load_f;
using repro_dtypes::store_f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int S;
  int group;   // H / Hkv
  int causal;
  int window;  // 0: none
  float scale;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(kBlockQ + 2 * kBlockK) * (HD + 4) + (size_t)kBlockQ * kBlockK);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd(const Params p) {
  constexpr int LD = HD + 4;   // padded row, in floats
  constexpr int NT = HD / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockQ * LD;
  float* sV = sK + kBlockK * LD;
  float* sP = sV + kBlockK * LD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, pos = q0 + r;
    sQ[r * LD + d] = pos < p.S ? load_f(q, (size_t)((long long)pos * p.q_ss + d)) * p.scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NT];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[r][t] = 0.f;
  }

  const int last = p.causal ? min(q0 + kBlockQ - 1, p.S - 1) : p.S - 1;
  const int first = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const float* qr = sQ + warp * kRows * LD;
  float* pw = sP + warp * kRows * kBlockK;

  for (int kt = first / kBlockK; kt <= last / kBlockK; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, pos = k0 + r;
      const bool in = pos < p.S;
      sK[r * LD + d] = in ? load_f(k, (size_t)((long long)pos * p.k_ss + d)) : 0.f;
      sV[r * LD + d] = in ? load_f(v, (size_t)((long long)pos * p.v_ss + d)) : 0.f;
    }
    __syncthreads();

    // scores of this warp's rows against keys lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float* ka_row = sK + lane * LD;
    const float* kb_row = sK + (lane + 32) * LD;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(ka_row + d);
      const float4 kb = *reinterpret_cast<const float4*>(kb_row + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + r * LD + d);
        s[r][0] = dot4(qv, ka, s[r][0]);
        s[r][1] = dot4(qv, kb, s[r][1]);
      }
    }

    // mask, online softmax, probabilities to shared memory
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r;
      bool ok[2];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        ok[c] = kpos < p.S && (!p.causal || kpos <= qpos) &&
                (p.window <= 0 || kpos > qpos - p.window);
        if (!ok[c]) s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float p0 = ok[0] ? expf(s[r][0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(s[r][1] - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
      pw[r * kBlockK + lane] = p0;
      pw[r * kBlockK + lane + 32] = p1;
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[r][t] *= corr;
    }
    __syncwarp();

    // acc += P V, four keys at a time
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float vv[4][NT];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int t = 0; t < NT; ++t) vv[jj][t] = sV[(j + jj) * LD + lane + 32 * t];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(pw + r * kBlockK + j);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          float a = fmaf(pp.x, vv[0][t], acc[r][t]);
          a = fmaf(pp.y, vv[1][t], a);
          a = fmaf(pp.z, vv[2][t], a);
          acc[r][t] = fmaf(pp.w, vv[3][t], a);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    if (qpos >= p.S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int t = 0; t < NT; ++t)
      store_f(o, (size_t)((long long)qpos * p.o_ss + lane + 32 * t), acc[r][t] / denom);
  }
}

template <typename T, int HD>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;  // once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd<T, HD><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_f32(int hd, const Params& p, int B, int H, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<float, 32>(p, B, H, stream);
    case 64: return launch<float, 64>(p, B, H, stream);
    case 128: return launch<float, 128>(p, B, H, stream);
    case 256: return launch<float, 256>(p, B, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_bf16(int hd, const Params& p, int B, int H, int Hkv, cudaStream_t stream) {
  const long long qs[3] = {p.q_sb, p.q_ss, p.q_sh}, ks[3] = {p.k_sb, p.k_ss, p.k_sh},
                  vs[3] = {p.v_sb, p.v_ss, p.v_sh}, os[3] = {p.o_sb, p.o_ss, p.o_sh};
#define REPRO_FLASH_BF16(HD)                                                                 \
  flash_sm90::launch<HD>(p.q, qs, p.k, ks, p.v, vs, p.o, os, B, p.S, H, Hkv, p.causal,        \
                         p.window, p.scale, stream)
  switch (hd) {
    case 32: return REPRO_FLASH_BF16(32);
    case 64: return REPRO_FLASH_BF16(64);
    case 128: return REPRO_FLASH_BF16(128);
    case 256: return REPRO_FLASH_BF16(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_BF16
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o alike). hd in {32, 64, 128,
// 256}; H a multiple of Hkv. Strides in elements: batch, sequence, head
// (the head_dim axis is contiguous). window: 0 = no sliding window.
// bfloat16 also needs q, k, v 16-byte aligned and their strides multiples
// of 8 elements (TMA). Returns the cudaError_t of the launch (0 =
// launched).
int flash_attention_launch(int dtype, int hd, int B, int S, int H, int Hkv,
                           const void* q, long long q_sb, long long q_ss, long long q_sh,
                           const void* k, long long k_sb, long long k_ss, long long k_sh,
                           const void* v, long long v_sb, long long v_ss, long long v_sh,
                           void* o, long long o_sb, long long o_ss, long long o_sh,
                           int causal, int window, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || window < 0 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           S, H / Hkv, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(hd, p, B, H, s);
  if (dtype == 1) return launch_bf16(hd, p, B, H, Hkv, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
