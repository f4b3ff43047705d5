// dp_mix: the fused DWFL round over the flat [N, d] parameter buffer, by
// hand for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/dp_mix/dp_mix.py::_dp_mix_kernel
// (pallas_call in dp_mix_2d). For every column j of the buffer:
//
//   x   = p - gamma * g                                   local SGD step
//   nf  = (amp / c) * Gn,  Gm                             counter-hash noise
//   z   = x + nf
//   upd = W @ z - self * nf + (m_scale * sigma_m) * Gm    mix + AWGN
//   out = x + (eta * listen) * (upd - x)
//
// and with noisy == 0 (gossip) out = x + (eta * listen) * (W @ x - x).
// The arithmetic is that of _round_math (dp_mix.py); the noise is the
// reference's counter hash (noise.cuh), never the TPU's own PRNG, with
// counters 2 * ((r) * counter_width + col0 + j) and that plus 1.
//
// What bounds it on an H100: bytes. At the paper's shape (N = 10,
// d = 855,050, f32) it reads p and g and writes out once, 3 * N * d * 4 B
// = 102.6 MB, about 31 us at 3.35 TB/s, while the mix is 2 * N^2 * d =
// 0.17 GFLOP, about 3 us at 67 TFLOP/s (the noise adds some 2 * N * d
// hash-and-polynomial evaluations, still below the memory time). The
// design therefore touches each element of p, g and out exactly once:
// one thread owns one column, walks the N rows with coalesced loads,
// generates each element's two normals once, and stages x, nf and z for
// its column in shared memory, from which all N receivers' sums are
// formed (four output rows at a time, so each z is read N / 4 times).
// W and the per-worker vectors sit in shared memory. Nothing is tiled
// for the tensor cores: at N <= 64 the contraction is a few FMAs per
// byte. Wider loads, TMA and a tensor-core mix for large N are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/dtypes.cuh"
#include "../../csrc/noise.cuh"

namespace {

constexpr int kTile = 128;       // columns (= threads) per block
constexpr int kMaxWorkers = 64;  // largest N the shared-memory plan takes
constexpr int kRowBlock = 4;     // output rows summed together

using repro_dtypes::load_f;
using repro_dtypes::store_f;

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

__host__ __device__ inline size_t smem_floats(int n) {
  // W (rows padded to kRowBlock) + amp/c, self, m_scale*sigma_m,
  // eta*listen + x, nf, z tiles
  return (size_t)round_up(n, kRowBlock) * n + 4 * (size_t)n + 3 * (size_t)n * kTile;
}

template <typename T>
__global__ void __launch_bounds__(kTile)
dp_mix_kernel(const T* __restrict__ p, const T* __restrict__ g, T* __restrict__ out,
              const float* __restrict__ W, const float* __restrict__ amp,
              const float* __restrict__ selfs, const float* __restrict__ mscale,
              const float* __restrict__ listen, const float* __restrict__ scal,
              const int32_t* __restrict__ seed_ptr, const int32_t* __restrict__ col0_ptr,
              int n, int d, uint32_t counter_width, float gamma, float eta, int noisy) {
  extern __shared__ float smem[];
  const int nr = round_up(n, kRowBlock);
  float* sW = smem;              // [nr, n]
  float* sAmpC = sW + nr * n;    // amp / c
  float* sSelf = sAmpC + n;
  float* sMs = sSelf + n;        // m_scale * sigma_m
  float* sLe = sMs + n;          // eta * listen
  float* sX = sLe + n;           // [n, kTile]
  float* sNf = sX + n * kTile;
  float* sZ = sNf + n * kTile;

  const int tid = threadIdx.x;
  const float c = scal[0], sigma_m = scal[1];
  for (int i = tid; i < nr * n; i += kTile) sW[i] = i < n * n ? W[i] : 0.0f;
  for (int i = tid; i < n; i += kTile) {
    sAmpC[i] = __fdiv_rn(amp[i], c);
    sSelf[i] = selfs[i];
    sMs[i] = __fmul_rn(mscale[i], sigma_m);
    sLe[i] = __fmul_rn(eta, listen[i]);
  }
  __syncthreads();

  const int col = blockIdx.x * kTile + tid;
  if (col >= d) return;
  const uint32_t seed = (uint32_t)seed_ptr[0];
  const uint32_t gcol = (uint32_t)col0_ptr[0] + (uint32_t)col;

  // pass 1: x (and the DP noise) of every row of this column
  for (int k = 0; k < n; ++k) {
    const size_t off = (size_t)k * d + col;
    const float x = __fsub_rn(load_f(p, off), __fmul_rn(gamma, load_f(g, off)));
    sX[k * kTile + tid] = x;
    if (noisy) {
      const uint32_t idx = (uint32_t)k * counter_width + gcol;
      const float nf = __fmul_rn(
          sAmpC[k], repro_noise::normal_from_bits(repro_noise::hash_bits(2u * idx, seed)));
      sNf[k * kTile + tid] = nf;
      sZ[k * kTile + tid] = __fadd_rn(x, nf);
    }
  }
  // pass 2: every receiver's row from the staged column (only this
  // thread's own column is read back, so no barrier is needed)
  const float* src = noisy ? sZ : sX;
  for (int i0 = 0; i0 < n; i0 += kRowBlock) {
    float acc[kRowBlock];
#pragma unroll
    for (int r = 0; r < kRowBlock; ++r) acc[r] = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float zk = src[k * kTile + tid];
#pragma unroll
      for (int r = 0; r < kRowBlock; ++r) acc[r] = fmaf(sW[(i0 + r) * n + k], zk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowBlock; ++r) {
      const int i = i0 + r;
      if (i >= n) break;
      float upd = acc[r];
      if (noisy) {
        const uint32_t idx = (uint32_t)i * counter_width + gcol;
        const float gm =
            repro_noise::normal_from_bits(repro_noise::hash_bits(2u * idx + 1u, seed));
        upd = __fadd_rn(__fsub_rn(upd, __fmul_rn(sSelf[i], sNf[i * kTile + tid])),
                        __fmul_rn(sMs[i], gm));
      }
      const float x = sX[i * kTile + tid];
      store_f(out, (size_t)i * d + col, __fadd_rn(x, __fmul_rn(sLe[i], __fsub_rn(upd, x))));
    }
  }
}

template <typename T>
int launch(const void* p, const void* g, void* out, const void* W, const void* amp,
           const void* selfs, const void* mscale, const void* listen, const void* scal,
           const void* seed, const void* col0, int n, int d, uint32_t counter_width,
           float gamma, float eta, int noisy, cudaStream_t stream) {
  const size_t bytes = smem_floats(n) * sizeof(float);
  static size_t opted_in = 48 * 1024;  // shared memory granted without opt-in
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        dp_mix_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = bytes;
  }
  const int blocks = (d + kTile - 1) / kTile;
  dp_mix_kernel<T><<<blocks, kTile, bytes, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(g), static_cast<T*>(out),
      static_cast<const float*>(W), static_cast<const float*>(amp),
      static_cast<const float*>(selfs), static_cast<const float*>(mscale),
      static_cast<const float*>(listen), static_cast<const float*>(scal),
      static_cast<const int32_t*>(seed), static_cast<const int32_t*>(col0), n, d,
      counter_width, gamma, eta, noisy);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (p, g, out). Every other array is
// float32 on the device except seed and col0, int32 [1]. Returns the
// cudaError_t of the launch (0 = launched).
int dp_mix_launch(int dtype, const void* p, const void* g, void* out, const void* W,
                  const void* amp, const void* selfs, const void* mscale, const void* listen,
                  const void* scal, const void* seed, const void* col0, int n, int d,
                  unsigned int counter_width, float gamma, float eta, int noisy,
                  void* stream) {
  if (n < 1 || n > kMaxWorkers || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(p, g, out, W, amp, selfs, mscale, listen, scal, seed, col0, n, d,
                         counter_width, gamma, eta, noisy, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, g, out, W, amp, selfs, mscale, listen, scal, seed, col0,
                                 n, d, counter_width, gamma, eta, noisy, s);
  return (int)cudaErrorInvalidValue;
}

const char* dp_mix_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
