// dp_perturb: the fused local SGD step with DP noise over one contiguous
// parameter leaf, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/dp_perturb/dp_perturb.py::
// _dp_perturb_kernel (pallas_call in dp_perturb_2d). For every element e:
//
//   x  = fma(-gamma, g, p)                                local SGD step
//   xt = fma(s_sig, x, G * noise_scale)                   mode 2 (noisy)
//   xt = s_sig * x                                        mode 1
//   (no xt at all)                                        mode 0
//
// noise_scale = sigma * s_noise folded in float32 by the wrapper, and G
// the Box-Muller normal of the reference's counter hash (noise.cuh), never
// the TPU's own PRNG. Mode 0 is sgd_update: the reference computes xt
// there and throws it away (ops.py:42-44); this kernel does not write it.
// The fused multiply-adds are where the reference's XLA CPU lowering has
// them (kernels/dp_perturb/dp_perturb.py says how they were found); every
// other operation is a round-to-nearest intrinsic, so nvcc contracts
// nothing else.
//
// The TPU kernel walks [256, 128] tiles and pads the leaf to whole rows;
// its noise counters depend only on the flattened index (noise.cuh::
// perturb_counter), so here each thread takes elements e, e + stride, ...
// of the unpadded leaf and the wrapper needs no padding copy.
//
// What bounds it on an H100: bytes. On the paper's tree path (N = 10,
// dwfl-paper) a round updates 8,550,500 float32 elements in six leaves:
// p and g read and x written is 102.6 MB, 30.6 us at 3.35 TB/s; the
// update is one FMA per element. With noise, xt adds a fourth array and a
// hash, a log, a cos and a square root per element, still under the memory
// time at 67 TFLOP/s. Loads are scalar and coalesced; vector loads are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/dtypes.cuh"
#include "../../csrc/noise.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident blocks on each of 132 SMs

using repro_dtypes::load_f;
using repro_dtypes::store_f;

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
dp_perturb_kernel(const T* __restrict__ p, const T* __restrict__ g, T* __restrict__ x_out,
                  T* __restrict__ xt_out, long long n, const int32_t* __restrict__ seed_ptr,
                  float gamma, float s_sig, float noise_scale) {
  const uint32_t seed = kMode == 2 ? (uint32_t)seed_ptr[0] : 0u;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n; e += stride) {
    const float x = fmaf(-gamma, load_f(g, e), load_f(p, e));
    store_f(x_out, e, x);
    if (kMode == 1) store_f(xt_out, e, __fmul_rn(s_sig, x));
    if (kMode == 2) {
      const uint32_t c1 = repro_noise::perturb_counter((unsigned long long)e, seed);
      const float u1 = repro_noise::uniform_from_bits(repro_noise::hash_bits(c1, seed));
      const float u2 = repro_noise::uniform_from_bits(repro_noise::hash_bits(c1 + 32768u, seed));
      const float G = repro_noise::box_muller(u1, u2);
      store_f(xt_out, e, fmaf(s_sig, x, __fmul_rn(G, noise_scale)));
    }
  }
}

template <typename T>
int launch(int mode, const void* p, const void* g, void* x, void* xt, long long n,
           const void* seed, float gamma, float s_sig, float noise_scale,
           cudaStream_t stream) {
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  const T* pp = static_cast<const T*>(p);
  const T* gg = static_cast<const T*>(g);
  T* xx = static_cast<T*>(x);
  T* tt = static_cast<T*>(xt);
  const int32_t* ss = static_cast<const int32_t*>(seed);
  if (mode == 0)
    dp_perturb_kernel<T, 0><<<blocks, kThreads, 0, stream>>>(pp, gg, xx, tt, n, ss, gamma,
                                                            s_sig, noise_scale);
  else if (mode == 1)
    dp_perturb_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(pp, gg, xx, tt, n, ss, gamma,
                                                            s_sig, noise_scale);
  else
    dp_perturb_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(pp, gg, xx, tt, n, ss, gamma,
                                                            s_sig, noise_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (p, g, x, xt). mode: 0 = x only,
// 1 = x and xt = s_sig * x, 2 = x and the noisy xt. seed: int32 [1] on the
// device (read in mode 2 only). Returns the cudaError_t of the launch
// (0 = launched).
int dp_perturb_launch(int dtype, int mode, const void* p, const void* g, void* x, void* xt,
                      long long n, const void* seed, float gamma, float s_sig,
                      float noise_scale, void* stream) {
  if (n < 1 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(mode, p, g, x, xt, n, seed, gamma, s_sig, noise_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(mode, p, g, x, xt, n, seed, gamma, s_sig, noise_scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* dp_perturb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
