// float32 / bfloat16 element access of the port's CUDA kernels: every
// kernel computes in float32 and stores in its input's dtype.
#pragma once

#include <cuda_bf16.h>

#include <cstddef>

namespace repro_dtypes {

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

}  // namespace repro_dtypes
