// dp_perturb: the fused local SGD step with DP noise over a table of
// contiguous parameter leaves, one launch for all of them, by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/dp_perturb/dp_perturb.py::
// _dp_perturb_kernel (pallas_call in dp_perturb_2d). For every element e
// of a leaf:
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
// The TPU kernel walks [256, 128] tiles of one leaf and pads it to whole
// rows; its noise counters depend only on the flattened index (noise.cuh::
// perturb_counter), so here a thread takes elements of the unpadded leaf
// and the wrapper needs no padding copy.
//
// One launch per round. The tree path updates every leaf of the model at
// once (sgd_update_leaves): the table of up to kMaxLeaves (p, g, x, xt, n)
// entries is a kernel parameter, passed by value (__grid_constant__), so
// the launch makes no host-to-device copy that would wait on the stream.
// The grid is flat over all the leaves' chunks of kChunk elements; a block
// finds its leaf from the table's prefix of block offsets.
//
// What bounds it on an H100: bytes. On the paper's tree path (N = 10,
// dwfl-paper) a round updates 8,550,500 float32 elements in six leaves:
// p and g read and x written is 102.6 MB, 30.6 us at 3.35 TB/s; the
// update is one FMA per element. With noise, xt adds a fourth array and a
// hash, a log, a cos and a square root per element, still under the memory
// time at 67 TFLOP/s. Where a leaf's pointers are 16-byte aligned, a
// thread moves 16 bytes per load and store (4 float32 or 8 bfloat16
// elements); otherwise, and for the tail, one element at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/dtypes.cuh"
#include "../../csrc/noise.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 16;
constexpr long long kChunk = 2048;           // elements per block (f32 and bf16)

using repro_dtypes::load_f;
using repro_dtypes::store_f;

struct Leaf {
  const void* p;
  const void* g;
  void* x;
  void* xt;
  long long n;
  long long block0;  // first block of this leaf in the flat grid
  int vec;           // p, g, x (and xt) 16-byte aligned
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int count;
  float gamma, s_sig, noise_scale;
};

template <int kMode>
__device__ __forceinline__ float noisy(const Table& t, float x, long long e, uint32_t seed) {
  if (kMode == 1) return __fmul_rn(t.s_sig, x);
  const uint32_t c1 = repro_noise::perturb_counter((unsigned long long)e, seed);
  const float u1 = repro_noise::uniform_from_bits(repro_noise::hash_bits(c1, seed));
  const float u2 = repro_noise::uniform_from_bits(repro_noise::hash_bits(c1 + 32768u, seed));
  const float G = repro_noise::box_muller(u1, u2);
  return fmaf(t.s_sig, x, __fmul_rn(G, t.noise_scale));
}

template <typename T, int kMode>
__device__ __forceinline__ void one(const Table& t, const Leaf& L, long long e, uint32_t seed) {
  const float x = fmaf(-t.gamma, load_f(static_cast<const T*>(L.g), e),
                       load_f(static_cast<const T*>(L.p), e));
  store_f(static_cast<T*>(L.x), e, x);
  if (kMode != 0) store_f(static_cast<T*>(L.xt), e, noisy<kMode>(t, x, e, seed));
}

// 16 bytes of T as floats, and back
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const void* base, long long e, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(static_cast<const float*>(base) + e);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  __device__ __forceinline__ static void store(void* base, long long e, const float* f) {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + e) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const void* base, long long e, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + e);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 two = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = two.x, f[2 * i + 1] = two.y;
    }
  }
  __device__ __forceinline__ static void store(void* base, long long e, const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 two = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&two);
    }
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + e) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
dp_perturb_kernel(const __grid_constant__ Table t, const int32_t* __restrict__ seed_ptr) {
  const uint32_t seed = kMode == 2 ? (uint32_t)seed_ptr[0] : 0u;
  int li = 0;
  for (int j = 1; j < t.count; ++j)
    if ((long long)blockIdx.x >= t.leaf[j].block0) li = j;
  const Leaf& L = t.leaf[li];
  const long long base = ((long long)blockIdx.x - L.block0) * kChunk;
  const long long end = min(base + kChunk, L.n);
  if (L.vec) {
    constexpr int V = Vec<T>::kN;
#pragma unroll
    for (int it = 0; it < (int)(kChunk / (kThreads * V)); ++it) {
      const long long e = base + ((long long)it * kThreads + threadIdx.x) * V;
      if (e + V <= end) {
        float p[V], g[V], x[V];
        Vec<T>::load(L.p, e, p);
        Vec<T>::load(L.g, e, g);
#pragma unroll
        for (int i = 0; i < V; ++i) x[i] = fmaf(-t.gamma, g[i], p[i]);
        Vec<T>::store(L.x, e, x);
        if (kMode != 0) {
#pragma unroll
          for (int i = 0; i < V; ++i) p[i] = noisy<kMode>(t, x[i], e + i, seed);
          Vec<T>::store(L.xt, e, p);
        }
      } else {
        for (long long k = e; k < end && k < e + V; ++k) one<T, kMode>(t, L, k, seed);
      }
    }
  } else {
    for (long long e = base + threadIdx.x; e < end; e += kThreads) one<T, kMode>(t, L, e, seed);
  }
}

template <typename T>
int launch(int mode, const Table& t, long long blocks, const void* seed, cudaStream_t stream) {
  const int32_t* ss = static_cast<const int32_t*>(seed);
  if (mode == 0)
    dp_perturb_kernel<T, 0><<<(unsigned)blocks, kThreads, 0, stream>>>(t, ss);
  else if (mode == 1)
    dp_perturb_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(t, ss);
  else
    dp_perturb_kernel<T, 2><<<(unsigned)blocks, kThreads, 0, stream>>>(t, ss);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15u) == 0; }

}  // namespace

extern "C" {

// One launch over `count` leaves (1 <= count <= 16). dtype: 0 = float32,
// 1 = bfloat16 (every p, g, x, xt). mode: 0 = x only, 1 = x and xt =
// s_sig * x, 2 = x and the noisy xt (count must be 1: the counters are a
// leaf's own element indices). ptrs: a host array of 4 * count device
// pointers, every leaf's p, then every g, x and xt (xt unread in mode 0);
// n: a host array of the leaves' element counts. seed: int32 [1] on the
// device (read in mode 2 only). Returns the cudaError_t of the launch (0 =
// launched).
int dp_perturb_launch(int dtype, int mode, int count, void* const* ptrs, const long long* n,
                      const void* seed, float gamma, float s_sig, float noise_scale,
                      void* stream) {
  if (count < 1 || count > kMaxLeaves || mode < 0 || mode > 2 || (mode == 2 && count != 1))
    return (int)cudaErrorInvalidValue;
  Table t{};
  t.count = count;
  t.gamma = gamma, t.s_sig = s_sig, t.noise_scale = noise_scale;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 1) return (int)cudaErrorInvalidValue;
    const void* p = ptrs[i];
    const void* g = ptrs[count + i];
    void* x = ptrs[2 * count + i];
    void* xt = mode == 0 ? nullptr : ptrs[3 * count + i];
    t.leaf[i] = Leaf{p, g, x, xt, n[i], blocks,
                     aligned16(p) && aligned16(g) && aligned16(x) && (mode == 0 || aligned16(xt))};
    blocks += (n[i] + kChunk - 1) / kChunk;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(mode, t, blocks, seed, s);
  if (dtype == 1) return launch<__nv_bfloat16>(mode, t, blocks, seed, s);
  return (int)cudaErrorInvalidValue;
}

const char* dp_perturb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
