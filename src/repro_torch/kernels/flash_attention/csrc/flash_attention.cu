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
// Two instantiations, each in its own header, both on the tensor cores:
// float32 inputs as split TF32 mma.sync (flash_f32_sm90.cuh: each operand
// cut into two TF32 terms, three products for each float32 one, so the
// float32 tolerance holds), bfloat16 inputs as wgmma with TMA loads
// (flash_bf16_sm90.cuh: P split into two bfloat16 terms). Each header says
// what bounds it on an H100 and how its design meets that.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "flash_bf16_sm90.cuh"
#include "flash_f32_sm90.cuh"

namespace {

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

int launch_f32(int hd, const Params& p, int B, int H, cudaStream_t stream) {
  const flash_f32::Params f{static_cast<const float*>(p.q), static_cast<const float*>(p.k),
                            static_cast<const float*>(p.v), static_cast<float*>(p.o),
                            p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss, p.k_sh,
                            p.v_sb, p.v_ss, p.v_sh, p.o_sb, p.o_ss, p.o_sh,
                            p.S, H, p.group, p.causal, p.window, p.scale};
  switch (hd) {
    case 32: return flash_f32::launch<32>(f, B, stream);
    case 64: return flash_f32::launch<64>(f, B, stream);
    case 128: return flash_f32::launch<128>(f, B, stream);
    case 256: return flash_f32::launch<256>(f, B, stream);
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
// q, k, v 16-byte aligned and their strides multiples of 16 bytes (TMA
// and cp.async read them 16 bytes at a time). Returns the cudaError_t of the launch (0 =
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
