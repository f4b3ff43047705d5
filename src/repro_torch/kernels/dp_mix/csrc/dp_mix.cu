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
// The noise is the reference's counter hash (noise.cuh), bitwise the plain
// version's, never the TPU's own PRNG, with counters 2 * (r * counter_width
// + col0 + j) and that plus 1. Both routes below compute an element as
//
//   v   = x + (eta * listen) * (m_scale sigma_m Gm - self nf - x)
//   out = v + (eta * listen) * (W @ z)
//
// the same sum as the reference's _round_math in another order (within
// its float32 tolerance; the noise fields alone come out bitwise).
//
// What bounds it on an H100: instructions. At the paper's shape (N = 10,
// d = 855,050, float32) it moves 102.6 MB, 31 us at 3.35 TB/s, but draws
// 17.1 M normals, each the reference's XLA CPU sequence (C1): an integer
// hash and some fifty instructions on the branches its t takes, so the
// normals set the floor. The design issues as few instructions as it can
// and keeps the loads under them:
//
// * Column route (while 8 warps' worth of its blocks fit an SM's shared
//   memory: N up to about 50). A thread owns kCols neighbouring columns,
//   read 8 bytes at a time (bfloat16: 4); a block of 128 threads walks the
//   N rows kRows at a time, each batch's loads issued together before its
//   normals (which do not need them), converted to float32 only where
//   used. A batch's normals are drawn together, a step over all of
//   them before the next, so their chains interleave: both log1p branches
//   and XLA's select (a warp's lanes take both), the erfinv tail only in a
//   warp with a tail lane, the division without the compiler's slow path.
//   z and v wait in shared memory (only the thread's own columns, so no
//   barrier) until the thread forms its columns' outputs 4 kQuads
//   receivers at a time, with W transposed in shared memory so one 16-byte
//   load serves four. Gossip (no normals) has its own instantiation: it
//   stages x alone (v follows from it) and loads kGossipRows rows a batch:
//   with no normals to hide them under, its time is the loads' latency.
// * Large-N route (beyond): two kernels. dp_mix_prep writes z and nf, one
//   normal an element, to a float32 workspace [2, N, d] that the wrapper
//   allocates; dp_mix_tiled forms W @ z over 64 x 64 tiles of receivers
//   and columns from 16-sender slabs in shared memory (FMAs on the CUDA
//   cores) and draws Gm in its epilogue, once an element. A tensor-core
//   mix for large N is later work.
//
// A stack of R rounds (the fleet's replicates, reps = R) is one launch on
// either route: the replicate is a grid axis (the column route's y, the
// large-N kernels' z), and each block first moves its Args to its
// replicate's operands (replicate(): p, g and out r n d elements on, W r
// n n, the vectors r n, scal 2 r, seed r, the workspace 2 r n d; 64-bit
// offsets). col0 is shared and the counters start at 0 in every
// replicate, as each replicate of the reference's vmap has its own seed
// and counter space. The arithmetic of an element is unchanged, so
// replicate r is bitwise the launch of replicate r's operands alone.
//
// The sparse round (dp_mix_sparse_launch) mixes through a padded neighbor
// list instead of W: idx, w [n, k], self_w [n] (net/sparse.py's SparseW),
//
//   mix_i = self_w_i z_i + sum_s w_is z[idx_is]            (slot order)
//
// the reference's dp_mix_sparse_jnp (XLA gathers, no Pallas body), which
// is replaced here. Two launches: dp_mix_prep, as above, writes z and nf
// to the workspace [2, n, d]; dp_mix_gather gives each block one receiver
// row and a 1024-column slab, reads its k slots once into shared memory,
// gathers the k rows of z, draws Gm in its epilogue and writes out = v +
// (eta * listen) * mix. Receivers are the grid's fastest axis, so the
// blocks in flight share one column slab of z (n x 1024 floats, 8 MB at
// n = 2048) and the gathered rows come from L2. Element offsets are 64-bit:
// the workspace's second half starts past 2^31 elements at n = 2048.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/dtypes.cuh"
#include "../../csrc/noise.cuh"

namespace {

using repro_dtypes::load_f;
using repro_dtypes::store_f;

constexpr int kThreads = 128;                  // column route: threads a block
constexpr int kCols = 2;                       // columns a thread
constexpr int kTileCols = kThreads * kCols;    // columns a block
constexpr int kRows = 2;                       // rows a batch of normals
constexpr int kGossipRows = 8;                 // rows a batch, gossip
constexpr int kQuads = 3;                      // receiver quads a pass of the mix
constexpr int kMinWarps = 8;                   // column route: warps an SM at least

constexpr int kTile = 64;                      // large-N route: receivers and columns a tile
constexpr int kSlab = 16;                      // senders a slab
constexpr int kTiledThreads = 256;             // each 4 x 4 outputs
constexpr int kPrepThreads = 256;
constexpr int kGatherThreads = 256;            // sparse round: threads a block
constexpr int kGatherCols = 4;                 // columns a thread, kGatherThreads apart
constexpr int kGatherTile = kGatherThreads * kGatherCols;   // columns a block

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

struct Args {
  const void* p;
  const void* g;
  void* out;
  const float* W;
  const float* amp;
  const float* selfs;
  const float* mscale;
  const float* listen;
  const float* scal;    // [c, sigma_m]
  const int32_t* seed;
  const int32_t* col0;
  float* ws;            // large-N route: [2, n, d], z then nf
  int n, d;
  uint32_t counter_width;
  float gamma, eta;
  int noisy;
};

// A receiver's constants: amp / c, self, m_scale * sigma_m, eta * listen.
__device__ __forceinline__ float4 row_const(const Args& a, int i) {
  return make_float4(__fdiv_rn(a.amp[i], a.scal[0]), a.selfs[i],
                     __fmul_rn(a.mscale[i], a.scal[1]), __fmul_rn(a.eta, a.listen[i]));
}

__device__ __forceinline__ float local_step(float p, float g, float gamma) {
  return __fsub_rn(p, __fmul_rn(gamma, g));
}

// v = x + le (ms Gm - self nf - x): all of out but le * (W @ z).
__device__ __forceinline__ float partial(float x, float nf, float gm, float4 rc) {
  return fmaf(rc.w, __fsub_rn(__fsub_rn(__fmul_rn(rc.z, gm), __fmul_rn(rc.y, nf)), x), x);
}

__device__ __forceinline__ uint32_t counter(uint32_t row, uint32_t cw, uint32_t gcol) {
  return row * cw + gcol;
}

// Replicate r's operands of a stack of rounds (see the header).
template <typename T>
__device__ __forceinline__ Args replicate(const Args& a, unsigned r) {
  if (r == 0) return a;
  Args b = a;
  const size_t n = a.n, nd = n * a.d;
  b.p = static_cast<const T*>(a.p) + r * nd;
  b.g = static_cast<const T*>(a.g) + r * nd;
  b.out = static_cast<T*>(a.out) + r * nd;
  b.W = a.W + r * n * n;
  b.amp = a.amp + r * n;
  b.selfs = a.selfs + r * n;
  b.mscale = a.mscale + r * n;
  b.listen = a.listen + r * n;
  b.scal = a.scal + 2 * (size_t)r;
  b.seed = a.seed + r;
  if (a.ws != nullptr) b.ws = a.ws + 2 * r * nd;
  return b;
}

// ---- column route -------------------------------------------------------

template <typename T, int C>
struct alignas(sizeof(T) * C) Pack {
  T v[C];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float v) { d = __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ void store_cols(T* __restrict__ row, int col, int d, bool vec,
                                           const float (&v)[kCols]) {
  if (vec && col + kCols <= d) {
    Pack<T, kCols> pk;
#pragma unroll
    for (int c = 0; c < kCols; ++c) from_f(pk.v[c], v[c]);
    *reinterpret_cast<Pack<T, kCols>*>(row + col) = pk;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (col + c < d) store_f(row, col + c, v[c]);
  }
}

// kCols columns from col of a row, one at a time (the ragged edge, or a
// row the pack cannot be read from whole); columns past d as 0.
template <typename T>
__device__ __forceinline__ Pack<T, kCols> load_edge(const T* __restrict__ row, int col, int d) {
  Pack<T, kCols> pk;
#pragma unroll
  for (int c = 0; c < kCols; ++c) from_f(pk.v[c], col + c < d ? load_f(row, col + c) : 0.0f);
  return pk;
}

// Floats a row and column the column route stages: z and v, or (gossip)
// x alone.
__host__ __device__ constexpr int staged(bool noisy) { return noisy ? 2 : 1; }

// Shared memory of the column route at n receivers: the receivers'
// constants, W transposed (rows padded to 4 with zeros), the staged
// floats of the block's columns. The route is chosen by the noisy size,
// the larger.
__host__ __device__ inline size_t columns_smem_bytes(int n, bool noisy = true) {
  const size_t np = round_up(n, 4);
  return sizeof(float4) * n +
         sizeof(float) * (n * np + staged(noisy) * (size_t)n * kTileCols);
}

// The R rows from k0 of this thread's columns: their loads, x, and
// (Noisy) the two noise fields, then z and v into shared memory; gossip
// stages x alone, in z.
template <int R, bool Noisy, typename T>
__device__ __forceinline__ void rows_batch(const Args& a, int k0, int col, uint32_t gcol,
                                           uint32_t seed, bool vec, const T* __restrict__ p,
                                           const T* __restrict__ g, const float4* sRow, float* z,
                                           float* v) {
  using namespace repro_noise;
  constexpr int M = 2 * R * kCols;   // [row][column][Gn, Gm]
  // The batch's rows as they are stored, converted only where used: a
  // conversion next to its load would wait for it before the next load
  // issues (bfloat16), and the batch's loads would run one at a time.
  Pack<T, kCols> pr[R], gr[R];
  if (vec && col + kCols <= a.d) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pr[r] = *reinterpret_cast<const Pack<T, kCols>*>(p + (size_t)(k0 + r) * a.d + col);
      gr[r] = *reinterpret_cast<const Pack<T, kCols>*>(g + (size_t)(k0 + r) * a.d + col);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pr[r] = load_edge(p + (size_t)(k0 + r) * a.d, col, a.d);
      gr[r] = load_edge(g + (size_t)(k0 + r) * a.d, col, a.d);
    }
  }
  float nrm[M];
  if (Noisy) {
    float t[M], w[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const uint32_t idx = counter(k0 + j / (2 * kCols), a.counter_width, gcol + (j / 2) % kCols);
      t[j] = lattice_t(hash_bits(2u * idx + (j & 1), seed));
    }
#pragma unroll
    for (int j = 0; j < M; ++j) w[j] = lattice_w(t[j]);
#pragma unroll
    for (int j = 0; j < M; ++j) nrm[j] = erfinv_central(w[j]);
#pragma unroll
    for (int j = 0; j < M; ++j) nrm[j] = normal_from_p(erfinv_p(nrm[j], w[j]), t[j]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    Pack<float, kCols> zk, vk;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float x = local_step(to_f(pr[r].v[c]), to_f(gr[r].v[c]), a.gamma);
      if (Noisy) {
        const float4 rc = sRow[k0 + r];
        const float nf = __fmul_rn(rc.x, nrm[(r * kCols + c) * 2]);
        zk.v[c] = __fadd_rn(x, nf);
        vk.v[c] = partial(x, nf, nrm[(r * kCols + c) * 2 + 1], rc);
      } else {
        zk.v[c] = x;
      }
    }
    *reinterpret_cast<Pack<float, kCols>*>(z + (size_t)(k0 + r) * kTileCols) = zk;
    if (Noisy) *reinterpret_cast<Pack<float, kCols>*>(v + (size_t)(k0 + r) * kTileCols) = vk;
  }
}

template <typename T, bool Noisy>
__global__ void __launch_bounds__(kThreads)
dp_mix_columns(const Args args, const bool vec) {
  const Args a = replicate<T>(args, blockIdx.y);
  extern __shared__ float4 smem[];
  const int n = a.n, d = a.d, np = round_up(n, 4), tid = threadIdx.x;
  float4* sRow = smem;                                        // [n]
  float* sWt = reinterpret_cast<float*>(sRow + n);            // [n senders][np receivers]
  float* z = sWt + (size_t)n * np + tid * kCols;              // [n][kTileCols], z (gossip: x)
  float* v = z + (size_t)n * kTileCols;                       // [n][kTileCols], v (noisy)
  for (int i = tid; i < n * np; i += kThreads) {
    const int k = i / np, r = i - k * np;
    sWt[i] = r < n ? a.W[r * n + k] : 0.0f;
  }
  for (int i = tid; i < n; i += kThreads) sRow[i] = row_const(a, i);
  __syncthreads();

  // pass 1: z and v of every row of this thread's columns. Lanes past d
  // run along (a warp draws its normals together) but load zeros and
  // store nothing.
  const T* __restrict__ p = static_cast<const T*>(a.p);
  const T* __restrict__ g = static_cast<const T*>(a.g);
  const int col = (blockIdx.x * kThreads + tid) * kCols;
  const uint32_t seed = (uint32_t)a.seed[0], gcol = (uint32_t)a.col0[0] + (uint32_t)col;
  constexpr int R = Noisy ? kRows : kGossipRows;
  int k0 = 0;
  for (; k0 + R <= n; k0 += R) rows_batch<R, Noisy>(a, k0, col, gcol, seed, vec, p, g, sRow, z, v);
  for (; k0 < n; ++k0) rows_batch<1, Noisy>(a, k0, col, gcol, seed, vec, p, g, sRow, z, v);

  // pass 2: 4 kQuads receivers at a time from the staged columns, one
  // 16-byte load of W a quad
  T* __restrict__ out = static_cast<T*>(a.out);
  for (int i0 = 0; i0 < n; i0 += 4 * kQuads) {
    float acc[kQuads][4][kCols] = {};
    for (int k = 0; k < n; ++k) {
      const Pack<float, kCols> zk = *reinterpret_cast<const Pack<float, kCols>*>(z + (size_t)k * kTileCols);
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        if (i0 + 4 * q >= n) break;
        const float4 w = *reinterpret_cast<const float4*>(sWt + (size_t)k * np + i0 + 4 * q);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc[q][0][c] = fmaf(w.x, zk.v[c], acc[q][0][c]);
          acc[q][1][c] = fmaf(w.y, zk.v[c], acc[q][1][c]);
          acc[q][2][c] = fmaf(w.z, zk.v[c], acc[q][2][c]);
          acc[q][3][c] = fmaf(w.w, zk.v[c], acc[q][3][c]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + 4 * q + r;
        if (i >= n) break;
        const float le = sRow[i].w;
        const Pack<float, kCols> vi =
            *reinterpret_cast<const Pack<float, kCols>*>((Noisy ? v : z) + (size_t)i * kTileCols);
        float o[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c)   // gossip: v = x + le (0 - x), from x
          o[c] = fmaf(le, acc[q][r][c], Noisy ? vi.v[c] : partial(vi.v[c], 0.0f, 0.0f, sRow[i]));
        store_cols(out + (size_t)i * d, col, d, vec, o);
      }
  }
}

// ---- large-N route --------------------------------------------------------

// z (x when gossip) and nf of every element into the workspace.
template <typename T>
__global__ void __launch_bounds__(kPrepThreads) dp_mix_prep(const Args args) {
  const Args a = replicate<T>(args, blockIdx.z);
  const int k = blockIdx.y, j = blockIdx.x * kPrepThreads + threadIdx.x;
  const size_t off = (size_t)k * a.d + min(j, a.d - 1);   // lanes past d draw along
  const float x = local_step(load_f(static_cast<const T*>(a.p), off),
                             load_f(static_cast<const T*>(a.g), off), a.gamma);
  if (!a.noisy) {
    if (j < a.d) a.ws[off] = x;
    return;
  }
  const uint32_t idx = counter(k, a.counter_width, (uint32_t)a.col0[0] + (uint32_t)j);
  const float nf = __fmul_rn(__fdiv_rn(a.amp[k], a.scal[0]),
                             repro_noise::normal_from_bits(
                                 repro_noise::hash_bits(2u * idx, (uint32_t)a.seed[0])));
  if (j < a.d) {
    a.ws[off] = __fadd_rn(x, nf);
    a.ws[(size_t)a.n * a.d + off] = nf;
  }
}

// out over a kTile x kTile tile of (receivers, columns): W @ z from
// kSlab-sender slabs of W (transposed) and z in shared memory, each
// thread 4 receivers x 4 columns; then v and the store.
template <typename T>
__global__ void __launch_bounds__(kTiledThreads) dp_mix_tiled(const Args args) {
  const Args a = replicate<T>(args, blockIdx.z);
  constexpr int ld = kTile + 4;   // row stride: float4 reads, few bank conflicts on the stores
  __shared__ __align__(16) float sW[kSlab][ld];
  __shared__ __align__(16) float sZ[kSlab][ld];
  const int n = a.n, d = a.d, tid = threadIdx.x;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int tx = tid % 16, ty = tid / 16;   // columns j0 + 4 tx .., receivers i0 + 4 ty ..
  float acc[4][4] = {};
  for (int k0 = 0; k0 < n; k0 += kSlab) {
#pragma unroll
    for (int q = 0; q < kTile * kSlab / kTiledThreads; ++q) {
      const int e = q * kTiledThreads + tid;
      const int kk = e % kSlab, m = e / kSlab;          // W row-major: senders contiguous
      const int i = i0 + m, k = k0 + kk;
      sW[kk][m] = i < n && k < n ? a.W[(size_t)i * n + k] : 0.0f;
      const int zk = e / kTile, jj = e % kTile;         // z rows: columns contiguous
      const int kz = k0 + zk, j = j0 + jj;
      sZ[zk][jj] = kz < n && j < d ? a.ws[(size_t)kz * d + j] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(&sW[kk][4 * ty]);
      const float4 zv = *reinterpret_cast<const float4*>(&sZ[kk][4 * tx]);
      const float wr[4] = {w.x, w.y, w.z, w.w}, zc[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(wr[r], zc[c], acc[r][c]);
    }
    __syncthreads();
  }
  // epilogue: every lane draws its 16 Gm (those past n or d too, not kept)
  const T* __restrict__ p = static_cast<const T*>(a.p);
  const T* __restrict__ g = static_cast<const T*>(a.g);
  T* __restrict__ out = static_cast<T*>(a.out);
  const uint32_t seed = (uint32_t)a.seed[0], gcol0 = (uint32_t)a.col0[0];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r, ic = min(i, n - 1);
    const float4 rc = row_const(a, ic);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + 4 * tx + c;
      const size_t off = (size_t)ic * d + min(j, d - 1);
      const float x = local_step(load_f(p, off), load_f(g, off), a.gamma);
      float vv;
      if (a.noisy) {
        const uint32_t idx = counter(i, a.counter_width, gcol0 + (uint32_t)j);
        const float gm = repro_noise::normal_from_bits(repro_noise::hash_bits(2u * idx + 1u, seed));
        vv = partial(x, a.ws[(size_t)n * d + off], gm, rc);
      } else {
        vv = partial(x, 0.0f, 0.0f, rc);
      }
      if (i < n && j < d) store_f(out, off, fmaf(rc.w, acc[r][c], vv));
    }
  }
}

// ---- the sparse round -------------------------------------------------------

struct Neighbors {
  const int32_t* idx;   // [n, k], each in [0, n) (clamped, as XLA's gather clamps)
  const float* w;       // [n, k]
  const float* self_w;  // [n]
  int k;
};

// out of one receiver (blockIdx.x) over kGatherTile columns: the mix from
// the workspace's z, v from p, g, nf and Gm, out = v + (eta listen) mix.
template <typename T>
__global__ void __launch_bounds__(kGatherThreads) dp_mix_gather(const Args a, const Neighbors nb) {
  extern __shared__ float slots[];
  float* sW = slots;                                         // [k]
  int* sIdx = reinterpret_cast<int*>(slots + nb.k);          // [k]
  const int n = a.n, d = a.d, i = blockIdx.x;
  for (int s = threadIdx.x; s < nb.k; s += kGatherThreads) {
    sW[s] = nb.w[(size_t)i * nb.k + s];
    sIdx[s] = min(max(nb.idx[(size_t)i * nb.k + s], 0), n - 1);
  }
  __syncthreads();
  const float* __restrict__ z = a.ws;
  const float* __restrict__ nf = a.ws + (size_t)n * d;
  const int j0 = blockIdx.y * kGatherTile + threadIdx.x;
  int col[kGatherCols];
  float acc[kGatherCols];
  const float self_w = nb.self_w[i];
#pragma unroll
  for (int c = 0; c < kGatherCols; ++c) {   // lanes past d read column d - 1, store nothing
    col[c] = min(j0 + c * kGatherThreads, d - 1);
    acc[c] = __fmul_rn(self_w, z[(size_t)i * d + col[c]]);
  }
  for (int s = 0; s < nb.k; ++s) {
    const float ws = sW[s];
    const float* __restrict__ zr = z + (size_t)sIdx[s] * d;
#pragma unroll
    for (int c = 0; c < kGatherCols; ++c) acc[c] = fmaf(ws, zr[col[c]], acc[c]);
  }
  const T* __restrict__ p = static_cast<const T*>(a.p);
  const T* __restrict__ g = static_cast<const T*>(a.g);
  T* __restrict__ out = static_cast<T*>(a.out);
  const float4 rc = row_const(a, i);
  const uint32_t seed = (uint32_t)a.seed[0], gcol0 = (uint32_t)a.col0[0];
#pragma unroll
  for (int c = 0; c < kGatherCols; ++c) {
    const int j = j0 + c * kGatherThreads;
    const size_t off = (size_t)i * d + col[c];
    const float x = local_step(load_f(p, off), load_f(g, off), a.gamma);
    float v;
    if (a.noisy) {
      const uint32_t idx = counter(i, a.counter_width, gcol0 + (uint32_t)j);
      const float gm = repro_noise::normal_from_bits(repro_noise::hash_bits(2u * idx + 1u, seed));
      v = partial(x, nf[off], gm, rc);
    } else {
      v = partial(x, 0.0f, 0.0f, rc);
    }
    if (j < d) store_f(out, off, fmaf(rc.w, acc[c], v));
  }
}

template <typename T>
int launch_sparse(const Args& a, const Neighbors& nb, cudaStream_t stream) {
  if (a.ws == nullptr || a.n > 65535 || nb.k < 0) return (int)cudaErrorInvalidValue;
  dp_mix_prep<T><<<dim3((a.d + kPrepThreads - 1) / kPrepThreads, a.n), kPrepThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = (sizeof(float) + sizeof(int)) * (size_t)nb.k;
  static size_t opted_in = 48 * 1024;   // shared memory granted without opt-in
  if (bytes > opted_in) {
    err = cudaFuncSetAttribute(dp_mix_gather<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = bytes;
  }
  dp_mix_gather<T><<<dim3(a.n, (a.d + kGatherTile - 1) / kGatherTile), kGatherThreads, bytes,
                     stream>>>(a, nb);
  return (int)cudaGetLastError();
}

// ---- routes and launch -------------------------------------------------------

// The column route while kMinWarps warps of its blocks fit an SM's shared
// memory, read from the current device.
bool columns_route(int n) {
  int dev = 0, per_sm = 0, per_block = 0, reserved = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev) != cudaSuccess)
    return false;
  const size_t bytes = columns_smem_bytes(n);
  return bytes <= (size_t)per_block &&
         per_sm / (bytes + reserved) * (kThreads / 32) >= (size_t)kMinWarps;
}

template <typename T, bool Noisy>
int launch_columns(const Args& a, int reps, cudaStream_t stream) {
  const size_t bytes = columns_smem_bytes(a.n, Noisy);
  static size_t opted_in = 48 * 1024;   // shared memory granted without opt-in
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        dp_mix_columns<T, Noisy>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = bytes;
  }
  // d even: every replicate's rows start on a pack too
  const size_t pack = sizeof(T) * kCols;
  const bool vec = a.d % kCols == 0 && (uintptr_t)a.p % pack == 0 &&
                   (uintptr_t)a.g % pack == 0 && (uintptr_t)a.out % pack == 0;
  const int blocks = (a.d + kTileCols - 1) / kTileCols;
  dp_mix_columns<T, Noisy><<<dim3(blocks, reps), kThreads, bytes, stream>>>(a, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int reps, cudaStream_t stream) {
  if (reps < 1 || reps > 65535) return (int)cudaErrorInvalidValue;
  if (columns_route(a.n))
    return a.noisy ? launch_columns<T, true>(a, reps, stream)
                   : launch_columns<T, false>(a, reps, stream);
  if (a.ws == nullptr || a.n > 65535) return (int)cudaErrorInvalidValue;
  dp_mix_prep<T><<<dim3((a.d + kPrepThreads - 1) / kPrepThreads, a.n, reps), kPrepThreads, 0,
                   stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dp_mix_tiled<T><<<dim3((a.d + kTile - 1) / kTile, (a.n + kTile - 1) / kTile, reps),
                    kTiledThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the workspace the launch needs at [n, d]: 0 on the column
// route, 2 n d (z and nf, float32) on the large-N route; a stack of reps
// rounds needs reps times that.
size_t dp_mix_workspace_floats(int n, int d) {
  return n < 1 || d < 1 || columns_route(n) ? 0 : 2 * (size_t)n * d;
}

// dtype: 0 = float32, 1 = bfloat16 (p, g, out). Every other array is
// float32 on the device except seed and col0, int32; ws is the workspace
// of dp_mix_workspace_floats (null when that is 0). reps rounds stacked:
// p, g, out [reps, n, d], W [reps, n, n], amp, selfs, mscale, listen
// [reps, n], scal [reps, 2], seed [reps], col0 [1] (shared). Returns the
// cudaError_t of the launch (0 = launched).
int dp_mix_launch(int dtype, const void* p, const void* g, void* out, const void* W,
                  const void* amp, const void* selfs, const void* mscale, const void* listen,
                  const void* scal, const void* seed, const void* col0, void* ws, int reps,
                  int n, int d, unsigned int counter_width, float gamma, float eta, int noisy,
                  void* stream) {
  if (n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const Args a{p, g, out, static_cast<const float*>(W), static_cast<const float*>(amp),
               static_cast<const float*>(selfs), static_cast<const float*>(mscale),
               static_cast<const float*>(listen), static_cast<const float*>(scal),
               static_cast<const int32_t*>(seed), static_cast<const int32_t*>(col0),
               static_cast<float*>(ws), n, d, counter_width, gamma, eta, noisy};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, reps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, reps, s);
  return (int)cudaErrorInvalidValue;
}

// The sparse round: idx int32 [n, k], w float32 [n, k], self_w float32 [n]
// take W's place; ws is a float32 workspace of 2 n d floats (z, then nf).
// The rest as dp_mix_launch. Returns the cudaError_t of the launches.
int dp_mix_sparse_launch(int dtype, const void* p, const void* g, void* out, const void* idx,
                         const void* w, const void* self_w, const void* amp, const void* selfs,
                         const void* mscale, const void* listen, const void* scal,
                         const void* seed, const void* col0, void* ws, int n, int d, int k,
                         unsigned int counter_width, float gamma, float eta, int noisy,
                         void* stream) {
  if (n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const Args a{p, g, out, nullptr, static_cast<const float*>(amp),
               static_cast<const float*>(selfs), static_cast<const float*>(mscale),
               static_cast<const float*>(listen), static_cast<const float*>(scal),
               static_cast<const int32_t*>(seed), static_cast<const int32_t*>(col0),
               static_cast<float*>(ws), n, d, counter_width, gamma, eta, noisy};
  const Neighbors nb{static_cast<const int32_t*>(idx), static_cast<const float*>(w),
                     static_cast<const float*>(self_w), k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_sparse<float>(a, nb, s);
  if (dtype == 1) return launch_sparse<__nv_bfloat16>(a, nb, s);
  return (int)cudaErrorInvalidValue;
}

const char* dp_mix_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
