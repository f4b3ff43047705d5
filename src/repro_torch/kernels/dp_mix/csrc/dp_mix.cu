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
//   allocates; dp_mix_tiled forms W @ z on the tensor cores and draws Gm
//   in its epilogue, once an element. At N = 2048 the mix is 2 N^2 d =
//   7.2 TFLOP, so this route is bound by its products, not by the
//   normals: on the CUDA cores (67 TFLOP/s) no mix goes under 107 ms.
//   The design answers three limits:
//   - the products: split TF32 (tf32x3.cuh's split, three TF32 products
//     a float32 one: z_lo W_hi + z_hi W_lo + z_hi W_hi, the small terms
//     first) on wgmma, run transposed, out^T = z^T W^T: a block of two
//     warpgroups owns 128 columns x 128 receivers, each warpgroup's 64
//     columns wgmma.m64n128k8's M, z^T from registers (cut into hi and lo
//     as it is loaded), W as B, K-major in shared memory, split into hi
//     and lo once a slab. With mma.sync.m16n8k8 every 16 x 8 x 8 product
//     is an instruction of its own beside the splits and loads that feed
//     it; wgmma issues one for 64 of them. The route's floor is its
//     products at the TF32 peak (3 x 7.2 TFLOP at 495 TFLOP/s, 43 ms).
//     The diagonal W_ii stays out of the products
//     and the epilogue adds it in float32, fmaf(W_ii, z_i, .): two TF32
//     pieces carry 22 of z's 24 bits, so a row of W that is e_i still
//     passes z bitwise;
//   - z's traffic: the tile index runs over the receivers fastest, so
//     the receiver tiles of one column slab run together and share its
//     z (n x 128 floats, 1 MB at n = 2048) through L2: z comes from HBM
//     about once, not once per receiver tile;
//   - the copies: 32-sender slabs of W and z by cp.async (16, 8 or 4
//     bytes a copy, as the rows' alignment allows) one slab ahead into a
//     ring of two, so the next slab's copies run under this slab's
//     products. The output tile is staged through shared memory so that
//     the epilogue reads and writes whole rows, four rows a pass with
//     every load of the pass issued before its normals.
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
// to the workspace [2, n, d]; dp_mix_gather forms out = v + (eta listen)
// mix, drawing Gm. What bounds it on an H100 at n = 2048, d = 855,050, k
// = 12 (float32): bytes. The prep reads p and g and writes z and nf (28
// GB, 8.4 ms at 3.35 TB/s); the gather reads p, g, nf and each receiver's
// z and writes out (35 GB, 10.4 ms), and reads each neighbor's row of z
// besides. Its normals (1.75 G each kernel) are ~3.4 ms of issue. Probed
// on an H100 80GB HBM3 at 700 W with the earlier design (a block a
// receiver and 1024 columns, every slot's row read on its own: 23.4 ms),
// the gathered rows
// were not what held it back: the same list with its labels in Morton
// order took 22.6 ms, and with every slot pointing at its own receiver
// 21.0; the rest was latency, short blocks and instructions. The design:
//
// * dp_mix_prep: a lane 4 columns of its warp's 128 (runs of 4, 2 or 1
//   as the rows' alignment allows, each load and store of a warp
//   contiguous) of 8 rows, 2 rows at a time, the batch's 8 normals drawn
//   together, their chains interleaved. It runs at its bytes: without the
//   normals it takes as long (probe on an H100 80GB HBM3, 700 W).
// * dp_mix_gather: a block a group of kGroup (16) receivers, taken in the
//   order the wrapper gives (ops.locality_order: the list's Morton key, so
//   a group's receivers are neighbours and share rows: 2.9 distinct rows a
//   receiver against 10.4 in index order at n = 2048), over 32 column
//   slabs of 128. The block forms the group's union of rows once (a hash
//   set in shared memory) and each slot's place in it; then slab by slab
//   warp 0 issues one bulk copy (cp.async.bulk, on an mbarrier) a union
//   row into a ring of two, the next slab's under this one's arithmetic,
//   so a row of z leaves L2 once a group and not once a slot. A warp forms
//   one receiver's slab at a time, a lane 4 columns: one shared-memory
//   load a slot, and the next receiver's loads of p, g and nf issued
//   before this one's mix and normals. Three blocks (24 warps) an SM. A
//   group whose union is past the staged capacity (fixed at launch from k
//   and the shared memory) reads those rows from global memory in their
//   place in slot order, so any list is right, only slower. Groups are
//   the grid's fastest axis: the groups of one column range run together
//   and share z's slab through L2. A list without an order runs in index
//   order through the same kernel: its groups share almost no rows, so
//   most of a group's union reads from global memory (right, only slower;
//   every list the port builds carries a key).
//
// Each element's arithmetic is as before, fmaf(w_s, z[idx_s], acc) from
// self_w z_i in slot order, v from p, g, nf and Gm, so the output is
// bitwise the same whatever the order or the group. Element offsets are
// 64-bit: the workspace's second half starts past 2^31 elements at n =
// 2048.
//
// A stack of reps sparse rounds (the fleet's) is the same two launches
// with the replicate as their grid's z: each block moves its Args with
// replicate() and its neighbor list with replicate(Neighbors) (idx and w
// r n k on, self_w and order r n, z_src to replicate r's z in the
// workspace, 2 r n d on), so replicate r is bitwise the launch of its
// operands alone.
//
// Worker-axis shards (repro_torch/shard/worker.py, the reference's
// shard/worker.py::worker_window_round): a shard holds rows [row0, row0 +
// n) of an n_src-row population. dp_mix_prep_launch draws its rows' noise
// with global counters 2 * ((row0 + r) * counter_width + col0 + j), the
// reference's _normal_pair_hash(..., row0); the caller all-gathers the
// shards' z into one [n_src, d] float32 tensor; dp_mix_gather_launch then
// forms receivers [row0, row0 + n), reading their neighbor rows by global
// index from that tensor and their own z and nf from the local workspace
// (a group stages a receiver's own row from the workspace apart from
// z_src's copy of it, which its padded slots read). Each element's
// arithmetic is the unsharded round's, so
// stitched shards are bitwise the whole round; row0 = 0 with z_src = the
// workspace is the whole round (dp_mix_sparse_launch). Same bound and
// design as the sparse round above, its groups in its own rows' order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/dtypes.cuh"
#include "../../csrc/noise.cuh"
#include "../../csrc/tf32x3.cuh"
#include "../../csrc/wgmma.cuh"

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

constexpr int kTileM = 128;                    // large-N route: receivers a tile (wgmma's N)
constexpr int kTileN = 128;                    // columns a tile: two warpgroups of 64 (wgmma's M)
constexpr int kSlab = 32;                      // senders a slab: four k8 steps
constexpr int kTiledThreads = 256;             // two warpgroups
constexpr int kLdZ = kTileN + 8;               // z slab's row stride: an A fragment's loads on distinct banks
constexpr int kLdW = kSlab + 4;                // W slab's, as copied
constexpr int kLdOut = kTileN + 4;             // the staged output's: the fragment's stores on distinct banks
constexpr int kZFloats = kSlab * kLdZ;         // a z slab, as copied; the ring holds 2
constexpr int kRawFloats = kTileM * kLdW;      // a W slab, as copied; the ring holds 2
constexpr int kWFloats = kTileM * kSlab;       // W_hi or W_lo of a slab, split
constexpr int kRingFloats = 2 * kZFloats + 2 * kRawFloats + 2 * kWFloats;
constexpr int kEpiRows = 4;                    // rows a warp's epilogue pass
// the ring, then the tile's row constants (row_const and W_ii): 104.5 KiB, 2 blocks an SM
constexpr size_t kTiledSmem = sizeof(float) * kRingFloats + (sizeof(float4) + sizeof(float)) * kTileM;
static_assert(kTileM * kLdOut <= kRingFloats, "the output tile reuses the ring");
constexpr int kPrepThreads = 256;              // large-N and sparse prep: threads a block
constexpr int kPrepRows = 8;                   // rows a block
constexpr int kPrepBatch = 2;                  // rows whose loads and normals go together
constexpr int kGatherThreads = 256;            // sparse gather: threads a block
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kGroup = 16;                     // receivers a block, in the order given
constexpr int kGatherBlocks = 3;               // gather blocks an SM
constexpr int kSlabCols = 128;                 // columns a slab
constexpr int kRowFloats = kSlabCols + 4;      // a staged row's stride: the slab from its 16-byte start
constexpr int kLaneCols = kSlabCols / 32;      // columns a lane: a warp a row
constexpr int kSlabsPerBlock = 32;             // column slabs a block walks

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
  uint32_t row0;        // global row of local row 0 (worker-axis shards)
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
  if (a.W != nullptr) b.W = a.W + r * n * n;   // the sparse round has no W
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

// ---- a lane's columns (the large-N and sparse prep, the sparse gather) ----

// A lane's kLaneCols columns of a warp's 32 kLaneCols: kLaneCols / V runs
// of V neighbouring columns, 32 V apart, so that each load of a warp reads
// 32 V contiguous elements. The lane's column c (0 .. kLaneCols - 1) of
// the warp's from c0:
template <int V>
__device__ __forceinline__ int lane_col(int lane, int c) {
  return c / V * 32 * V + lane * V + c % V;
}

// A lane's columns of a row from column c0, V at a time (V divides d and
// the row starts on V elements, so a run is whole or past d; a run past d
// reads the last, and its lane stores nothing).
template <int V, typename T>
__device__ __forceinline__ Pack<T, kLaneCols> load_lane(const T* __restrict__ row, int c0, int d) {
  const int lane = threadIdx.x % 32;
  Pack<T, kLaneCols> pk;
#pragma unroll
  for (int h = 0; h < kLaneCols; h += V) {
    const int j = min(c0 + lane_col<V>(lane, h), d - V);
    const Pack<T, V> x = *reinterpret_cast<const Pack<T, V>*>(row + j);
#pragma unroll
    for (int c = 0; c < V; ++c) pk.v[h + c] = x.v[c];
  }
  return pk;
}

template <int V, typename T>
__device__ __forceinline__ void store_lane(T* __restrict__ row, int c0, int d,
                                           const float (&o)[kLaneCols]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < kLaneCols; h += V) {
    const int j = c0 + lane_col<V>(lane, h);
    if (j >= d) continue;
    Pack<T, V> x;
#pragma unroll
    for (int c = 0; c < V; ++c) from_f(x.v[c], o[h + c]);
    *reinterpret_cast<Pack<T, V>*>(row + j) = x;
  }
}

// ---- large-N route --------------------------------------------------------

// z (x when gossip) and nf into the workspace: a lane kLaneCols columns
// of its warp's 32 kLaneCols (lane_col: runs of V, V = 4, 2 or 1 as the
// rows' alignment allows, so each load and store of a warp is contiguous)
// of kPrepRows rows, kPrepBatch rows at a time, the batch's loads issued
// together and its normals drawn together (their chains interleaved, as
// rows_batch does). Lanes past d and rows past n draw along (clamped) and
// store nothing.
template <typename T, int V>
__global__ void __launch_bounds__(kPrepThreads) dp_mix_prep(const Args args) {
  using namespace repro_noise;
  constexpr int E = kPrepBatch * kLaneCols;   // [row][column]
  const Args a = replicate<T>(args, blockIdx.z);
  const int n = a.n, d = a.d, lane = threadIdx.x % 32;
  const int c0 = (blockIdx.x * kPrepThreads + threadIdx.x - lane) * kLaneCols;   // the warp's
  const T* __restrict__ p = static_cast<const T*>(a.p);
  const T* __restrict__ g = static_cast<const T*>(a.g);
  float* __restrict__ zw = a.ws;
  float* __restrict__ nfw = a.ws + (size_t)n * d;
  const uint32_t seed = (uint32_t)a.seed[0], gcol = (uint32_t)a.col0[0] + (uint32_t)c0;
  const float c_align = a.scal[0];
  for (int k0 = blockIdx.y * kPrepRows; k0 < min(n, (int)(blockIdx.y + 1) * kPrepRows);
       k0 += kPrepBatch) {
    Pack<T, kLaneCols> pr[kPrepBatch], gr[kPrepBatch];
    size_t row[kPrepBatch];
#pragma unroll
    for (int r = 0; r < kPrepBatch; ++r) {
      row[r] = (size_t)min(k0 + r, n - 1) * d;
      pr[r] = load_lane<V>(p + row[r], c0, d);
      gr[r] = load_lane<V>(g + row[r], c0, d);
    }
    float nrm[E];
    if (a.noisy) {
      float t[E], w[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const uint32_t idx = counter(a.row0 + (uint32_t)min(k0 + e / kLaneCols, n - 1),
                                     a.counter_width,
                                     gcol + (uint32_t)lane_col<V>(lane, e % kLaneCols));
        t[e] = lattice_t(hash_bits(2u * idx, seed));
      }
#pragma unroll
      for (int e = 0; e < E; ++e) w[e] = lattice_w(t[e]);
#pragma unroll
      for (int e = 0; e < E; ++e) nrm[e] = erfinv_central(w[e]);
#pragma unroll
      for (int e = 0; e < E; ++e) nrm[e] = normal_from_p(erfinv_p(nrm[e], w[e]), t[e]);
    }
#pragma unroll
    for (int r = 0; r < kPrepBatch; ++r) {
      if (k0 + r >= n) break;
      const float amp_c = a.noisy ? __fdiv_rn(a.amp[k0 + r], c_align) : 0.0f;
      float zk[kLaneCols], nk[kLaneCols];
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) {
        const float x = local_step(to_f(pr[r].v[c]), to_f(gr[r].v[c]), a.gamma);
        nk[c] = a.noisy ? __fmul_rn(amp_c, nrm[r * kLaneCols + c]) : 0.0f;
        zk[c] = a.noisy ? __fadd_rn(x, nk[c]) : x;
      }
      store_lane<V>(zw + row[r], c0, d, zk);
      if (a.noisy) store_lane<V>(nfw + row[r], c0, d, nk);
    }
  }
}

// cp.async of V floats (4 V bytes) from global to shared memory; !valid
// reads nothing and fills them with zeros.
template <int V>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 4 * V : 0;
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                 "n"(4 * V), "r"(bytes) : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void copy_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// generic-proxy writes of shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

using repro_wgmma::fence_regs;
using repro_wgmma::wg_commit;
using repro_wgmma::wg_fence;
using repro_wgmma::wg_wait;

// D[64 x 128] += A[64 x 8] B[8 x 128] in TF32, A in registers (a warp's
// 16 rows as mma.m16n8k8's A fragment), B K-major in shared memory; D a
// warp's 16 rows, d[4j .. 4j + 3] = (g, 8j + 2t), (g, 8j + 2t + 1),
// (g + 8, 8j + 2t), (g + 8, 8j + 2t + 1)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The kSlab senders from k0 into a ring slot by cp.async, V floats a
// copy, zeros past n and d: W's rows i0 .. i0 + kTileM (senders
// contiguous) and z's rows k0 .. (columns j0 .. j0 + kTileN contiguous).
// A thread's copies of a slab lie a fixed stride apart: one pointer each,
// stepped.
template <int V>
__device__ __forceinline__ void load_slab(const Args& a, float* sW, float* sZ, int i0, int j0,
                                          int k0) {
  constexpr int wv = kSlab / V, zv = kTileN / V;                        // copies a row
  constexpr int wrows = kTiledThreads / wv, zrows = kTiledThreads / zv;  // rows a pass
  const int tid = threadIdx.x, mw = tid / wv, kw = tid % wv * V, kz = tid / zv, jz = tid % zv * V;
  const bool kok = k0 + kw < a.n, jok = j0 + jz < a.d;
  const float* w = a.W + (size_t)(i0 + mw) * a.n + k0 + kw;
#pragma unroll
  for (int q = 0; q < kTileM / wrows; ++q, w += (size_t)wrows * a.n) {
    const bool ok = kok && i0 + mw + q * wrows < a.n;
    copy_async<V>(sW + (mw + q * wrows) * kLdW + kw, ok ? w : a.W, ok);
  }
  const float* z = a.ws + (size_t)(k0 + kz) * a.d + j0 + jz;
#pragma unroll
  for (int q = 0; q < kSlab / zrows; ++q, z += (size_t)zrows * a.d) {
    const bool ok = jok && k0 + kz + q * zrows < a.n;
    copy_async<V>(sZ + (kz + q * zrows) * kLdZ + jz, ok ? z : a.ws, ok);
  }
}

// W (receiver i, sender k) of a slab as wgmma reads a K-major B without
// swizzle: 8 x 4 core matrices (8 receivers x 4 senders, 128 contiguous
// bytes), a receiver group's 8 along the senders 128 bytes apart (LBO),
// the groups 1024 apart (SBO)
__device__ __forceinline__ int w_at(int i, int k) {
  return (i >> 3) * 256 + (k >> 2) * 32 + (i & 7) * 4 + (k & 3);
}

// The copied W slab split into hi (sW) and lo (sW + kWFloats), W_ii as
// 0 (the diagonal stays out of the products): a thread 4 senders of 4
// receivers, each element split once.
__device__ __forceinline__ void split_w(const float* raw, float* sW, int i0, int k0) {
#pragma unroll
  for (int q = 0; q < kTileM * kSlab / 4 / kTiledThreads; ++q) {
    const int e = q * kTiledThreads + threadIdx.x, i = e % kTileM, k = e / kTileM * 4;
    const float4 v = *reinterpret_cast<const float4*>(raw + i * kLdW + k);
    const float x[4] = {v.x, v.y, v.z, v.w};
    float4 hi, lo;
    float* h = &hi.x;
    float* l = &lo.x;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t bh, bl;
      repro_tf32::split(i0 + i == k0 + k + c ? 0.0f : x[c], bh, bl);
      h[c] = __uint_as_float(bh);
      l[c] = __uint_as_float(bl);
    }
    *reinterpret_cast<float4*>(sW + w_at(i, k)) = hi;
    *reinterpret_cast<float4*>(sW + kWFloats + w_at(i, k)) = lo;
  }
}

// out over a kTileM x kTileN tile of (receivers, columns), the tile index
// blockIdx.x with the receivers fastest. The products run transposed,
// out^T = z^T W^T: each warpgroup's 64 columns are wgmma's M (z^T from
// registers, split as loaded), the 128 receivers its N (W split into hi
// and lo in shared memory), in split TF32, slab by slab, the next slab's
// copies in flight. Then the tile through shared memory, W_ii z_i, v and
// the store.
template <typename T, int V>
__global__ void __launch_bounds__(kTiledThreads, 2) dp_mix_tiled(const Args args) {
  const Args a = replicate<T>(args, blockIdx.z);
  extern __shared__ __align__(128) float ring[];
  const int n = a.n, d = a.d, tid = threadIdx.x, lane = tid % 32;
  const int mtiles = (n + kTileM - 1) / kTileM;
  const int i0 = (int)(blockIdx.x % mtiles) * kTileM, j0 = (int)(blockIdx.x / mtiles) * kTileN;
  const int slabs = (n + kSlab - 1) / kSlab, rows = min(kTileM, n - i0);
  float* sZ = ring;                                             // [2][kSlab][kLdZ]
  float* sRaw = ring + 2 * kZFloats;                            // [2][kTileM][kLdW]
  float* sW = sRaw + 2 * kRawFloats;                            // [hi, lo][kWFloats]
  float4* sRow = reinterpret_cast<float4*>(ring + kRingFloats);  // [kTileM]
  float* sDiag = reinterpret_cast<float*>(sRow + kTileM);        // [kTileM]

  // slab 0 on its way, and the tile's row constants (published by the
  // first barrier)
  load_slab<V>(a, sRaw, sZ, i0, j0, 0);
  copy_commit();
  if (tid < kTileM) {
    const int i = i0 + min(tid, rows - 1);
    sRow[tid] = row_const(a, i);
    sDiag[tid] = a.W[(size_t)i * n + i];
  }

  // the warp's A fragment: columns am and am + 8 of the tile
  const int am = tid / 128 * 64 + tid % 128 / 32 * 16 + lane / 4, tq = lane % 4;
  const uint32_t whi = static_cast<uint32_t>(__cvta_generic_to_shared(sW));
  const uint32_t wlo = whi + 4 * kWFloats;
  float acc[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = 0.0f;
  uint32_t ahi[2][4] = {}, alo[2][4] = {};   // two steps' A registers: one in flight
  for (int kt = 0; kt < slabs; ++kt) {
    copy_wait_all();
    __syncthreads();   // slab kt is in; every warpgroup is done with slab kt - 1
    if (kt + 1 < slabs) {
      load_slab<V>(a, sRaw + (kt + 1) % 2 * kRawFloats, sZ + (kt + 1) % 2 * kZFloats, i0, j0,
                   (kt + 1) * kSlab);
      copy_commit();
    }
    split_w(sRaw + kt % 2 * kRawFloats, sW, i0, kt * kSlab);
    fence_async();
    __syncthreads();   // W_hi and W_lo of slab kt are in
    const float* z = sZ + kt % 2 * kZFloats + tq * kLdZ + am;
    fence_regs(acc);
#pragma unroll
    for (int s = 0; s < kSlab / 8; ++s) {
      const int b = s & 1;
      const float* zs = z + 8 * s * kLdZ;
      repro_tf32::split(zs[0], ahi[b][0], alo[b][0]);
      repro_tf32::split(zs[8], ahi[b][1], alo[b][1]);
      repro_tf32::split(zs[4 * kLdZ], ahi[b][2], alo[b][2]);
      repro_tf32::split(zs[4 * kLdZ + 8], ahi[b][3], alo[b][3]);
      // K-major, no swizzle: LBO 128 bytes (the next 4 senders), SBO 1024
      // (the next 8 receivers)
      const uint64_t dhi = repro_wgmma::desc(whi + 256 * s, 128, 1024, 0);
      const uint64_t dlo = repro_wgmma::desc(wlo + 256 * s, 128, 1024, 0);
      wg_fence();
      wgmma_tf32(acc, alo[b], dhi);   // lo hi + hi lo + hi hi, the small terms first
      wgmma_tf32(acc, ahi[b], dlo);
      wgmma_tf32(acc, ahi[b], dhi);
      wg_commit();
      wg_wait<1>();   // the step before is done: its A registers are free
      fence_regs(ahi[b ^ 1]);
      fence_regs(alo[b ^ 1]);
    }
    wg_wait<0>();   // and this slab's: W_hi and W_lo are free
    fence_regs(ahi[1]);
    fence_regs(alo[1]);
    fence_regs(acc);
  }
  __syncthreads();   // the ring is free: the output tile takes its place
  float* sOut = ring;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float* o = sOut + (8 * j + 2 * tq) * kLdOut + am;
    o[0] = acc[4 * j];
    o[kLdOut] = acc[4 * j + 1];
    o[8] = acc[4 * j + 2];
    o[kLdOut + 8] = acc[4 * j + 3];
  }
  __syncthreads();

  // epilogue: a warp kEpiRows rows a pass, kWarps apart, a lane kTileN /
  // 32 columns 32 apart, every load of the pass issued before its normals;
  // the mix is W_ii z_i + the products. A row past the tile's last and
  // lanes past d draw along (the last row, column d - 1), store nothing.
  constexpr int kWarps = kTiledThreads / 32, kC = kTileN / 32, kE = kEpiRows * kC;
  const int warp = tid / 32;
  const T* __restrict__ p = static_cast<const T*>(a.p);
  const T* __restrict__ g = static_cast<const T*>(a.g);
  T* __restrict__ out = static_cast<T*>(a.out);
  const float* __restrict__ zw = a.ws;
  const float* __restrict__ nf = a.ws + (size_t)n * d;
  const uint32_t seed = (uint32_t)a.seed[0], gcol0 = (uint32_t)a.col0[0];
  int col[kC];   // the lane's columns, clamped to d - 1
#pragma unroll
  for (int c = 0; c < kC; ++c) col[c] = min(j0 + lane + 32 * c, d - 1);
  for (int r0 = warp; r0 < rows; r0 += kEpiRows * kWarps) {
    size_t row[kEpiRows];
#pragma unroll
    for (int h = 0; h < kEpiRows; ++h) row[h] = (size_t)(i0 + min(r0 + h * kWarps, rows - 1)) * d;
    float x[kE], zi[kE], nfe[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const size_t off = row[e / kC] + col[e % kC];
      x[e] = local_step(load_f(p, off), load_f(g, off), a.gamma);
      zi[e] = zw[off];
      nfe[e] = a.noisy ? nf[off] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int r = r0 + e / kC * kWarps, j = j0 + lane + 32 * (e % kC), rr = min(r, rows - 1);
      const size_t off = row[e / kC] + col[e % kC];
      const float4 rc = sRow[rr];
      float vv;
      if (a.noisy) {
        const uint32_t idx = counter(a.row0 + (uint32_t)(i0 + rr), a.counter_width, gcol0 + (uint32_t)j);
        const float gm = repro_noise::normal_from_bits(repro_noise::hash_bits(2u * idx + 1u, seed));
        vv = partial(x[e], nfe[e], gm, rc);
      } else {
        vv = partial(x[e], 0.0f, 0.0f, rc);
      }
      const float mix = fmaf(sDiag[rr], zi[e], sOut[rr * kLdOut + lane + 32 * (e % kC)]);
      if (r < rows && j < d) store_f(out, off, fmaf(rc.w, mix, vv));
    }
  }
}

// ---- the sparse round -------------------------------------------------------

struct Neighbors {
  const int32_t* idx;     // [n, k], each in [0, n_src) (clamped, as XLA's gather clamps)
  const float* w;         // [n, k]
  const float* self_w;    // [n]
  const int32_t* order;   // [n], the receivers in locality order (null: index order)
  int k;
  const float* z_src;     // [n_src, d] float32, the rows idx reads (the whole round: the workspace's z)
  int n_src;
};

// Replicate r's neighbor list of a stack of sparse rounds: idx and w r n k
// on, self_w and order r n, and z_src, the workspace's z there, to
// replicate r's z (2 r n d on). Only the whole round (z_src = the
// workspace) is stacked.
__device__ __forceinline__ Neighbors replicate(const Neighbors& nb, unsigned r, int n, int d) {
  if (r == 0) return nb;
  Neighbors b = nb;
  const size_t nk = (size_t)n * nb.k;
  b.idx = nb.idx + r * nk;
  b.w = nb.w + r * nk;
  b.self_w = nb.self_w + r * (size_t)n;
  if (nb.order != nullptr) b.order = nb.order + r * (size_t)n;
  b.z_src = nb.z_src + 2 * r * ((size_t)n * d);
  return b;
}

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// Entries of the hash set that forms the union of a group's rows at degree
// k: a power of two, at least twice its kGroup (k + 1) rows, so it never
// fills.
__host__ __device__ inline int set_entries(int k) {
  int h = 1;
  while (h < 2 * kGroup * (k + 1)) h *= 2;
  return h;
}

// A gather block's shared memory at degree k and a staged capacity of cap
// rows, as byte offsets: the ring's two
// mbarriers, the receivers (row constants; own row's place and self_w;
// index) and the union's count; the slots (place, w); the staged rows'
// sources; then one region, the hash set of the union while it is formed
// and the ring of two column slabs after.
struct GatherLayout {
  size_t slots, bases, region, bytes;
};

__host__ __device__ inline GatherLayout gather_layout(int k, int cap) {
  GatherLayout L;
  L.slots = align16(2 * sizeof(uint64_t) +
                    (sizeof(float4) + sizeof(int2) + sizeof(int)) * kGroup + sizeof(int));
  L.bases = align16(L.slots + sizeof(int2) * kGroup * (size_t)k);
  L.region = align16(L.bases + sizeof(const float*) * (size_t)cap);
  const size_t ring = 2 * sizeof(float) * (size_t)cap * kRowFloats;
  const size_t set = 2 * sizeof(int) * (size_t)set_entries(k);
  L.bytes = L.region + (ring > set ? ring : set);
  return L;
}

__device__ __forceinline__ uint32_t set_hash(int code) {
  uint32_t x = (uint32_t)code;
  x ^= x >> 16;
  x *= 0x7feb352du;
  return x ^ (x >> 15);
}

// code into the hash set (linear probing; -1 is an empty entry)
__device__ __forceinline__ void set_insert(int* set, int mask, int code) {
  for (uint32_t h = set_hash(code) & mask;; h = (h + 1) & mask) {
    const int prev = atomicCAS(set + h, -1, code);
    if (prev == -1 || prev == code) return;
  }
}

__device__ __forceinline__ int set_find(const int* set, int mask, int code) {
  uint32_t h = set_hash(code) & mask;
  while (set[h] != code) h = (h + 1) & mask;
  return (int)h;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
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

// bytes (a multiple of 16) from global src (16-byte aligned) to shared dst
// by the bulk copy engine, completing on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// A row of the union: z_src's row code, or past z_src's n_src rows the
// workspace's z (own, a shard's own rows) row code - n_src.
__device__ __forceinline__ const float* union_row(const Neighbors& nb, const float* own, int code,
                                                  int d) {
  return code < nb.n_src ? nb.z_src + (size_t)code * d : own + (size_t)(code - nb.n_src) * d;
}

// Floats a staged row's slab lies past its 16-byte start (the row's own
// alignment: every slab starts kSlabCols floats, 512 bytes, further on).
__device__ __forceinline__ int row_shift(const float* row) {
  return (int)((reinterpret_cast<uintptr_t>(row) % 16) / sizeof(float));
}

// A lane's columns of a slot's row: staged (place >= 0: zs the ring slot,
// place the row's floats into it), else (Staged false: a row past the
// capacity, code -1 - place) from global memory.
template <bool Staged, int V>
__device__ __forceinline__ Pack<float, kLaneCols> slot_cols(const float* zs, int place,
                                                            const Neighbors& nb, const float* own,
                                                            int c0, int d) {
  if (!Staged && place < 0) return load_lane<V>(union_row(nb, own, -1 - place, d), c0, d);
  const float* row = zs + place + (threadIdx.x % 32) * V;
  Pack<float, kLaneCols> z;
#pragma unroll
  for (int h = 0; h < kLaneCols; h += V) {
    const Pack<float, V> x = *reinterpret_cast<const Pack<float, V>*>(row + h * 32);
#pragma unroll
    for (int c = 0; c < V; ++c) z.v[h + c] = x.v[c];
  }
  return z;
}

// The staged rows' columns [c0, c0 + kSlabCols) into a ring slot, each
// row's slab row_shift floats into its kRowFloats: one bulk copy a row
// from its 16-byte start, completing on bar. Warp 0 sums the bytes, arms
// the barrier with them, then issues the copies; past d a row's slab is
// left as it was (no lane stores there).
__device__ __forceinline__ void load_union_bulk(float* dst, const float* const* base, int rows,
                                                int c0, int d, uint32_t bar) {
  const int lane = threadIdx.x % 32, cols = min(kSlabCols, d - c0);
  uint32_t bytes = 0;
  for (int u = lane; u < rows; u += 32)
    bytes += align16((row_shift(base[u]) + cols) * sizeof(float));
  bytes = __reduce_add_sync(0xffffffffu, bytes);
  if (lane == 0) mbar_expect_tx(bar, bytes);
  __syncwarp();
  for (int u = lane; u < rows; u += 32) {
    const int shift = row_shift(base[u]);
    bulk_copy(static_cast<uint32_t>(__cvta_generic_to_shared(dst + u * kRowFloats)),
              base[u] + c0 - shift, align16((shift + cols) * sizeof(float)), bar);
  }
}

// One of a warp's receivers at a slab: its place in the group (one past n
// as the group's first, storing nothing), its row, and the lane's loads of
// p, g and nf.
template <typename T>
struct Recv {
  int r;
  size_t off;
  bool live;
  Pack<T, kLaneCols> p, g;
  Pack<float, kLaneCols> nf;
};

// The warp's m-th receiver at the slab from c0, its loads issued.
template <int V, typename T>
__device__ __forceinline__ Recv<T> recv_loads(const Args& a, const int* sRecv, int m, int c0) {
  const int d = a.d, r = threadIdx.x / 32 + kGatherWarps * m;
  Recv<T> b;
  b.live = sRecv[r] >= 0;
  b.r = b.live ? r : 0;
  b.off = (size_t)sRecv[b.r] * d;
  b.p = load_lane<V>(static_cast<const T*>(a.p) + b.off, c0, d);
  b.g = load_lane<V>(static_cast<const T*>(a.g) + b.off, c0, d);
  b.nf = a.noisy ? load_lane<V>(a.ws + (size_t)a.n * d + b.off, c0, d) : Pack<float, kLaneCols>{};
  return b;
}

// One slab of the group's out (columns from c0; zs the ring slot): a warp
// a receiver at a time, each element as the round forms it. cur holds the
// first receiver's loads; each receiver issues the next one's (past the
// last, where there is a next slab (more), that slab's first) before its
// own arithmetic, and leaves them in cur. Staged: every slot's row is in
// the ring.
template <bool Staged, int V, typename T>
__device__ __forceinline__ void gather_slab(const Args& a, const Neighbors& nb, const float* zs,
                                            const float4* sRc, const int2* sSelf,
                                            const int2* sSlot, const int* sRecv, int c0,
                                            Recv<T>& cur, bool more) {
  using namespace repro_noise;
  constexpr int M = kGroup / kGatherWarps;   // receivers a warp
  const int d = a.d, k = nb.k, lane = threadIdx.x % 32;
  const float* own = a.ws;   // the workspace's z: a shard's own rows
  T* __restrict__ out = static_cast<T*>(a.out);
  const uint32_t seed = (uint32_t)a.seed[0], gcol = (uint32_t)a.col0[0] + (uint32_t)c0;
#pragma unroll 1
  for (int m = 0; m < M; ++m) {
    Recv<T> nxt;
    if (m + 1 < M)
      nxt = recv_loads<V, T>(a, sRecv, m + 1, c0);
    else if (more)
      nxt = recv_loads<V, T>(a, sRecv, 0, c0 + kSlabCols);
    // the mix, slot by slot
    float acc[kLaneCols];
    const int2 sf = sSelf[cur.r];
    const Pack<float, kLaneCols> zi = slot_cols<Staged, V>(zs, sf.x, nb, own, c0, d);
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) acc[c] = __fmul_rn(__int_as_float(sf.y), zi.v[c]);
#pragma unroll 4
    for (int s = 0; s < k; ++s) {
      const int2 sl = sSlot[cur.r * k + s];
      const Pack<float, kLaneCols> zk = slot_cols<Staged, V>(zs, sl.x, nb, own, c0, d);
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) acc[c] = fmaf(__int_as_float(sl.y), zk.v[c], acc[c]);
    }
    // Gm of the lane's elements, drawn together
    float gm[kLaneCols];
    if (a.noisy) {
      float tt[kLaneCols], ww[kLaneCols];
      const uint32_t row = a.row0 + (uint32_t)sRecv[cur.r];
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) {
        const uint32_t idx = counter(row, a.counter_width, gcol + (uint32_t)lane_col<V>(lane, c));
        tt[c] = lattice_t(hash_bits(2u * idx + 1u, seed));
      }
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) ww[c] = lattice_w(tt[c]);
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) gm[c] = erfinv_central(ww[c]);
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) gm[c] = normal_from_p(erfinv_p(gm[c], ww[c]), tt[c]);
    }
    const float4 rc = sRc[cur.r];
    float o[kLaneCols];
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) {
      const float x = local_step(to_f(cur.p.v[c]), to_f(cur.g.v[c]), a.gamma);
      const float v = a.noisy ? partial(x, cur.nf.v[c], gm[c], rc) : partial(x, 0.0f, 0.0f, rc);
      o[c] = fmaf(rc.w, acc[c], v);
    }
    if (cur.live) store_lane<V>(out + cur.off, c0, d, o);
    cur = nxt;
  }
}

// out of a group of kGroup receivers (the order's entries blockIdx.x
// kGroup on, index order without one; global rows row0 + i) over the
// column slabs blockIdx.y per_block on. The block first forms the group's
// union of rows: every receiver's own z (the workspace's; in the whole
// round z_src is the workspace's z, so the same code as a slot's) and each
// slot's row of z_src, once each (a hash set in shared memory), with each
// slot's place in it; the first cap rows are staged. Then slab by slab the
// staged rows' columns arrive in a ring of two (bulk copies, one a row,
// each slab's completing on its ring slot's mbarrier), the next slab's
// under this one's arithmetic (gather_slab).
template <typename T, int V>
__global__ void __launch_bounds__(kGatherThreads, kGatherBlocks)
dp_mix_gather(const Args args, const Neighbors nbs, const int cap, const int per_block) {
  constexpr int G = kGroup;
  const Args a = replicate<T>(args, blockIdx.z);
  const Neighbors nb = replicate(nbs, blockIdx.z, args.n, args.d);
  // the union's code of local row 0's own z: z_src's row 0 in the whole
  // round (z_src is the workspace's z), else past z_src's rows (union_row)
  const int own0 = nbs.z_src == args.ws ? 0 : nb.n_src;
  const float* own = a.ws;
  const int n = a.n, d = a.d, k = nb.k, tid = threadIdx.x;
  const GatherLayout L = gather_layout(k, cap);
  const int entries = set_entries(k), mask = entries - 1;
  extern __shared__ __align__(16) unsigned char gather_smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(gather_smem);     // [2], a ring slot's
  float4* sRc = reinterpret_cast<float4*>(bars + 2);              // [G]
  int2* sSelf = reinterpret_cast<int2*>(sRc + G);                 // [G] (place, self_w)
  int* sRecv = reinterpret_cast<int*>(sSelf + G);                 // [G], -1 past n
  int* sCount = sRecv + G;                                        // the union's rows
  int2* sSlot = reinterpret_cast<int2*>(gather_smem + L.slots);   // [G][k] (place, w)
  const float** sBase = reinterpret_cast<const float**>(gather_smem + L.bases);   // [cap]
  int* set = reinterpret_cast<int*>(gather_smem + L.region);      // [entries]
  int* place = set + entries;                                     // [entries]
  float* ring = reinterpret_cast<float*>(gather_smem + L.region); // [2][cap][kRowFloats]
  const uint32_t bar0 = static_cast<uint32_t>(__cvta_generic_to_shared(bars));

  // the group's receivers
  for (int h = tid; h < entries; h += kGatherThreads) set[h] = -1;
  if (tid == 0) {
    *sCount = 0;
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < G) {
    const int pos = blockIdx.x * G + tid;
    int i = -1;
    if (pos < n) i = nb.order != nullptr ? min(max(nb.order[pos], 0), n - 1) : pos;
    sRecv[tid] = i;
    if (i >= 0) sRc[tid] = row_const(a, i);
  }
  __syncthreads();
  // their rows into the set, each slot's code kept for its place
  for (int e = tid; e < G * (k + 1); e += kGatherThreads) {
    const int r = e / (k + 1), s = e % (k + 1) - 1, i = sRecv[r];
    if (i < 0) continue;
    int code;
    if (s < 0) {
      code = own0 + i;
      sSelf[r] = make_int2(code, __float_as_int(nb.self_w[i]));
    } else {
      const size_t at = (size_t)i * k + s;
      code = min(max(nb.idx[at], 0), nb.n_src - 1);
      sSlot[r * k + s] = make_int2(code, __float_as_int(nb.w[at]));
    }
    set_insert(set, mask, code);
  }
  __syncthreads();
  // number the union's rows; the first cap are staged
  for (int h = tid; h < entries; h += kGatherThreads) {
    const int code = set[h];
    if (code < 0) continue;
    const int u = atomicAdd(sCount, 1);
    place[h] = u;
    if (u < cap) sBase[u] = union_row(nb, own, code, d);
  }
  __syncthreads();
  // each slot's place: its staged row's floats into a ring slot, or -1 -
  // its code
  for (int e = tid; e < G * (k + 1); e += kGatherThreads) {
    const int r = e / (k + 1), s = e % (k + 1) - 1;
    if (sRecv[r] < 0) continue;
    int* at = s < 0 ? &sSelf[r].x : &sSlot[r * k + s].x;
    const int u = place[set_find(set, mask, *at)];
    *at = u < cap ? u * kRowFloats + row_shift(union_row(nb, own, *at, d)) : -1 - *at;
  }
  const int count = *sCount, staged = min(count, cap);
  fence_async();     // the set's writes before the bulk copies' into its place
  __syncthreads();   // the set is done with: the ring takes its place

  const int slabs = (d + kSlabCols - 1) / kSlabCols;
  const int t0 = blockIdx.y * per_block, t1 = min(t0 + per_block, slabs);
  const size_t slot_floats = (size_t)cap * kRowFloats;
  const auto load = [&](int t) {   // slab t into its ring slot, by warp 0
    const int slot = (t - t0) % 2;
    if (tid < 32)
      load_union_bulk(ring + slot * slot_floats, sBase, staged, t * kSlabCols, d, bar0 + 8 * slot);
  };
  Recv<T> cur;   // the first receiver's loads of each slab, issued ahead
  if (t0 < t1) {
    load(t0);
    cur = recv_loads<V, T>(a, sRecv, 0, t0 * kSlabCols);
  }
  for (int t = t0; t < t1; ++t) {
    const int slot = (t - t0) % 2;
    mbar_wait(bar0 + 8 * slot, (uint32_t)((t - t0) / 2 % 2));
    __syncthreads();   // slab t is in; every warp is done with slab t - 1
    if (t + 1 < t1) load(t + 1);
    const float* zs = ring + slot * slot_floats;
    if (count <= cap)
      gather_slab<true, V, T>(a, nb, zs, sRc, sSelf, sSlot, sRecv, t * kSlabCols, cur, t + 1 < t1);
    else
      gather_slab<false, V, T>(a, nb, zs, sRc, sSelf, sSlot, sRecv, t * kSlabCols, cur, t + 1 < t1);
  }
}

template <typename T>
int launch_prep(const Args& a, int reps, cudaStream_t stream) {
  if (a.ws == nullptr || reps < 1 || reps > 65535) return (int)cudaErrorInvalidValue;
  // V columns a load: the most that every row of p, g and the workspace starts on
  const auto fits = [&](int v) {
    return a.d % v == 0 && (uintptr_t)a.p % (sizeof(T) * v) == 0 &&
           (uintptr_t)a.g % (sizeof(T) * v) == 0 && (uintptr_t)a.ws % (sizeof(float) * v) == 0;
  };
  const dim3 grid((a.d + kPrepThreads * kLaneCols - 1) / (kPrepThreads * kLaneCols),
                  (a.n + kPrepRows - 1) / kPrepRows, reps);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (fits(4))
    dp_mix_prep<T, 4><<<grid, kPrepThreads, 0, stream>>>(a);
  else if (fits(2))
    dp_mix_prep<T, 2><<<grid, kPrepThreads, 0, stream>>>(a);
  else
    dp_mix_prep<T, 1><<<grid, kPrepThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The rows a gather block stages at degree k: as many as let kGatherBlocks
// blocks share an SM, at most the group's every row; -1 if the device
// cannot say.
int gather_capacity(int k) {
  int dev = 0, per_sm = 0, reserved = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev) != cudaSuccess)
    return -1;
  const long budget = per_sm / kGatherBlocks - reserved;
  const long fixed = (long)gather_layout(k, 0).region;
  const long row = 2 * sizeof(float) * kRowFloats + sizeof(const float*);
  const long cap = budget > fixed ? (budget - fixed) / row : 0;
  return (int)(cap < (long)kGroup * (k + 1) ? cap : (long)kGroup * (k + 1));
}

template <typename T, int V>
int launch_gather_v(const Args& a, const Neighbors& nb, int reps, cudaStream_t stream) {
  const int cap = gather_capacity(nb.k);
  if (cap < 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = gather_layout(nb.k, cap).bytes;
  static size_t opted_in = 48 * 1024;   // shared memory granted without opt-in
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        dp_mix_gather<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = bytes;
  }
  const int slabs = (a.d + kSlabCols - 1) / kSlabCols;
  const int per_block = max(kSlabsPerBlock, (slabs + 65534) / 65535);
  const dim3 grid((a.n + kGroup - 1) / kGroup, (slabs + per_block - 1) / per_block, reps);
  dp_mix_gather<T, V><<<grid, kGatherThreads, bytes, stream>>>(a, nb, cap, per_block);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gather(const Args& a, const Neighbors& nb, int reps, cudaStream_t stream) {
  if (a.ws == nullptr || nb.z_src == nullptr || nb.k < 0 || nb.n_src < 1 || reps < 1 ||
      reps > 65535 || (reps > 1 && nb.z_src != a.ws) || (long)nb.n_src + a.n > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  // V floats a copy of z and a load of p, g, nf and out: the most that
  // every row starts on
  const auto fits = [&](int v) {
    return a.d % v == 0 && (uintptr_t)nb.z_src % (sizeof(float) * v) == 0 &&
           (uintptr_t)a.ws % (sizeof(float) * v) == 0 && (uintptr_t)a.p % (sizeof(T) * v) == 0 &&
           (uintptr_t)a.g % (sizeof(T) * v) == 0 && (uintptr_t)a.out % (sizeof(T) * v) == 0;
  };
  return fits(4) ? launch_gather_v<T, 4>(a, nb, reps, stream)
                 : fits(2) ? launch_gather_v<T, 2>(a, nb, reps, stream)
                           : launch_gather_v<T, 1>(a, nb, reps, stream);
}

template <typename T>
int launch_sparse(const Args& a, const Neighbors& nb, int reps, cudaStream_t stream) {
  const int err = launch_prep<T>(a, reps, stream);
  return err != 0 ? err : launch_gather<T>(a, nb, reps, stream);
}

template <typename T, int V>
int launch_tiled(const Args& a, int reps, cudaStream_t stream) {
  static bool opted_in = false;   // past 48 KiB of shared memory, and the most of it an SM has
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(dp_mix_tiled<T, V>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTiledSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dp_mix_tiled<T, V>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const size_t tiles = (size_t)((a.n + kTileM - 1) / kTileM) * ((a.d + kTileN - 1) / kTileN);
  if (tiles > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  dp_mix_tiled<T, V><<<dim3((unsigned)tiles, 1, reps), kTiledThreads, kTiledSmem, stream>>>(a);
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
  if (a.W == nullptr) return (int)cudaErrorInvalidValue;
  const int err = launch_prep<T>(a, reps, stream);
  if (err != 0) return err;
  // V floats a copy: the most that every row of W and of z starts on
  const auto fits = [&](int v) {
    return a.n % v == 0 && a.d % v == 0 && (uintptr_t)a.W % (4 * v) == 0 &&
           (uintptr_t)a.ws % (4 * v) == 0;
  };
  return fits(4) ? launch_tiled<T, 4>(a, reps, stream)
                 : fits(2) ? launch_tiled<T, 2>(a, reps, stream) : launch_tiled<T, 1>(a, reps, stream);
}

}  // namespace

extern "C" {

// Floats of the workspace the launch needs at [n, d]: 0 on the column
// route, 2 n d (z and nf, float32) on the large-N route; a stack of reps
// rounds needs reps times that.
size_t dp_mix_workspace_floats(int n, int d) {
  return n < 1 || d < 1 || columns_route(n) ? 0 : 2 * (size_t)n * d;
}

// Rows of z a sparse gather block (a group of kGroup receivers) stages at
// degree k on the current device; the rest of a group's union reads from
// global memory. -1 if the device cannot say.
int dp_mix_gather_capacity(int k) { return k < 0 ? -1 : gather_capacity(k); }

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
               static_cast<float*>(ws), n, d, counter_width, gamma, eta, noisy, 0u};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, reps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, reps, s);
  return (int)cudaErrorInvalidValue;
}

// The sparse round: idx int32 [n, k], w float32 [n, k], self_w float32 [n]
// take W's place; order int32 [n], a permutation of the receivers, is the
// order the gather's groups take them in (null: index order); ws is a
// float32 workspace of 2 n d floats (z, then nf); row0 offsets the noise
// counters' rows (0: the whole population). reps rounds stacked: idx, w
// [reps, n, k], self_w and order [reps, n], ws 2 reps n d
// floats (replicate r's z and nf 2 r n d on), the rest as dp_mix_launch's
// stack; one prep and one gather launch for all reps, the replicate their
// grid's z. Returns the cudaError_t of the launches.
int dp_mix_sparse_launch(int dtype, const void* p, const void* g, void* out, const void* idx,
                         const void* w, const void* self_w, const void* order,
                         const void* amp, const void* selfs,
                         const void* mscale, const void* listen, const void* scal,
                         const void* seed, const void* col0, void* ws, int reps, int n, int d,
                         int k, int row0, unsigned int counter_width, float gamma, float eta,
                         int noisy, void* stream) {
  if (n < 1 || d < 1 || row0 < 0) return (int)cudaErrorInvalidValue;
  const Args a{p, g, out, nullptr, static_cast<const float*>(amp),
               static_cast<const float*>(selfs), static_cast<const float*>(mscale),
               static_cast<const float*>(listen), static_cast<const float*>(scal),
               static_cast<const int32_t*>(seed), static_cast<const int32_t*>(col0),
               static_cast<float*>(ws), n, d, counter_width, gamma, eta, noisy, (uint32_t)row0};
  const Neighbors nb{static_cast<const int32_t*>(idx), static_cast<const float*>(w),
                     static_cast<const float*>(self_w), static_cast<const int32_t*>(order), k,
                     static_cast<const float*>(ws), n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_sparse<float>(a, nb, reps, s);
  if (dtype == 1) return launch_sparse<__nv_bfloat16>(a, nb, reps, s);
  return (int)cudaErrorInvalidValue;
}

// A worker shard's first half: dp_mix_prep over its n rows, global rows
// [row0, row0 + n), into ws [2, n, d] (z, then nf; gossip: x alone).
int dp_mix_prep_launch(int dtype, const void* p, const void* g, const void* amp,
                       const void* scal, const void* seed, const void* col0, void* ws, int n,
                       int d, int row0, unsigned int counter_width, float gamma, int noisy,
                       void* stream) {
  if (n < 1 || d < 1 || row0 < 0) return (int)cudaErrorInvalidValue;
  const Args a{p, g, nullptr, nullptr, static_cast<const float*>(amp), nullptr, nullptr,
               nullptr, static_cast<const float*>(scal), static_cast<const int32_t*>(seed),
               static_cast<const int32_t*>(col0), static_cast<float*>(ws), n, d, counter_width,
               gamma, 0.0f, noisy, (uint32_t)row0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_prep<float>(a, 1, s);
  if (dtype == 1) return launch_prep<__nv_bfloat16>(a, 1, s);
  return (int)cudaErrorInvalidValue;
}

// Its second half: receivers [row0, row0 + n) from ws (their own z and nf)
// and z_src [n_src, d] float32 (every shard's z, gathered in row order),
// neighbors by global index; idx, w [n, k], self_w, order (a permutation
// of the local rows [0, n), or null) and the vectors are the shard's rows.
int dp_mix_gather_launch(int dtype, const void* p, const void* g, void* out, const void* idx,
                         const void* w, const void* self_w, const void* order,
                         const void* amp, const void* selfs,
                         const void* mscale, const void* listen, const void* scal,
                         const void* seed, const void* col0, void* ws, const void* z_src, int n,
                         int n_src, int d, int k, int row0, unsigned int counter_width,
                         float gamma, float eta, int noisy, void* stream) {
  if (n < 1 || d < 1 || row0 < 0) return (int)cudaErrorInvalidValue;
  const Args a{p, g, out, nullptr, static_cast<const float*>(amp),
               static_cast<const float*>(selfs), static_cast<const float*>(mscale),
               static_cast<const float*>(listen), static_cast<const float*>(scal),
               static_cast<const int32_t*>(seed), static_cast<const int32_t*>(col0),
               static_cast<float*>(ws), n, d, counter_width, gamma, eta, noisy, (uint32_t)row0};
  const Neighbors nb{static_cast<const int32_t*>(idx), static_cast<const float*>(w),
                     static_cast<const float*>(self_w), static_cast<const int32_t*>(order), k,
                     static_cast<const float*>(z_src), n_src};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gather<float>(a, nb, 1, s);
  if (dtype == 1) return launch_gather<__nv_bfloat16>(a, nb, 1, s);
  return (int)cudaErrorInvalidValue;
}

const char* dp_mix_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
