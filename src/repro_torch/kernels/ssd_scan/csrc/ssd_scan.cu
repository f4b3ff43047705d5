// ssd_scan: the Mamba2 SSD intra-chunk step, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan/ssd_scan.py::_ssd_kernel
// (pallas_call in ssd_intra_chunk). For each batch b, chunk c of q rows and
// head h, with cs = the inclusive cumulative sum of dA over the chunk:
//
//   y[i,h,:]   = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) (x[j,h,:] dt_j)
//   st[h,p,n]  = sum_j x[j,h,p] (B[j,n] exp(cs_last - cs_j) dt_j)
//   cd[h]      = exp(cs_last)
//
// y is stored in x's dtype, st ([B, nc, H, P, N], the reference's st.T)
// and cd ([B, nc, H]) in float32; on request also cs ([B, nc, q, H]
// float32), which the scan's inter-chunk part needs. Every operation is
// float32, as in the reference: inputs are widened on load, and cs is a
// float32 sum taken in the order of the reference's jnp.cumsum on the CPU
// (XLA's blocked scan: runs of 16 rows in order, the runs' totals in
// order, each run adding the totals before it; the plain version's
// cumsum_f32 takes the same order). exp(cs_i - cs_j) cancels most of cs's
// magnitude, so at q = 256, where |cs| reaches a few hundred, another
// order's rounding alone moves the decay by ~1e-4: this keeps the
// reference's. The decay is computed only on and below the diagonal: above
// it the difference is positive and grows with the chunk, and its exp
// would overflow (inf * 0 is NaN), so those entries are set to 0 without
// an exp, as jnp.where(tril, exp(diff), 0) selects them.
//
// Layout. x is read as [B, S, H, P] and Bm, Cm as [B, S, N] through their
// batch, sequence (and head) strides, the last dimension contiguous; so the
// model's views into its conv output need no copy. dt and dA are
// contiguous float32 [B, S, H]; y is written contiguous.
//
// Work split. The TPU walks a (B, nc, H/8) grid, each cell holding the
// whole q x q score tile of its chunk in VMEM. Here a block of 256 threads
// (8 warps) owns (b, c, a block of hb = min(8, H) heads) and one role; one
// flat grid over (role, b, c, head block) issues the roles with the most
// work first (the states, then the y blocks from the last query tile
// down), so B is not bounded by a grid dimension.
//  - A y block owns 64 query rows [i0, i0 + 64) of the chunk. It computes
//    the scores C_i . B_j once for its rows and every key up to its last
//    row (a warp takes 16 rows and half of each 64-key block, and skips
//    the 8-key blocks above its rows; C and B come by cp.async, the next
//    64 keys of B while the last are multiplied) and keeps them in
//    shared memory: 64 x q of the q x q tile, never the whole (256 KB at
//    q = 256). Then y = G' @ x on the tensor cores, 2 heads at a time: a
//    warp owns 16 rows of one head and, for each 8 keys, forms its A
//    fragment G'_ij = S_ij exp(cs_i - cs_j) dt_j in registers (4 entries a
//    lane, each exp taken once; 0 above the diagonal); a warp stops at its
//    own last row.
//  - The states block computes st and cd of its heads over all q rows, on
//    the tensor cores: a warp owns 16 rows p of one head's st (fst heads at
//    a time: 2 at P = 64), A = (x w)^T with w_j = exp(cs_last - cs_j) dt_j,
//    B = the B tile. It also writes cs and cd.
//  Both products are split TF32 mma.sync (../../csrc/tf32x3.cuh: three TF32
//  products for each float32 one, so the reference's tolerance holds),
//  issued term by term across 4 column blocks of the accumulator at a
//  time. The operand the warps share (x in the y blocks, B in the states
//  blocks) is split into its (hi, lo) pair once, by the whole block: each
//  thread loads its part of the next tile (32 keys; keys past the chunk as
//  zeros) into registers while the current one is multiplied, then splits
//  and stores it as pairs into the other of two buffers, which the warps
//  read as 8-byte pairs; one barrier a tile. The operand a warp owns alone
//  (its A fragment) it splits itself; the states' x comes by cp.async
//  (16-byte copies) into one of two buffers (a bfloat16 x is widened
//  through registers). Fragment reads put the 32 lanes in 32 banks (row
//  strides 8 floats past a multiple of 32; 4 for the scores; 4 pairs past
//  a multiple of 16 for the split tiles). The decays inside
//  the products are exponentials of x log2(e) in base 2 (__expf: within
//  6e-6 relative of expf where they do not underflow, at |x| < 88); cd, an
//  output, takes expf. The launch works out the plan from its arguments:
//  the heads in flight (fy = min(hb, 2); fst = min(hb, 8 / ceil(P / 16))),
//  the shared memory they take, and which rows load 4 elements at a time.
//
// What recomputing the scores costs: each of the H / 8 head blocks of a
// chunk forms its rows' scores again; at zamba2-7b's prefill (H = 112,
// q = 128, N = P = 64) that is 14 times 1.1 MFLOP (the 16 x 8 blocks on and
// below the diagonal) per chunk, 0.47 GFLOP, against 7.7 GFLOP of
// products, in blocks that keep the scores next to the products that read
// them.
//
// What bounds it on an H100: bytes. At zamba2-7b's prefill (B = 4, S =
// 1024, H = 112, P = N = 64, q = 128, float32) the step reads x, B, C, dt
// and dA once and writes y, the states, the decays and (as the scan
// launches it) cs once, 0.30 GB, 0.090 ms at 3.35 TB/s; its products
// (scores once per chunk, G @ (x dt) per head, the states) are 7.7 GFLOP,
// 0.016 ms at 495 TFLOP/s of TF32. The kernel's own tensor-core work is
// three times its products, and the scores once per block of 8 heads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "../../csrc/dtypes.cuh"
#include "../../csrc/tf32x3.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // query rows of a y block
constexpr int kKeys = 32;       // key rows of a staged tile
constexpr int kMaxHeads = 8;    // heads of a block (the reference's HB)
constexpr int kMaxChunk = 256;
constexpr int kMaxDim = 128;    // N and P
constexpr int kRun = 16;        // rows per run of the cumulative sum
constexpr unsigned kFull = 0xffffffffu;

using repro_dtypes::load_f;
using repro_dtypes::store_f;
using repro_tf32::mma;
using repro_tf32::split;
using repro_tf32::split_a;

struct Params {
  const void* x;
  long long x_sb, x_ss, x_sh;
  const float* dt;
  const float* dA;
  const void* bm;
  long long b_sb, b_ss;
  const void* cm;
  long long c_sb, c_ss;
  void* y;
  float* st;
  float* cd;
  float* cs;  // [B, nc, q, H], or null
  int S, H, P, N, q, hb, nqt, groups;
  int fy, fst;  // heads in flight in a y block and in a states block
  int vx, vbc;  // x rows / Bm and Cm rows readable as 4-element vectors
};

__host__ __device__ constexpr int round_to(int n, int k) { return (n + k - 1) / k * k; }
// row strides: fragment reads take 8 rows x 4 lanes, in floats (8 past a
// multiple of 32; 4 where they read along the row: the scores, C and B) or
// in (hi, lo) pairs (4 past a multiple of 16)
__host__ __device__ constexpr int ld_rows(int cols) { return round_to(cols, 32) + 8; }
__host__ __device__ constexpr int ld_scores(int q) { return round_to(q, 32) + 4; }
__host__ __device__ constexpr int ld_pairs(int cols) { return round_to(cols, 16) + 4; }

// floats of shared memory: cs and dt of the heads, then the role's own
__host__ __device__ constexpr size_t smem_floats(int q, int N, int P, int fy, int fst) {
  const size_t heads = (size_t)2 * kMaxHeads * q;
  const size_t stage = (size_t)3 * kTile * ld_scores(N);  // C, and B two deep
  const size_t xy = (size_t)2 * fy * kKeys * 2 * ld_pairs(P);
  const size_t y = (size_t)kTile * ld_scores(q) + (stage > xy ? stage : xy);
  const size_t st = (size_t)kKeys * (2 * fst * ld_rows(P) + 2 * 2 * ld_pairs(N));
  return heads + (y > st ? y : st);
}

constexpr size_t kMaxSmemBytes = 232448;  // what a block may have on sm_90

// four consecutive bfloat16 elements as floats; p aligned to four elements
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// 16 bytes from src, or zeros (in = false; src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool in) {
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

// a[0 .. rows) <- its inclusive float32 prefix sums, in place, by one warp,
// in the reference's order (rows <= 256): lane l sums rows [16 l, 16 l + 16)
// in order, the lanes' totals are summed in order (lane k adds lane k-1's
// running total), and each lane's rows add the running total before it.
__device__ void warp_cumsum(float* a, int rows, int lane) {
  const int lo = min(lane * kRun, rows), hi = min(lo + kRun, rows);
  float run = 0.f;
  for (int r = lo; r < hi; ++r) {
    run += a[r];
    a[r] = run;
  }
  for (int k = 1; k < kMaxChunk / kRun; ++k) {
    const float prev = __shfl_sync(kFull, run, k - 1);
    if (lane == k) run = prev + run;
  }
  const float before = __shfl_up_sync(kFull, run, 1);
  if (lane > 0)
    for (int r = lo; r < hi; ++r) a[r] += before;
}

// one row of `cols` elements at s (in = false: zeros) into d: 16-byte
// cp.async in float32, widened through registers in bfloat16, element by
// element where rows are not 4-element vectors
template <typename T>
__device__ __forceinline__ void stage_row(float* d, const T* s, int cols, bool vec, bool in,
                                          int lane) {
  if (vec) {
    for (int c = 4 * lane; c < cols; c += 128) {
      if constexpr (std::is_same<T, float>::value)
        cp_async16(d + c, s + c, in);
      else
        *reinterpret_cast<float4*>(d + c) = in ? load4(s + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int c = lane; c < cols; c += 32) d[c] = in ? load_f(s, (size_t)c) : 0.f;
  }
}

// rows r0 .. r0 + 63 of a [rows, cols] operand (row stride rs) into
// dst[r * ld + c], rows at or past `limit` as zeros and columns up to the
// next multiple of 8 as zeros (the products' last step of 8 reads them)
template <typename T>
__device__ void stage64(float* dst, int ld, const T* src, long long rs, int cols, bool vec,
                        int r0, int limit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kTile; r += kWarps) {
    const int j = r0 + r;
    const bool in = j < limit;
    stage_row(dst + r * ld, src + (in ? j * rs : 0), cols, vec, in, lane);
    for (int c = cols + lane; c < ((cols + 7) & ~7); c += 32) dst[r * ld + c] = 0.f;
  }
  cp_async_commit();
}

// rows [j0, j0 + 32) of nf slabs of `cols` elements (slab f's row j at
// src + j rs + f fs) into dst[(f * 32 + jj) * ld + c], rows at or past
// `rows` as zeros: cp.async in float32, widened through registers in
// bfloat16, element by element where rows are not 4-element vectors
template <typename T>
__device__ void stage(float* dst, int ld, const T* src, long long rs, long long fs, int cols,
                      bool vec, int j0, int rows, int nf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nf * kKeys; r += kWarps) {
    const int f = r / kKeys, j = j0 + r % kKeys;
    const bool in = j < rows;
    stage_row(dst + r * ld, src + (in ? j * rs + f * fs : 0), cols, vec, in, lane);
  }
  cp_async_commit();
}

// acc[nb] += A B_nb over the 8-column blocks nb < nbn, in split TF32: B
// is a tile of (hi, lo) pairs, block nb's fragment at bp[8 nb] and
// bp[8 nb + 4 ld] (ld in pairs); the products go term by term across 4
// blocks at a time, so that none waits on the one before it
template <int NT>
__device__ __forceinline__ void mma_row(float (&acc)[NT][4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], int nbn, const uint2* bp,
                                        int ld) {
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += 4) {
    if (n0 >= nbn) break;
    uint2 b0[4], b1[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (n0 + k < nbn) {
        b0[k] = bp[8 * (n0 + k)];
        b1[k] = bp[8 * (n0 + k) + 4 * ld];
      }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (n0 + k < nbn) mma(acc[n0 + k], al, b0[k].x, b1[k].x);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (n0 + k < nbn) mma(acc[n0 + k], ah, b0[k].y, b1[k].y);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (n0 + k < nbn) mma(acc[n0 + k], ah, b0[k].x, b1[k].x);
  }
}

// Rows r = f * 32 + jj (f < nrows / 32 slabs; slab f's row of key j at
// src + j rs + f fs) of a 32-key tile: keys j = j0 + jj, `cols` elements,
// zeros at and past key `rows`. RPW rows a warp (r = warp + 8 i), CPL
// column groups of 32 a lane. load() brings the thread's elements into
// registers; store() splits them into (hi, lo) pairs at dst[r * ld + c].
template <typename T, int RPW, int CPL>
struct TileRegs {
  float v[RPW][CPL];

  __device__ __forceinline__ void load(const T* src, long long rs, long long fs, int cols,
                                       int j0, int rows, int nrows) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + kWarps * i, j = j0 + r % kKeys;
      const bool in = r < nrows && j < rows;
      const T* s = src + (in ? j * rs + (r / kKeys) * fs : 0);
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = lane + 32 * k;
        v[i][k] = in && c < cols ? load_f(s, (size_t)c) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(uint2* dst, int ld, int cols, int nrows) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + kWarps * i;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = lane + 32 * k;
        if (r < nrows && c < cols) {
          uint2 pr;
          split(v[i][k], pr.x, pr.y);
          dst[r * ld + c] = pr;
        }
      }
    }
  }
};

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nb = 0; nb < NT; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nb][i] = 0.f;
}

// v0, v1 to row[c], row[c + 1] (c < cols), two at a time where cols is even
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int c, int cols, float v0, float v1) {
  if (c + 1 < cols && (cols & 1) == 0) {
    if constexpr (std::is_same<T, float>::value)
      *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (c < cols) store_f(row, (size_t)c, v0);
    if (c + 1 < cols) store_f(row, (size_t)c + 1, v1);
  }
}

template <typename T, int NTP, int NTN>
__global__ void __launch_bounds__(kThreads, NTP == 8 && NTN == 8 ? 2 : 1)
    ssd_intra(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int q = p.q, N = p.N, P = p.P;
  float* sCs = smem;                 // [kMaxHeads][q]
  float* sDt = sCs + kMaxHeads * q;  // [kMaxHeads][q]: dt, then (states) the decay to the end
  float* sR = sDt + kMaxHeads * q;   // the role's own

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment coordinates

  // blockIdx.x = rank * groups + group: rank 0 the states, rank r >= 1 the
  // y block of query tile nqt - r; group = (b * nc + c) * nh + head block
  const int group = (int)(blockIdx.x % (unsigned)p.groups);
  const int rank = (int)(blockIdx.x / (unsigned)p.groups);
  const int nh = p.H / p.hb, nc = p.S / q;
  const int h0 = (group % nh) * p.hb;
  const int c = (group / nh) % nc;
  const long long b = group / (nh * nc);
  const bool states = rank == 0;
  const int i0 = states ? 0 : (p.nqt - rank) * kTile;
  const int rows = states ? q : min(q, i0 + kTile);  // rows whose cs is needed
  const long long row0 = (long long)c * q;            // the chunk's first row

  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + row0 * p.x_ss;
  const T* bm = static_cast<const T*>(p.bm) + b * p.b_sb + row0 * p.b_ss;
  const T* cm = static_cast<const T*>(p.cm) + b * p.c_sb + row0 * p.c_ss;

  for (int e = tid; e < rows * p.hb; e += kThreads) {
    const int r = e / p.hb, hh = e % p.hb;
    const size_t gi = ((size_t)b * p.S + row0 + r) * p.H + h0 + hh;
    sCs[hh * q + r] = p.dA[gi];
    sDt[hh * q + r] = p.dt[gi];
  }
  __syncthreads();
  if (warp < p.hb) warp_cumsum(sCs + warp * q, rows, lane);
  __syncthreads();

  if (states) {
    const size_t bc = (size_t)b * nc + c;
    if (p.cs)
      for (int e = tid; e < q * p.hb; e += kThreads) {
        const int r = e / p.hb, hh = e % p.hb;
        p.cs[(bc * q + r) * p.H + h0 + hh] = sCs[hh * q + r];
      }
    if (tid < p.hb) p.cd[bc * p.H + h0 + tid] = expf(sCs[tid * q + q - 1]);
    // sDt <- w = exp(cs_last - cs_j) dt_j, the decay of row j to the chunk's end
    for (int e = tid; e < p.hb * q; e += kThreads) {
      const int hh = e / q, j = e % q;
      sDt[hh * q + j] = __expf(sCs[hh * q + q - 1] - sCs[hh * q + j]) * sDt[hh * q + j];
    }

    // warp (hf, ps) owns rows p = 16 ps + g, + 8 of head slot hf
    const int pw = (P + 15) >> 4, hf = warp / pw, ps = warp % pw, pa = 16 * ps + g;
    const int nbn = (N + 7) >> 3, ldx = ld_rows(P), ldp = ld_pairs(N);
    float* sX = sR;                                                   // [2][fst][kKeys][ldx]: x
    uint2* sBp = reinterpret_cast<uint2*>(sX + 2 * p.fst * kKeys * ldx);  // [2][kKeys][ldp]: B split
    const int npass = (p.hb + p.fst - 1) / p.fst, nkt = (q + kKeys - 1) / kKeys;
    const int steps = npass * nkt;
    auto stage_x = [&](int it) {  // x of the pass's heads, keys of tile it
      const int pass = it / nkt;
      stage(sX + (it & 1) * p.fst * kKeys * ldx, ldx, x + (h0 + pass * p.fst) * p.x_sh, p.x_ss,
            p.x_sh, P, p.vx, (it % nkt) * kKeys, q, min(p.fst, p.hb - pass * p.fst));
    };
    TileRegs<T, kKeys / kWarps, NTN / 4> bt;  // B of a tile, on its way to sBp
    auto load_b = [&](int it) { bt.load(bm, p.b_ss, 0, N, (it % nkt) * kKeys, q, kKeys); };
    float acc[NTN][4];
    zero(acc);
    stage_x(0);
    load_b(0);
    bt.store(sBp, ldp, N, kKeys);
    if (steps > 1) load_b(1);
    cp_async_wait_all();
    __syncthreads();  // w, and tile 0's x and B, in place
    for (int it = 0; it < steps; ++it) {
      const int pass = it / nkt, kt = it % nkt, j0 = kt * kKeys;
      const int hp = h0 + pass * p.fst, nhp = min(p.fst, p.hb - pass * p.fst);
      if (it + 1 < steps) stage_x(it + 1);
      if (hf < nhp && pa - g < P) {
        const float* w = sDt + (hp - h0 + hf) * q;
        const float* xs = sX + ((it & 1) * p.fst + hf) * kKeys * ldx;
        const uint2* bs = sBp + (it & 1) * kKeys * ldp + g;
#pragma unroll 1
        for (int s8 = 0; s8 < kKeys && j0 + s8 < q; s8 += 8) {
          // A = (x w)^T: rows p (pa, pa + 8), keys s8 + t, s8 + t + 4
          const int ja = j0 + s8 + t;
          const float wa = ja < q ? w[ja] : 0.f, wc = ja + 4 < q ? w[ja + 4] : 0.f;
          const float* xa = xs + (s8 + t) * ldx + pa;
          uint32_t ah[4], al[4];
          split_a(xa[0] * wa, xa[8] * wa, xa[4 * ldx] * wc, xa[4 * ldx + 8] * wc, ah, al);
          mma_row(acc, ah, al, nbn, bs + (s8 + t) * ldp, ldp);
        }
      }
      if (kt == nkt - 1) {
        if (hf < nhp) {
          float* st = p.st + (bc * p.H + hp + hf) * P * N;
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int pr = pa + 8 * rh;
            if (pr >= P) continue;
#pragma unroll
            for (int nb = 0; nb < NTN; ++nb)
              if (nb < nbn)
                store_pair(st + (size_t)pr * N, 8 * nb + 2 * t, N, acc[nb][2 * rh],
                           acc[nb][2 * rh + 1]);
          }
        }
        zero(acc);
      }
      if (it + 1 < steps) {
        bt.store(sBp + ((it + 1) & 1) * kKeys * ldp, ldp, N, kKeys);
        if (it + 2 < steps) load_b(it + 2);
      }
      cp_async_wait_all();
      __syncthreads();  // tile it + 1 in place; every warp is done with tile it
    }
    return;
  }

  // ---- a y block: scores of rows [i0, i0 + 64) against keys [0, rows),
  // S = C B^T on the tensor cores: warp (slab, half) takes rows 16 slab ..
  // + 15 and keys 32 half .. + 31 of each 64-key block, skipping the 8-key
  // blocks that lie above its last row
  const int lds = ld_scores(q);
  float* sS = sR;  // [kTile][lds]
  float* sP = sS + kTile * lds;
  {
    const int ldc = ld_scores(N), nks = (N + 7) >> 3, nkb = (rows + kTile - 1) / kTile;
    float* sC = sP;                  // [kTile][ldc]: C of the block's rows
    float* sB = sC + kTile * ldc;    // [2][kTile][ldc]: B of 64 keys
    const int slab = warp & 3, half = warp >> 2, lastr = i0 + 16 * slab + 15;
    stage64(sC, ldc, cm, p.c_ss, N, p.vbc, i0, q);
    stage64(sB, ldc, bm, p.b_ss, N, p.vbc, 0, rows);
    const float* ca = sC + (16 * slab + g) * ldc + t;
    for (int kb = 0; kb < nkb; ++kb) {
      cp_async_wait_all();
      __syncthreads();  // keys kb in place; every warp is done with the other buffer
      if (kb + 1 < nkb)
        stage64(sB + ((kb + 1) & 1) * kTile * ldc, ldc, bm, p.b_ss, N, p.vbc, (kb + 1) * kTile,
                rows);
      const int k0 = kb * kTile + 32 * half;
      const int nn = min(4, max(0, (lastr - k0 + 8) >> 3));  // 8-key blocks at or below a row
      const float* bb = sB + (kb & 1) * kTile * ldc + (32 * half + g) * ldc + t;
      float sc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll 1
      for (int ks = 0; ks < nks && nn > 0; ++ks) {
        uint32_t ah[4], al[4];
        split_a(ca[8 * ks], ca[8 * ldc + 8 * ks], ca[8 * ks + 4], ca[8 * ldc + 8 * ks + 4], ah, al);
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          split(bb[8 * n * ldc + 8 * ks], bh[n][0], bl[n][0]);
          split(bb[8 * n * ldc + 8 * ks + 4], bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (n < nn) mma(sc[n], al, bh[n][0], bh[n][1]);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (n < nn) mma(sc[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (n < nn) mma(sc[n], ah, bh[n][0], bh[n][1]);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int j = k0 + 8 * n + 2 * t;
          float* sr = sS + (16 * slab + g + 8 * rh) * lds + j;
          if (n < nn && j < rows) sr[0] = sc[n][2 * rh];
          if (n < nn && j + 1 < rows) sr[1] = sc[n][2 * rh + 1];
        }
    }
  }

  // ---- y = G' @ x: warp (slot, slab) owns rows 16 slab .. + 15 of head
  // slot of each pass; lane (g, t) rows ia = i0 + 16 slab + g and ib = ia + 8
  const int slab = warp & 3, slot = warp >> 2;
  const int ia = i0 + 16 * slab + g, ib = ia + 8, nbn = (P + 7) >> 3;
  const int last = i0 + 16 * slab < q ? min(i0 + 16 * slab + 15, q - 1) : -1;  // warp's last row
  const int ldp = ld_pairs(P);
  uint2* sXp = reinterpret_cast<uint2*>(sP);  // [2][fy][kKeys][ldp]: x split, over the scores' staging
  const int npass = (p.hb + p.fy - 1) / p.fy, nkt = (rows + kKeys - 1) / kKeys;
  const int steps = npass * nkt;
  TileRegs<T, 2 * kKeys / kWarps, NTP / 4> xt;  // x of a tile, on its way to sXp
  auto load_x = [&](int it) {                     // x of the pass's heads, keys of tile it
    const int pass = it / nkt;
    xt.load(x + (h0 + pass * p.fy) * p.x_sh, p.x_ss, p.x_sh, P, (it % nkt) * kKeys, rows,
            min(p.fy, p.hb - pass * p.fy) * kKeys);
  };
  auto nrows = [&](int it) { return min(p.fy, p.hb - it / nkt * p.fy) * kKeys; };
  float acc[NTP][4];
  zero(acc);
  load_x(0);
  __syncthreads();  // the scores are written and their staging is read
  xt.store(sXp, ldp, P, nrows(0));
  if (steps > 1) load_x(1);
  __syncthreads();  // tile 0 in place
  T* y = static_cast<T*>(p.y) + ((size_t)b * p.S + row0) * p.H * P;
  const float* sa = sS + (16 * slab + g) * lds;  // scores of row ia; row ib at + 8 lds
  for (int it = 0; it < steps; ++it) {
    const int pass = it / nkt, kt = it % nkt, j0 = kt * kKeys;
    const int hp = h0 + pass * p.fy, nhp = min(p.fy, p.hb - pass * p.fy);
    if (slot < nhp) {
      const float* cs = sCs + (hp - h0 + slot) * q;
      const float* dth = sDt + (hp - h0 + slot) * q;
      const float csa = ia < q ? cs[ia] : 0.f, csb = ib < q ? cs[ib] : 0.f;
      const uint2* xs = sXp + ((it & 1) * p.fy + slot) * kKeys * ldp + g;
#pragma unroll 1
      for (int s8 = 0; s8 < kKeys && j0 + s8 <= last; s8 += 8) {
        // A = G' at rows ia, ib and keys ja, jc: on and below the diagonal
        // only (no exp of a positive difference), 0 elsewhere
        const int ja = j0 + s8 + t, jc = ja + 4;
        const bool in_a = ia < q, in_b = ib < q;
        const float gaa = in_a && ja <= ia ? sa[ja] * __expf(csa - cs[ja]) * dth[ja] : 0.f;
        const float gba = in_b && ja <= ib ? sa[8 * lds + ja] * __expf(csb - cs[ja]) * dth[ja] : 0.f;
        const float gac = in_a && jc <= ia ? sa[jc] * __expf(csa - cs[jc]) * dth[jc] : 0.f;
        const float gbc = in_b && jc <= ib ? sa[8 * lds + jc] * __expf(csb - cs[jc]) * dth[jc] : 0.f;
        uint32_t ah[4], al[4];
        split_a(gaa, gba, gac, gbc, ah, al);
        mma_row(acc, ah, al, nbn, xs + (s8 + t) * ldp, ldp);
      }
    }
    if (kt == nkt - 1) {
      if (slot < nhp) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int i = rh ? ib : ia;
          if (i >= q) continue;
          T* yr = y + ((size_t)i * p.H + hp + slot) * P;
#pragma unroll
          for (int nb = 0; nb < NTP; ++nb)
            if (nb < nbn) store_pair(yr, 8 * nb + 2 * t, P, acc[nb][2 * rh], acc[nb][2 * rh + 1]);
        }
      }
      zero(acc);
    }
    if (it + 1 < steps) {
      xt.store(sXp + ((it + 1) & 1) * p.fy * kKeys * ldp, ldp, P, nrows(it + 1));
      if (it + 2 < steps) load_x(it + 2);
    }
    __syncthreads();  // tile it + 1 in place; every warp is done with tile it
  }
}

template <typename T, int NTP, int NTN>
int launch(const Params& p, long long blocks, size_t smem, cudaStream_t stream) {
  static bool configured = false;  // once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_intra<T, NTP, NTN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmemBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  ssd_intra<T, NTP, NTN><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// accumulators: 8 column blocks of 8 up to P (y) or N (states) = 64, 16 up to 128
template <typename T>
int launch_width(const Params& p, long long blocks, size_t smem, cudaStream_t stream) {
  if (p.P <= 64) {
    if (p.N <= 64) return launch<T, 8, 8>(p, blocks, smem, stream);
    return launch<T, 8, 16>(p, blocks, smem, stream);
  }
  if (p.N <= 64) return launch<T, 16, 8>(p, blocks, smem, stream);
  return launch<T, 16, 16>(p, blocks, smem, stream);
}

// rows of n elements of elem bytes that load 4 elements at a time: n and the
// strides multiples of 4, the base aligned to 4 elements
bool vector_rows(const void* base, int elem, int n, long long s0, long long s1, long long s2) {
  return n % 4 == 0 && s0 % 4 == 0 && s1 % 4 == 0 && s2 % 4 == 0 &&
         reinterpret_cast<uintptr_t>(base) % (4 * elem) == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y alike); dt, dA, st,
// cd and cs are float32. q (the chunk) in [1, 256] dividing S; N, P in
// [1, 128]; H a multiple of min(8, H). Strides in elements (batch,
// sequence, head for x; batch, sequence for Bm and Cm), last dimensions
// contiguous. cs may be null. Returns the cudaError_t of the launch (0 =
// launched).
int ssd_scan_launch(int dtype, int B, int S, int H, int P, int N, int q,
                    const void* x, long long x_sb, long long x_ss, long long x_sh,
                    const float* dt, const float* dA,
                    const void* bm, long long b_sb, long long b_ss,
                    const void* cm, long long c_sb, long long c_ss,
                    void* y, float* st, float* cd, float* cs, void* stream) {
  const int hb = H < kMaxHeads ? H : kMaxHeads;
  if ((dtype != 0 && dtype != 1) || B < 1 || S < 1 || H < 1 || q < 1 || q > kMaxChunk ||
      S % q != 0 || N < 1 || N > kMaxDim || P < 1 || P > kMaxDim || H % hb != 0)
    return (int)cudaErrorInvalidValue;
  // heads in flight: a y block's 8 warps are 4 slabs of 16 query rows by fy
  // heads; a states block gives each head ceil(P / 16) warps of 16 rows p
  const int fy = hb < 2 ? hb : 2;
  const int fst = hb < kWarps / ((P + 15) / 16) ? hb : kWarps / ((P + 15) / 16);
  const int elem = dtype == 0 ? 4 : 2;
  const int vx = vector_rows(x, elem, P, x_sb, x_ss, x_sh);
  const int vbc = vector_rows(bm, elem, N, b_sb, b_ss, 0) && vector_rows(cm, elem, N, c_sb, c_ss, 0);
  const size_t smem = sizeof(float) * smem_floats(q, N, P, fy, fst);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const int nqt = (q + kTile - 1) / kTile;
  const long long groups = (long long)(H / hb) * (S / q) * B;
  const long long blocks = (long long)(nqt + 1) * groups;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;  // gridDim.x
  Params p{x, x_sb, x_ss, x_sh, dt, dA, bm, b_sb, b_ss, cm, c_sb, c_ss, y, st, cd, cs,
           S, H, P, N, q, hb, nqt, (int)groups, fy, fst, vx, vbc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_width<float>(p, blocks, smem, s);
  return launch_width<__nv_bfloat16>(p, blocks, smem, s);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
