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
// and cd ([B, nc, H]) in float32. Every operation is float32, as in the
// reference: inputs are widened on load, and cs is a float32 sum taken in
// the order of the reference's jnp.cumsum on the CPU (XLA's blocked scan:
// runs of 16 rows in order, the runs' totals in order, each run adding the
// totals before it; the plain version's cumsum_f32 takes the same order).
// exp(cs_i - cs_j) cancels most of cs's magnitude, so at q = 256, where
// |cs| reaches a few hundred, another order's rounding alone moves the
// decay by ~1e-4: this keeps the reference's. The decay is computed only on
// and below the diagonal: above it the difference is positive and grows
// with the chunk, and its exp would overflow (inf * 0 is NaN), so those
// entries are set to 0 without an exp, as jnp.where(tril, exp(diff), 0)
// selects them.
//
// Layout. x is read as [B, S, H, P] and Bm, Cm as [B, S, N] through their
// batch, sequence (and head) strides, the last dimension contiguous; so the
// model's views into its conv output need no copy. dt and dA are
// contiguous float32 [B, S, H]; y is written contiguous.
//
// Work split. The TPU walks a (B, nc, H/8) grid, each cell holding the
// whole q x q score tile of its chunk in VMEM. Here a block of 256 threads
// owns (b, c, a block of hb = min(8, H) heads) and one role:
//  - a y block owns 64 query rows [i0, i0 + 64) of the chunk. It computes
//    the scores C_i . B_j once for its rows and for every key tile up to
//    the diagonal (tiles above it are skipped: that is where the causal
//    half of the work is saved), keeps them in shared memory, then for
//    each of its heads forms G = scores * exp(cs_i - cs_j) (0 above the
//    diagonal) and accumulates G @ (x dt) over 64-row key tiles of x;
//  - the states block computes st and cd of each of its heads over all q
//    rows, in 64-row tiles of x and of B scaled by exp(cs_last - cs) dt.
// The q x q score tile (256 KB at q = 256 in float32, more than an SM's
// shared memory) is so never held whole: a y block holds 64 x q of it.
// One flat grid over (b, c, head block, role), so B is not bounded by a
// grid dimension; blocks are issued longest query tiles first. Each thread accumulates a
// 4 x C (y) or C x C (states) register tile, C = 4 for P, N <= 64 and 8 up
// to 128; rows of shared-memory tiles have odd strides, so the column
// reads of one warp fall in different banks.
//
// Shared memory (float32 whatever the input): cs and dt of the block's
// heads, 8 x q each; the 64 x q score tile; a region holding either the C
// and B tiles of the score pass or G; the 64-row tile of x. At q = 256,
// N = P = 128 that is 180,992 bytes (dynamic shared memory above 48 KB,
// set with cudaFuncSetAttribute); at zamba2-7b's q = 128, N = P = 64,
// 90,880 bytes: two blocks per SM.
//
// What bounds it on an H100: operations. At zamba2-7b's prefill (B = 4,
// S = 1024, H = 112, P = N = 64, q = 128, float32) the causal products
// the step needs (scores once per chunk, G @ (x dt) per head) and the
// chunk states are 7.7 GFLOP, 0.115 ms at 67 TFLOP/s on the CUDA cores,
// against 0.30 GB of x, y, B, C, dt, dA and states (0.09 ms at 3.35
// TB/s). This kernel does more: it recomputes the scores for each block of
// 8 heads and computes its diagonal tiles whole. This first
// kernel runs the products as float32 FMAs on the CUDA cores from shared
// memory, with plain loads; tensor cores (wgmma) and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "../../csrc/dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // query rows of a y block; rows of a key tile
constexpr int kMaxHeads = 8;    // heads of a block (the reference's HB)
constexpr int kMaxChunk = 256;
constexpr int kMaxDim = 128;    // N and P
constexpr int kRun = 16;        // rows per run of the cumulative sum
constexpr unsigned kFull = 0xffffffffu;

using repro_dtypes::load_f;
using repro_dtypes::store_f;

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
  int S, H, P, N, q, hb, nqt;
};

// odd row strides: a warp reading one column of 16 rows hits 16 banks
__host__ __device__ constexpr int odd(int n) { return n | 1; }

__host__ __device__ constexpr size_t smem_floats(int q, int N, int P) {
  return (size_t)2 * kMaxHeads * q + (size_t)kTile * odd(q) +
         ((size_t)kTile * odd(q) > (size_t)2 * kTile * odd(N) ? (size_t)kTile * odd(q)
                                                              : (size_t)2 * kTile * odd(N)) +
         (size_t)kTile * P;
}

constexpr size_t kMaxSmemBytes = sizeof(float) * smem_floats(kMaxChunk, kMaxDim, kMaxDim);

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

template <typename T, int C>
__global__ void __launch_bounds__(kThreads) ssd_intra(const Params p) {
  extern __shared__ float smem[];
  const int q = p.q, N = p.N, P = p.P;
  const int lds = odd(q), ldn = odd(N);
  float* sCs = smem;                        // [kMaxHeads][q]
  float* sDt = sCs + kMaxHeads * q;         // [kMaxHeads][q]
  float* sS = sDt + kMaxHeads * q;          // [kTile][lds] scores
  float* sR = sS + kTile * lds;             // C and B tiles, or G, or B * decay
  float* sX = sR + (kTile * lds > 2 * kTile * ldn ? kTile * lds : 2 * kTile * ldn);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;  // 16 x 16 threads over a register tile

  // blockIdx.x = ((b * nc + c) * nh + head block) * (nqt + 1) + role
  long long idx = blockIdx.x;
  const int role = (int)(idx % (p.nqt + 1));
  idx /= p.nqt + 1;
  const int nh = p.H / p.hb, nc = p.S / q;
  const int h0 = (int)(idx % nh) * p.hb;
  idx /= nh;
  const int c = (int)(idx % nc);
  const long long b = idx / nc;
  const bool states = role == p.nqt;
  const int qt = states ? 0 : p.nqt - 1 - role;  // longest query tiles first
  const int i0 = qt * kTile;
  const int rows = states ? q : min(q, i0 + kTile);  // rows whose cs is needed
  const long long row0 = (long long)c * q;            // the chunk's first row

  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + row0 * p.x_ss;
  const T* bm = static_cast<const T*>(p.bm) + b * p.b_sb + row0 * p.b_ss;
  const T* cm = static_cast<const T*>(p.cm) + b * p.c_sb + row0 * p.c_ss;

  for (int e = tid; e < rows * p.hb; e += kThreads) {
    const int r = e / p.hb, hh = e % p.hb;
    const size_t g = ((size_t)b * p.S + row0 + r) * p.H + h0 + hh;
    sCs[hh * q + r] = p.dA[g];
    sDt[hh * q + r] = p.dt[g];
  }
  __syncthreads();
  if (warp < p.hb) warp_cumsum(sCs + warp * q, rows, lane);
  __syncthreads();

  if (states) {
    float* sB = sR;  // [kTile][ldn]: B_j exp(cs_last - cs_j) dt_j
    for (int hh = 0; hh < p.hb; ++hh) {
      const int h = h0 + hh;
      const float* cs = sCs + hh * q;
      const float* dth = sDt + hh * q;
      const float last = cs[q - 1];
      float acc[C][C];
#pragma unroll
      for (int r = 0; r < C; ++r)
#pragma unroll
        for (int k = 0; k < C; ++k) acc[r][k] = 0.f;
      for (int j0 = 0; j0 < q; j0 += kTile) {
        const int nj = min(kTile, q - j0);
        __syncthreads();  // the previous tile's readers are done
        for (int e = tid; e < nj * N; e += kThreads) {
          const int jj = e / N, n = e % N, j = j0 + jj;
          sB[jj * ldn + n] = load_f(bm, (size_t)(j * p.b_ss + n)) * (expf(last - cs[j]) * dth[j]);
        }
        for (int e = tid; e < nj * P; e += kThreads) {
          const int jj = e / P, pc = e % P;
          sX[jj * P + pc] = load_f(x, (size_t)((j0 + jj) * p.x_ss + h * p.x_sh + pc));
        }
        __syncthreads();
        for (int jj = 0; jj < nj; ++jj) {
          float xv[C], bv[C];
#pragma unroll
          for (int r = 0; r < C; ++r) {
            const int pc = ty + 16 * r;
            xv[r] = pc < P ? sX[jj * P + pc] : 0.f;
          }
#pragma unroll
          for (int k = 0; k < C; ++k) {
            const int n = tx + 16 * k;
            bv[k] = n < N ? sB[jj * ldn + n] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < C; ++r)
#pragma unroll
            for (int k = 0; k < C; ++k) acc[r][k] = fmaf(xv[r], bv[k], acc[r][k]);
        }
      }
      float* st = p.st + (((size_t)b * nc + c) * p.H + h) * P * N;
#pragma unroll
      for (int r = 0; r < C; ++r)
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const int pc = ty + 16 * r, n = tx + 16 * k;
          if (pc < P && n < N) st[(size_t)pc * N + n] = acc[r][k];
        }
      if (tid == 0) p.cd[((size_t)b * nc + c) * p.H + h] = expf(last);
    }
    return;
  }

  // ---- a y block: scores of rows [i0, i0 + kTile) against keys [0, rows)
  float* sC = sR;                // [kTile][ldn]
  float* sB = sR + kTile * ldn;  // [kTile][ldn]
  for (int e = tid; e < kTile * N; e += kThreads) {
    const int r = e / N, n = e % N, i = i0 + r;
    sC[r * ldn + n] = i < q ? load_f(cm, (size_t)(i * p.c_ss + n)) : 0.f;
  }
  for (int j0 = 0; j0 < rows; j0 += kTile) {
    __syncthreads();  // sC written; the previous B tile's readers are done
    for (int e = tid; e < kTile * N; e += kThreads) {
      const int jj = e / N, n = e % N, j = j0 + jj;
      sB[jj * ldn + n] = j < q ? load_f(bm, (size_t)(j * p.b_ss + n)) : 0.f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[r][k] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = sC[(ty + 16 * r) * ldn + n];
#pragma unroll
      for (int k = 0; k < 4; ++k) bv[k] = sB[(tx + 16 * k) * ldn + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) s[r][k] = fmaf(cv[r], bv[k], s[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + tx + 16 * k;
        if (j < rows) sS[(ty + 16 * r) * lds + j] = s[r][k];
      }
  }

  float* sG = sR;  // [kTile][lds], over the C and B tiles once the scores are done
  for (int hh = 0; hh < p.hb; ++hh) {
    const int h = h0 + hh;
    const float* cs = sCs + hh * q;
    const float* dth = sDt + hh * q;
    __syncthreads();  // scores done; the previous head's readers of sG are done
    for (int e = tid; e < kTile * rows; e += kThreads) {
      const int r = e / rows, j = e % rows, i = i0 + r;
      // on and below the diagonal only: no exp of a positive difference
      sG[r * lds + j] = (i < q && j <= i) ? sS[r * lds + j] * expf(cs[i] - cs[j]) : 0.f;
    }
    float acc[4][C];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < C; ++k) acc[r][k] = 0.f;
    for (int j0 = 0; j0 < rows; j0 += kTile) {
      const int nj = min(kTile, rows - j0);
      __syncthreads();  // sG written; the previous x tile's readers are done
      for (int e = tid; e < nj * P; e += kThreads) {
        const int jj = e / P, pc = e % P;
        sX[jj * P + pc] =
            load_f(x, (size_t)((j0 + jj) * p.x_ss + h * p.x_sh + pc)) * dth[j0 + jj];
      }
      __syncthreads();
      for (int jj = 0; jj < nj; ++jj) {
        float gv[4], xv[C];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = sG[(ty + 16 * r) * lds + j0 + jj];
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const int pc = tx + 16 * k;
          xv[k] = pc < P ? sX[jj * P + pc] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < C; ++k) acc[r][k] = fmaf(gv[r], xv[k], acc[r][k]);
      }
    }
    T* y = static_cast<T*>(p.y);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      if (i >= q) continue;
      const size_t base = (((size_t)b * p.S + row0 + i) * p.H + h) * P;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int pc = tx + 16 * k;
        if (pc < P) store_f(y, base + pc, acc[r][k]);
      }
    }
  }
}

template <typename T, int C>
int launch(const Params& p, long long blocks, cudaStream_t stream) {
  static bool configured = false;  // once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_intra<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmemBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const size_t smem = sizeof(float) * smem_floats(p.q, p.N, p.P);
  ssd_intra<T, C><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(const Params& p, long long blocks, cudaStream_t stream) {
  if (p.P <= 64 && p.N <= 64) return launch<T, 4>(p, blocks, stream);
  return launch<T, 8>(p, blocks, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y alike); dt, dA, st and
// cd are float32. q (the chunk) in [1, 256] dividing S; N, P in [1, 128];
// H a multiple of min(8, H). Strides in elements (batch, sequence, head for
// x; batch, sequence for Bm and Cm), last dimensions contiguous. Returns
// the cudaError_t of the launch (0 = launched).
int ssd_scan_launch(int dtype, int B, int S, int H, int P, int N, int q,
                    const void* x, long long x_sb, long long x_ss, long long x_sh,
                    const float* dt, const float* dA,
                    const void* bm, long long b_sb, long long b_ss,
                    const void* cm, long long c_sb, long long c_ss,
                    void* y, float* st, float* cd, void* stream) {
  const int hb = H < kMaxHeads ? H : kMaxHeads;
  if (B < 1 || S < 1 || H < 1 || q < 1 || q > kMaxChunk || S % q != 0 || N < 1 ||
      N > kMaxDim || P < 1 || P > kMaxDim || H % hb != 0)
    return (int)cudaErrorInvalidValue;
  const int nqt = (q + kTile - 1) / kTile;
  const long long blocks = (long long)(nqt + 1) * (H / hb) * (S / q) * B;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;  // gridDim.x
  Params p{x, x_sb, x_ss, x_sh, dt, dA, bm, b_sb, b_ss, cm, c_sb, c_ss, y, st, cd,
           S, H, P, N, q, hb, nqt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_width<float>(p, blocks, s);
  if (dtype == 1) return launch_width<__nv_bfloat16>(p, blocks, s);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
