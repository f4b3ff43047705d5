"""What one call of each kernel must do: its FLOPs and the bytes it must
move (each input read once, each output written once), and the peak it
runs at. The wrappers declare it to an active recorder
(``utils.trace``) at every call, on every device, and ``chip_smoke.py``
prices its bounds with the same formulas.

dp_mix's bound on the card has a third term, its lane-instructions a
normal (counted from the built library's SASS), which stays in
``chip_smoke.py``: here dp_mix declares its bytes and its mix's fused
multiply-adds.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import NamedTuple, Optional

from repro_torch.utils.roofline import (BF16_TC_FLOP_PER_S, F32_FLOP_PER_S,
                                        HBM_BYTES_PER_S, TF32_TC_FLOP_PER_S)

_CLASS_OF_RATE = {F32_FLOP_PER_S: "f32", TF32_TC_FLOP_PER_S: "tf32",
                  BF16_TC_FLOP_PER_S: "bf16"}

# float operations per element of csrc/dp_perturb.cu: the local step's FMA
# (2); noisy, also the two uniforms (4), -2 log, sqrt, 2 pi u2, r cos, the
# noise scale and the final FMA (7), and libdevice's logf and cosf at
# about 20 and 25 operations (hash excluded)
PERTURB_FLOPS, PERTURB_NOISY_FLOPS = 2, 58


class Work(NamedTuple):
    """What one call of a kernel needs and does: ``flops``, the function's
    operations; ``nbytes``, its inputs read once and its outputs written
    once; ``rate``, the peak of the kernel's route; ``kernel_flops``, the
    route's own products (3 TF32 products for each float32 one; in
    bfloat16 flash's P v twice, for P_hi and P_lo)."""
    flops: int
    nbytes: int
    rate: float
    kernel_flops: int

    @property
    def bound_s(self) -> float:
        """The least time the card could take: the longer of the bytes
        over HBM's rate and the operations over the route's peak."""
        return max(self.nbytes / HBM_BYTES_PER_S, self.flops / self.rate)

    @property
    def bound_by(self) -> str:
        return ("bytes" if self.nbytes / HBM_BYTES_PER_S >= self.flops / self.rate
                else "operations")

    @property
    def compute_class(self) -> str:
        """The roofline's compute class of ``rate`` (utils.roofline)."""
        return _CLASS_OF_RATE[self.rate]


def kept_pairs(S: int, window: Optional[int] = None) -> int:
    """(query, key) pairs of one causal [S, S] score tile that the mask
    keeps: key <= query, and query - key < window where there is one."""
    w = S if window is None else min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def flash_work(B: int, S: int, H: int, Hkv: int, hd: int, elem: int,
               window: Optional[int] = None, causal: bool = True) -> Work:
    """Work of one flash_attention call at (B, S, H, Hkv, hd) with
    elements of ``elem`` bytes (4: float32 on split TF32; 2: bfloat16 on
    wgmma): 2 products of 2 hd operations per (query, key) pair the mask
    keeps (every pair without ``causal``); q, k, v read once and o
    written once."""
    pairs = kept_pairs(S, window) if causal else S * S
    flops = 4 * hd * pairs * B * H
    nbytes = (2 * B * S * H * hd + 2 * B * S * Hkv * hd) * elem
    if elem == 2:
        return Work(flops, nbytes, BF16_TC_FLOP_PER_S, flops * 3 // 2)
    return Work(flops, nbytes, TF32_TC_FLOP_PER_S, 3 * flops)


def ssd_work(shape, elem: int) -> Work:
    """Work of the SSD intra-chunk step at ``shape`` = (B, S, H, P, N, q)
    with x, Bm, Cm of ``elem`` bytes, as the scan launches it (with cs).
    Bytes: x, Bm, Cm, dt, dA read once; y, states, cdecay and cs written
    once. Operations, over the q (q + 1) / 2 causal pairs (i, j <= i) of
    each chunk: the scores C_i . B_j once per chunk, as Bm and Cm are one
    group shared by all heads (2N); per head the decay (subtract, exp,
    multiply: 3) and G @ (x dt) (2P); per row and head x dt (P), B
    exp(cs_last - cs) dt (N + 3) and the states' product (2PN); per chunk
    and head exp(cs_last). The route is split TF32 on the tensor cores:
    its own work is three TF32 products for each of the products (the
    scores, G @ (x dt), the states)."""
    B, S, H, P, N, q = shape
    nc = S // q
    pairs = q * (q + 1) // 2
    products = B * nc * (pairs * 2 * N + H * (pairs * 2 * P + q * 2 * P * N))
    flops = B * nc * (pairs * 2 * N
                      + H * (pairs * (3 + 2 * P) + q * (P + N + 3 + 2 * P * N) + 1))
    nbytes = (elem * (2 * B * S * H * P + 2 * B * S * N)
              + 4 * (3 * B * S * H + B * nc * H * P * N + B * nc * H))
    return Work(flops, nbytes, TF32_TC_FLOP_PER_S, 3 * products)


def perturb_work(numel: int, elem: int, noisy: bool, outputs: int = 2) -> Work:
    """Work of dp_perturb over ``numel`` elements of ``elem`` bytes: p and
    g read, ``outputs`` written (x alone for sgd_update, x and x~ for
    dp_perturb); PERTURB_FLOPS an element, PERTURB_NOISY_FLOPS with the
    noise, on the CUDA cores."""
    flops = numel * (PERTURB_NOISY_FLOPS if noisy else PERTURB_FLOPS)
    nbytes = (2 + outputs) * numel * elem
    return Work(flops, nbytes, F32_FLOP_PER_S, flops)


def dp_mix_bytes(N: int, d: int, elem: int) -> int:
    """dp_mix's bytes at [N, d]: p, g read and out written once
    (``elem`` bytes each), W and the vectors (float32)."""
    return 3 * N * d * elem + (N * N + 4 * N + 4) * 4


def dp_mix_fmas(N: int, d: int) -> int:
    """The mix's fused multiply-adds: N of them an element."""
    return N * N * d


# dp_mix's column route on an H100, csrc/dp_mix.cu's columns_route with the
# card's figures (cudaDevAttrMaxSharedMemoryPerMultiprocessor, ...PerBlockOptin,
# ReservedSharedMemoryPerBlock) in place of the device query, so a wrapper
# declares the same work on the CPU, on meta and on the card (chip_smoke.py
# holds this predicate to the C launch's route at every N up to 256)
H100_SMEM_PER_SM, H100_SMEM_PER_BLOCK, H100_SMEM_RESERVED = 233_472, 232_448, 1_024
_DP_MIX_CU = Path(__file__).resolve().parent / "dp_mix" / "csrc" / "dp_mix.cu"


def _cu_constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# the route's block as dp_mix.cu defines it: kThreads threads of kCols
# columns, at least kMinWarps warps an SM
COLUMN_THREADS, COLUMN_COLS, COLUMN_MIN_WARPS = (
    _cu_constant(_DP_MIX_CU.read_text(), n)
    for n in ("kThreads", "kCols", "kMinWarps"))


def dp_mix_columns_smem(N: int) -> int:
    """The column route's shared memory at N receivers, noisy (dp_mix.cu's
    columns_smem_bytes): the receivers' constants, W transposed with rows
    padded to 4, z and v of the block's columns."""
    np_ = -(-N // 4) * 4
    return 16 * N + 4 * (N * np_ + 2 * N * COLUMN_THREADS * COLUMN_COLS)


def dp_mix_columns_route(N: int) -> bool:
    """Whether an H100 runs dp_mix at N on its column route (N <= 50), not
    the large-N route."""
    nbytes = dp_mix_columns_smem(N)
    return (nbytes <= H100_SMEM_PER_BLOCK
            and H100_SMEM_PER_SM // (nbytes + H100_SMEM_RESERVED)
            * (COLUMN_THREADS // 32) >= COLUMN_MIN_WARPS)


def dp_mix_work(N: int, d: int, elem: int, R: int = 1) -> Work:
    """dp_mix's declared work for R rounds at [N, d]: its bytes and its
    mix's FMAs (2 operations each), on the route an H100 takes at N: the
    column route's on the CUDA cores, the large-N route's on the tensor
    cores in split TF32 (its own work three TF32 products a product)."""
    flops = 2 * R * dp_mix_fmas(N, d)
    nbytes = R * dp_mix_bytes(N, d, elem)
    if dp_mix_columns_route(N):
        return Work(flops, nbytes, F32_FLOP_PER_S, flops)
    return Work(flops, nbytes, TF32_TC_FLOP_PER_S, 3 * flops)


def sparse_bytes(N: int, d: int, k: int, elem: int) -> int:
    """The sparse round's bytes at [N, d] with a k-slot neighbor list: p
    and g read, out written once, the list (idx, w) and the vectors."""
    return 3 * N * d * elem + N * k * 8 + 6 * N * 4 + 16


def sparse_fmas(N: int, d: int, nnz: int) -> int:
    """The sparse mix's fused multiply-adds: the realized slots and the
    self term, (nnz + N) d."""
    return (nnz + N) * d


def sparse_work(N: int, d: int, k: int, elem: int, nnz: Optional[int] = None,
                R: int = 1) -> Work:
    """The sparse round's declared work for R rounds; ``nnz`` (the
    realized slots) defaults to every slot, N k: a wrapper declares it
    without reading the list back to the host."""
    nnz = N * k if nnz is None else nnz
    flops = 2 * R * sparse_fmas(N, d, nnz)
    return Work(flops, R * sparse_bytes(N, d, k, elem), F32_FLOP_PER_S, flops)


def prep_rows_work(Nb: int, d: int, elem: int) -> Work:
    """A worker shard's first half: p, g read (``elem``), the float32
    workspace [2, Nb, d] written; no product."""
    return Work(0, 2 * Nb * d * elem + 8 * Nb * d, F32_FLOP_PER_S, 0)


def gather_rows_work(Nb: int, d: int, k: int, elem: int) -> Work:
    """A worker shard's second half: p, g and out (``elem``), its
    workspace and the k gathered rows of z a receiver (float32), the
    list; the mix's (Nb k + Nb) d FMAs."""
    flops = 2 * (Nb * k + Nb) * d
    nbytes = 3 * Nb * d * elem + 4 * Nb * d * (2 + k) + Nb * k * 8
    return Work(flops, nbytes, F32_FLOP_PER_S, flops)
