#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. device  — the card's name, count, and nvidia-smi's name and power limit;
2. build   — every CUDA kernel of the driven paths (dp_mix, dp_perturb,
             flash_attention, ssd_scan) built from this checkout's sources
             with nvcc for sm_90a, all nvcc processes at once; ptxas's
             registers and spills, and the SASS holding each tensor-core
             route (flash_attention: HGMMA for bfloat16, HMMA .TF32 for
             float32; ssd_scan: HMMA .TF32; dp_mix's large-N mix:
             HGMMA .TF32); the instructions of one
             dp_mix normal on each of its branches, from the SASS of a
             small library built from the checkout's noise.cuh;
3. kernels — each kernel held against its plain PyTorch version on the
             card at its path's shapes, with the tolerance stated below,
             then timed with CUDA events beside the plain version, the one
             PyTorch call that computes the same function where there is
             one (library_ms), and the least time the card could take
             (bound_ms). Every one of noise.cuh's 2^24 lattice normals
             bitwise the plain generator's. dp_mix timed at the path's
             shape in float32 and bfloat16, noisy and gossip; also at N =
             64, 65, 128 and 256 (all but 65 timed), at the largest N of
             its column route and the next (the largest timed; 50 and 51
             on an H100), and at N = 2048 over three column windows
             (timed, beside the plain version over the whole round in
             2^16-column windows and torch.matmul(W, z) in float32, a
             yardstick of the mix alone that the port never calls), all
             at the path's d, its two noise fields bitwise the plain
             version's at N = 10 and 128, and its bound the longest of
             its bytes, its instructions and its mix's operations on the
             route N takes (the column route's FMAs at the CUDA cores'
             peak, the large-N route's at the TF32 tensor cores'), the
             large-N route's also beside the CUDA-core bound; the
             large-N route's split-TF32 precision at N = 2048 (ring and
             complete graph) against the exact round in float64, within
             sqrt(N) 2^-23 scale (dp_mix_split_tolerance), a bound that
             one TF32 pass in place of three breaks on the ring;
             dp_mix under the dynamic network's plans: a
             churned iot_dense round's (identity rows of W with listen =
             0 beside a Metropolis W), sampled participation's (half of
             self_scale 0) and a ring's (a sparse W), at the path's shape
             in float32 and bfloat16, the dynamic one also at N = 50 and
             51 (both routes), the rows with listen = 0 within 1 ULP of
             the plain version's p - gamma g; the sparse round
             (neighbor-list mixing: dp_mix_prep + dp_mix_gather) at the
             worker-scale path's shape (N = 2048, d = 855,050, a
             mesh_sparse round's list capped at k = 12) in float32 and
             bfloat16, noisy and gossip, against its plain twin over three
             column windows, float32 noisy timed beside the twin over the
             whole round and its bound (sparse_work); with zero weights
             bitwise the dense kernel's round at N = 64 (col0 0 and 4096)
             and 2048, and the list against SparseW.dense() through the
             dense kernel at N = 64;
4. train   — the flat path, ``python -m repro_torch.launch.train --arch
             dwfl-paper --flat-buffer`` at full width (N = 10 workers,
             batch 32, d = 855,050), 51 rounds, its chunks CUDA graph
             replays after the first; every loss finite and dp_mix's
             kernel once a round in the run's profiler trace; the same
             CLI at N = 128 (the large-N route), 5 rounds, its two
             kernels once a round; one small
             flat round on the card against the same round on the CPU;
             the flat CLI on the dynamic network (``--channel-model
             dynamic --scenario iot_dense``, N = 10, 51 rounds): dp_mix
             once a round in its trace, every loss finite, the per-round epsilon
             trajectory over every round; vehicular under a total budget
             (``--total-epsilon 8 --accountant rdp``), 5 rounds; one small
             dynamic flat round on the card against the CPU's from the same
             replayed channel, W and seed; the worker-scale CLI
             (``--channel-model dynamic --scenario mesh_sparse
             --sparse-neighbors 12 --workers 2048``, 5 rounds): one sparse
             dp_mix call a round and no dense one, its rounds/s and peak
             device memory;
5. tree    — the worker-tree path, ``make_train_step(DWFL_PAPER,
             ProtocolConfig(scheme=..., use_pallas=True))`` through the
             trajectory body at full width for each of dwfl, gossip,
             orthogonal and centralized, 11 rounds each; every loss and
             parameter finite and dp_perturb's sgd_update_leaves launched
             once per round (all six leaves in one launch); the CLI's
             worker-tree run with and without --no-scan; one small tree
             round on the card against the same round on the CPU with the
             same normals; the dynamic tree round
             (``make_dynamic_train_step``, drone_sparse, use_pallas=True)
             11 rounds, one dp_perturb launch a round; one warm dynamic
             flat round under ``torch.cuda.set_sync_debug_mode("error")``:
             sim.round, its plan and the dp_mix call synchronize nothing;
             the same for the sparse round at N = 2048 (its round body at
             N = 64); the sparse dynamic tree round (mesh_sparse, N = 64,
             use_pallas=True) 11 rounds, one dp_perturb launch a round;
             in turns at N = 2048, the sparse round against the dense
             large-N route and the simulator's sparse round against its
             dense one; then the fleet and telemetry: dp_mix's replicate
             axis (one launch over [R, N, d]) bitwise R separate launches
             and within tolerance of the plain twin at (R 8, N 10, d =
             855,050) in float32 and bfloat16 (column route) and (R 4,
             N 64) (large-N route), timed in turns with the separate
             launches beside its bound; the fleet CLI (``--channel-model
             dynamic --scenario vehicular --replicates 8 --flat-buffer``,
             N = 10, full width, 101 rounds) under its sync guard, one
             dp_mix launch a round for all 8; the fleet's tree round (R 8,
             use_pallas) under the guard, one dp_perturb launch a round;
             launches per fleet round at R = 2 and R = 8 under
             torch.profiler (equal); the single dynamic round and the R 8
             fleet round in turns; the static and iot_dense flat CLI with
             a run log (telemetry on) read back by ``obs.report``, and
             its rounds/s with telemetry on and off in turns; the sweep
             (``python -m repro_torch.fleet.sweep``, 8 cells, 5 steps),
             its rows with the reference's keys; the fleet's sparse round
             (R = 4 networks of N = 512 on mesh_sparse, k = 12): the
             sparse kernels' replicate axis (one dp_mix_prep and one
             dp_mix_gather over [4, 512, 855,050]) bitwise 4 separate
             launches, within tolerance of the plain twin, timed in turns
             with them beside its bound; the fleet sparse CLI
             (``--replicates 4 --workers 512 --sparse-neighbors 12``, 6
             rounds) under its sync guard, one sparse call a round and no
             dense one, and one prep and one gather kernel a round under
             torch.profiler; a reduced fleet sparse round card against
             CPU; then the chunk executor (``ChunkRunner``, the
             reference's): on each of GRAPH_PATHS (the static flat round
             with and without telemetry, the tree round with use_pallas,
             the dynamic flat and tree rounds, the fleet at R = 8, the
             sparse round at N = 2048) two K-round chunks as CUDA graph
             replays bitwise the same chunks through run_chunk (the
             parameters, generator state, network state, epsilon moments
             and every output), one capture a length, each kernel as many
             launches in a replay's profiler trace as in an eager
             chunk's (the counted CLI runs above are traced the same
             way: a replay runs no Python, so a wrapper counts only its
             eager and captured rounds); rounds/s with and
             without the graph in turns (the static flat CLI at its
             defaults, the static flat round with and without
             telemetry, the dynamic flat, tree, fleet and sparse rounds,
             the last with its peak memory); then the LM rounds through
             the runner (``graph_lm``: olmo-1b's tree round at full depth
             on N = 2 and flat round on 4 of 16 layers on N = 4, each one
             CUDA graph of a round replayed for a chunk's rounds, held
             to two eager runs of the same chunks, themselves held to
             each other, records on the host; B2 or B1 once a round in a
             replay's trace; ms a round and peak memory with and without
             the graph in turns); then sharding and
             checkpoints: dp_mix over the model axis's S = 2 and
             4 column windows (logical, one card: one launch over the
             padded buffer) bitwise the one launch over the unpadded
             buffer, each window within tolerance of its twin and its own
             launch at its col0 bitwise its columns, timed on the device
             by CUDA graphs in turns with the unpadded call; the static and dynamic sharded steps bitwise the
             unsharded ones at full width; the flat CLI with
             ``--model-shards 2 --checkpoint`` (10 rounds, one launch a
             round), bitwise the unsharded CLI, and its checkpoint resumed
             for 10 more rounds bitwise the 20-round run; the worker
             axis's S = 2 row windows at the worker-scale shape
             (dp_mix_prep_rows, z gathered by hand, dp_mix_gather_rows)
             bitwise the whole sparse round, within tolerance of the
             twins, timed beside it, with its peak memory; and on a
             one-rank NCCL group the model-axis mesh step, the (1, 1)
             fleet mesh round and the worker-axis trajectory at N = 2048
             (its row-window launches counted), each bitwise its logical
             or unsharded twin; the model-axis and worker-axis
             trajectories with telemetry on, on their one-rank groups,
             rows and carry.eps bitwise the logical mode's, and
             telemetry's cost on them in turns; the model-axis round
             without and with telemetry and the (1, 1) fleet through
             ChunkRunner on those groups (``graph_mesh``: their NCCL
             collectives captured, held as ``graph_lm`` holds the LM
             rounds, ms a round in turns); with two cards (and alone
             with ``--two-cards``), the CLI at --model-shards 2 and
             --worker-shards 2 on two torchrun-style ranks against the
             logical and unsharded runs, each with a run log that rank 0
             alone writes, each through ChunkRunner's graph (chunks of
             2: its NCCL collectives captured), and the library check
             on two NCCL ranks (``mesh_graph_phase``: one all_reduce
             captured; the model axis, the fleet and the worker axis,
             the graph bitwise run_chunk, one capture, NCCL's kernels
             and B1's in a replay's trace, ms a round in turns), every
             rank under a hang watchdog;
             the static and the dynamic flat round and the simulator's
             round timed in turns, and the flat CLI, static and dynamic,
             warm and without evals, in turns;
6. serve   — gemma-2b at full width (2,506,172,416 parameters, random
             from a seed): the serve CLI as the reference runs it
             (``--arch gemma-2b --full``: batch 4, prompt 64, gen 32, no
             kernel), then the serve driver with ``use_pallas=True`` at
             batch 4, prompt 1024, gen 32: logits finite, flash_attention
             launched 18 times in the prefill (once per layer) and never
             in a decode step, the prefill's logits against those without
             the kernel, prefill and decode tokens/s and peak device
             memory; then the same parameters cast to bfloat16 (about 5.0
             GB) with ``param_dtype`` and ``compute_dtype`` bfloat16, as
             the reference's pod dry-run sets them, served the same way:
             18 launches of the bfloat16 (tensor-core) flash kernel in the
             prefill, none per decode step, the logits against the
             bfloat16 prefill without the kernel, tokens/s and peak
             memory; one reduced gemma-2b prefill and decode on the card
             against the same on the CPU;
7. profile — the steady-state time of a full-width round of each training
             path (the static flat and tree rounds and the dynamic flat
             round, and the simulator's round alone; the rounds in turns
             again, after serving), and under
             torch.profiler the device's busy share and the operators that
             take the device's and the host's time, for those rounds and
             for one full-width prefill and decode step, in float32 and in
             bfloat16; then the decode graph (``decode_graph_phase``, each
             after a ``[predict]`` line): the decode through
             ``serve.DecodeRunner`` (one CUDA graph of the step, its first
             step eager) against the eager ``decode_step`` in turns (graph,
             eager, eager, graph: the runner's two waves, the second all
             replays) from one prefilled cache at batch 4, prompt 1024,
             31 greedy steps: every turn's logits, tokens and cache leaves
             bitwise the first eager turn's, one capture, no kernel of the
             repo in a replay's device trace or an eager step's (none
             counted), the ms a step after the first two beside the
             floor (the weights' bytes over the HBM rate), tokens/s and
             peak memory; gemma-2b in float32 and bfloat16, and
             gemma-2b-sw4096 (the same weights) from a prompt of its 4096
             window, its cache a ring, decoding past the window; and the
             serve driver (its decode a DecodeRunner) against the eager
             greedy loop, the same tokens and logits bitwise;
8. zamba2  — zamba2-7b at full width and depth (81 layers, 6,751,130,832
             parameters, random from a seed; gemma-2b's freed first): the
             serve CLI as the reference runs it (``--arch zamba2-7b
             --full``, no kernel), then the serve driver with
             ``use_pallas=True`` at batch 4, prompt 1024, gen 32: logits
             finite, ssd_scan launched 81 times in the prefill (once per
             Mamba2 layer), never in a decode step, flash_attention never;
             the prefill's logits against those without the kernel, prefill
             and decode tokens/s and peak device memory; a reduced zamba2
             prefill and decode on the card against the same on the CPU;
             the profile of one prefill and one decode step; its decode
             graph;
9. zoo     — the MoE, xLSTM and encoder-decoder families, whose paths
             launch no kernel (the reference hands ``use_pallas`` to
             nothing there): every run counted at zero launches of every
             kernel wrapper. deepseek-moe-16b at full width and depth in
             float32 (16,375,728,128 parameters; zamba2-7b's freed
             first): the serve CLI (``--arch deepseek-moe-16b --full``),
             the serve driver with ``use_pallas=True`` at batch 4, prompt
             1024, gen 32, and the profile of one prefill and one decode
             step; qwen3-moe-235b-a22b at full width on 2 of its 94 layers
             (6,220,173,312 parameters; the cache's dense part None): the
             driver at batch 4, prompt 64; xlstm-1.3b at full width and
             depth (2,875,433,296): the CLI, the driver at batch 4,
             prompt 1024 (8 mLSTM chunks a layer, the sLSTM loop over 1024
             steps) and the prefill's time in the sLSTM blocks against the
             mLSTM blocks; whisper-medium at full width and depth
             (826,647,552): the CLI (1500 encoder frames, prompt 64,
             prefill logits [4, 64, 51865]) and the driver; each model
             freed before the next, each with finite logits, prefill and
             decode tokens/s and peak device memory, and each one's decode
             graph (qwen3's at prompt 1024, whisper's at 64); then each of
             the four at reduced() on the card against the CPU;
10. lm      — LM training through the DWFL round (the reference's
             ``loss_fn`` passes no ``use_pallas``, so B1 and B2 are its
             kernels): olmo-1b at full width (d_model 2048, 16 heads, d_ff
             8192, vocab 50,304), float32, batch 4 x 128 a worker, random
             from a seed. The worker-tree round at full depth
             (1,176,764,416 parameters a worker) on N = 2,
             ``make_train_step(ProtocolConfig(scheme="dwfl",
             use_pallas=True))`` through the trajectory body, 4 rounds:
             losses finite, one sgd_update_leaves launch a round over the
             8 leaves, the peak, then 2 rounds under torch.profiler (busy
             share, top operators); the flat round on N = 4 with the depth
             cut to 4 of 16 layers (d = 371,458,048: C2, N roundup(d, 128)
             <= 2^31, lets the full depth have N = 1 alone), 4 rounds: one
             dp_mix launch a round, then 2 profiled; dp_mix at that shape against its plain
             twin on three column windows and timed beside its bound and
             the twin over the whole round in 2^22-column windows;
             sgd_update_leaves at olmo-1b's leaves (N = 2) against the
             per-leaf kernel and the plain version, timed beside its bound
             and ``torch._foreach_add``; the CLI (``--arch olmo-1b
             --workers 2 --batch-size 4 --seq-len 128 --steps 3``, the
             tree path through ChunkRunner's one-round graph, no kernel)
             and its ``--flat-buffer`` run refused
             by C2; a reduced olmo-1b round, flat and tree, on the card
             against the CPU.

11. tooling — the launch tooling and the static checks (ROADMAP A16, A17):
             repro_torch.analysis on the card over the 8 programs one
             card builds at dwfl-paper's width (0 ERROR findings; dp_mix
             or its sparse round launched once a round; the counter
             ranges of the key check), op_cost of dwfl-paper's static flat
             round (N = 10, batch 32) and olmo-1b's tree round (full
             depth, N = 2, batch 4 x 128) on the meta device equal to the
             card's, each round's roofline bound (utils.roofline) beside
             its ms in turns, olmo-1b's argument bytes on meta against the
             card's allocation and the recorders' peaks against
             torch.cuda.max_memory_allocated, the batched serving
             example's loop at gemma-2b's full width for two waves, and
             last the dry run (``python -m repro_torch.launch.dryrun
             --both-meshes``, 33 pairs on each mesh, one process a core
             but one) with the card idle: every pair OK.
12. examples — the user-facing entry points (``examples/port_*.py``,
             ``scripts/port_dev_smoke.py``), each through its ``main``:
             the quickstart at its defaults (N = 10, d = 21,258, 301
             rounds): dp_mix launched once a round and no other kernel,
             the last round's output within dp_mix_tolerance of the plain
             twin on the same inputs, the eval accuracy at round 300 at
             least 0.20 and above round 0's, and the whole run again on
             the CPU from the card's draws (its init, noise seeds and
             batches): the buffer within the rounds' dp_mix tolerances
             added up and the accuracies within two eval samples; the
             dynamic quickstart (iot_dense, 151 rounds)
             and the fleet quickstart (R 8 x N 8, 30 rounds), every round
             under the round guards (no host read, no kernel build after
             round 0, the same device operations every round); the scheme
             comparison at its defaults (4 schemes x 250 steps, eps 0.5 a
             round), its us/step and the Figs. 5 and 6 lines; the LM
             driver at ``--size 100m --steps 20`` (128,994,048 parameters
             a worker, 4 workers): every loss finite, rounds/s, tokens/s
             and peak memory, its checkpoint restored bitwise; the dev
             smoke over every reduced arch: finite losses, gradients and
             decode logits. The tree paths launch no kernel (counted).

The H100's peaks and the kernels' work formulas are the package's
(``repro_torch.utils.roofline``, ``repro_torch.kernels.work``).
Each phase of the dynamic network, of the fleet, of the zoo, of LM training, of the tooling and of the examples is preceded
by a ``[predict]`` line, what it was expected to show (PREDICTIONS). The last three lines of standard
output are the kernels' JSON record, the nvidia-smi line, and {"ok": true,
"device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
if (SRC / "repro_torch").is_dir() and str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

# the H100's peaks (utils.roofline) and the kernels' work formulas
# (kernels.work) are the package's; without the checkout main() fails first
try:
    from repro_torch.kernels.work import (PERTURB_FLOPS,  # noqa: F401
                                          PERTURB_NOISY_FLOPS, Work,
                                          dp_mix_bytes, dp_mix_fmas,
                                          flash_work, kept_pairs,
                                          perturb_work, sparse_bytes,
                                          sparse_fmas, ssd_work)
    from repro_torch.kernels.work import dp_mix_work as declared_dp_mix_work
    from repro_torch.kernels.work import (
        dp_mix_columns_route as work_columns_route)
    from repro_torch.utils.roofline import (BF16_TC_FLOP_PER_S,  # noqa: F401
                                            F32_FLOP_PER_S, HBM_BYTES_PER_S,
                                            TF32_TC_FLOP_PER_S)
except ImportError:
    pass
# dp_mix's instructions besides its normals, per element, counted from
# csrc/dp_mix.cu's arithmetic: the local step (2), nf, z and v (7; gossip:
# v alone, 1), the output's fused multiply-add and the mix's N of them.
# The loads and the store are priced by the byte term, not here; a
# normal's own count comes from the SASS (noise_instructions).
def dp_mix_element_ops(N: int, noisy: bool) -> int:
    return 2 + (7 if noisy else 1) + 1 + N


# One normal of dp_mix on each branch, from the checkout's csrc/noise.cuh:
# each kernel loads, runs one piece and stores, and its instructions up to
# EXIT less k_empty's are the piece's (k_small, k_large: hash, t, one
# log1p branch, the central polynomial and the scale; k_central, k_tail:
# the two polynomials alone). k_lattice draws every one of the 2^24
# lattice normals (t takes bits >> 8 alone) for check_lattice_normals.
NOISE_COUNT_SRC = r"""
#include "{header}"
using namespace repro_noise;
extern "C" __global__ void k_lattice(float* y) {{
  const unsigned k = blockIdx.x * 256 + threadIdx.x;
  y[k] = normal_from_bits((k << 8) | 0x5Au);
}}
extern "C" int lattice_launch(float* y, void* stream) {{
  k_lattice<<<65536, 256, 0, (cudaStream_t)stream>>>(y);
  return (int)cudaGetLastError();
}}
__device__ __forceinline__ float normal_on(unsigned idx, unsigned seed, bool small) {{
  const float t = lattice_t(hash_bits(idx, seed)), x = __fmul_rn(t, -t);
  const float w = -(small ? log1p_small(x) : log1p_large(x));
  return __fmul_rn(__fmul_rn(erfinv_central(w), t), 1.41421356237309515f);
}}
extern "C" __global__ void k_empty(const unsigned* b, float* y, unsigned s) {{
  y[threadIdx.x] = __uint_as_float(b[threadIdx.x]);
}}
extern "C" __global__ void k_small(const unsigned* b, float* y, unsigned s) {{
  y[threadIdx.x] = normal_on(b[threadIdx.x], s, true);
}}
extern "C" __global__ void k_large(const unsigned* b, float* y, unsigned s) {{
  y[threadIdx.x] = normal_on(b[threadIdx.x], s, false);
}}
extern "C" __global__ void k_central(const unsigned* b, float* y, unsigned s) {{
  y[threadIdx.x] = erfinv_central(__uint_as_float(b[threadIdx.x]));
}}
extern "C" __global__ void k_tail(const unsigned* b, float* y, unsigned s) {{
  y[threadIdx.x] = erfinv_tail(__uint_as_float(b[threadIdx.x]));
}}
"""


PATH_N, PATH_D = 10, 855_050          # dwfl-paper, hidden 256
# dwfl-paper's leaves at N = 10, in tree order (each layer's b, then w)
MLP_LEAVES = [(10, 256), (10, 3072, 256), (10, 256), (10, 256, 256),
              (10, 10), (10, 256, 10)]
SCHEMES = ("dwfl", "gossip", "orthogonal", "centralized")
TREE_ROUNDS = 11
# flash_attention at the serve path's shapes (B, S, H, Hkv, hd): gemma-2b's
# prefill of 4 prompts of 1024 tokens, and olmo-1b's heads
GEMMA_ATTN = (4, 1024, 8, 1, 256)
OLMO_ATTN = (4, 1024, 16, 16, 128)
GEMMA_PARAMS = 2_506_172_416
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
# the bfloat16 serve's logits with the kernel against those without, as a
# share of their scale: 2^-5, four bfloat16 steps. bfloat16 keeps 8
# significant bits and the two prefills round at other places in each of
# the 18 layers (without the kernel the scores and the probabilities are
# rounded to bfloat16; the kernel keeps them in float32), and the residual
# stream carries each layer's difference on; on the CPU two reduced layers
# differ by up to 2^-6 of the scale (tests/test_torch_bf16_serve.py), and
# at full width, with the CUDA-core kernel, 0.113 at a scale of 14.1 (2^-7).
BF16_SERVE_TOL = 2.0 ** -5
# ssd_scan (B, S, H, P, N, chunk): zamba2-7b's prefill of 4 prompts of 1024
# tokens, PERF.md's bound case, and the other checked cases: the
# reference's sweep (tests/test_kernels.py), H < 8, S equal to the chunk
# (zamba2-7b's heads; N = P = 128 at chunk 256)
ZAMBA_SSD = (4, 1024, 112, 64, 64, 128)
BOUND_SSD = (1, 4096, 64, 64, 128, 256)
SSD_CASES = [(2, 128, 8, 16, 16, 32), (1, 256, 16, 32, 64, 64),
             (2, 64, 8, 64, 64, 32), (2, 256, 4, 64, 64, 64),
             (1, 64, 2, 32, 16, 64), (4, 128, 112, 64, 64, 128),
             (2, 256, 8, 128, 128, 256)]
ZAMBA_PARAMS = 6_751_130_832
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1024, 32
# phase 9, the zoo (ROADMAP A15): each arch's parameters at the depth
# served (qwen3-moe-235b-a22b: 2 of its 94 layers, 24.9 GB in float32; the
# others whole) and the driver's prompt length (qwen3 and whisper: the
# CLI's 64; whisper's encoder takes its 1500 frames besides)
ZOO = {"deepseek-moe-16b": (16_375_728_128, None, SERVE_PROMPT),
       "qwen3-moe-235b-a22b": (6_220_173_312, 2, 64),
       "xlstm-1.3b": (2_875_433_296, None, SERVE_PROMPT),
       "whisper-medium": (826_647_552, None, 64)}
# phase 10, LM training (ROADMAP A15): olmo-1b at full width, batch 4 x 128
# a worker, float32: the worker-tree round at full depth on N = 2 workers
# (use_pallas: one sgd_update_leaves launch a round), the flat round on N = 4
# workers with the depth cut to 4 of 16 layers (C2: N roundup(d, 128) <=
# 2^31 takes N = 1 at full depth), LM_ROUNDS rounds each
LM_ARCH, LM_PARAMS = "olmo-1b", 1_176_764_416
LM_TREE_N, LM_FLAT_N, LM_FLAT_LAYERS, LM_FLAT_D = 2, 4, 4, 371_458_048
LM_BATCH, LM_SEQ, LM_ROUNDS = 4, 128, 4
# the dynamic network's paths: the flat CLI's scenario and rounds, the tree
# round's scenario, and the worker counts of dp_mix's dynamic plan (the
# path's N, the column route's last on an H100 and the large-N route's
# first)
DYN_SCENARIO, DYN_STEPS, DYN_TREE_SCENARIO = "iot_dense", 50, "drone_sparse"
DYN_PLAN_N = (PATH_N, 50, 51)
# the worker-scale path (ROADMAP A10): mesh_sparse at N = 2048 with a degree
# cap of 12 (benchmarks/workers_bench.py's k), 5 rounds (the CLI runs
# --steps + 1); the tree round's N
SPARSE_SCENARIO, SPARSE_N, SPARSE_K, SPARSE_STEPS = "mesh_sparse", 2048, 12, 4
SPARSE_TREE_N = 64
# the fleet (ROADMAP A12): the README's vehicular line, R = 8 replicates at
# the path's N and width, 100 steps (101 rounds); dp_mix's replicate axis
# also on the large-N route at (R 4, N 64); the tree round's rounds
FLEET_SCENARIO, FLEET_R, FLEET_STEPS, FLEET_TREE_ROUNDS = "vehicular", 8, 100, 5
RAXIS_CASES = ((FLEET_R, PATH_N, PATH_D), (4, 64, PATH_D))
# the fleet's sparse round (ROADMAP A20): R = 4 networks of N = 512 on
# mesh_sparse at k = SPARSE_K, the worker-scale path's 2048 rows (R = 2 at N
# = 2048 would not fit one card); the CLI's steps (it runs --steps + 1)
FLEET_SPARSE_R, FLEET_SPARSE_N, FLEET_SPARSE_STEPS = 4, 512, 5
# the keys of a sweep row: the reference's run_point returns these and the
# grid point's four (tests/test_torch_fleet.py holds them against it)
SWEEP_KEYS = frozenset((
    "scenario", "n_workers", "p_dbm", "target_epsilon", "seed", "replicates",
    "steps", "config", "us_per_round", "loss_mean", "loss_ci95", "acc_mean",
    "acc_ci95", "epsilon_composed_mean", "epsilon_composed_ci95",
    "epsilon_round_worst", "delta_composed", "epsilon_rdp_mean",
    "epsilon_total_mean", "epsilon_total_ci95", "delta_total", "accountant",
    "accountant_gap"))
# the reference's telemetry overhead ceiling (BENCH_obs.json)
TELEMETRY_CEILING = 0.05
# the telemetry columns in their order (obs.telemetry's catalogue)
TELEMETRY_FIELDS = ("loss", "grad_norm", "consensus", "snr_db", "deep_fade",
                    "participation", "epsilon")
# sharding and checkpoints (ROADMAP A13, A14): the model axis's shard
# counts (logical, one card), the worker axis's (its row windows stitched
# on one card, at the worker-scale path's shape), and the sharded flat
# CLI's steps before its checkpoint and after (the resume)
SHARD_COUNTS, WORKER_SHARDS = (2, 4), 2
CKPT_STEPS = 9
# What each phase of the dynamic network is expected to show, written
# before the card ran it; each is printed on a line before its phase.
PREDICTIONS = {
    "decode_graph": "each arch's decode (batch 4, prompt 1024, 31 greedy "
                    "steps; whisper-medium prompt 64; gemma-2b-sw4096 a "
                    "prompt of its 4096 window, decoding past it) through "
                    "DecodeRunner bitwise the eager decode_step in every "
                    "turn (each step's logits, the tokens, every cache "
                    "leaf), one capture, reused by the second wave, no "
                    "kernel of the repo in a replay's device trace or an "
                    "eager step's. The graph's step is the device time "
                    "under the eager step's launches (PERF 5's busy share "
                    "x step time), ms a step graph | eager: gemma-2b f32 "
                    "6.0-8.5 | 24-30 (floor 2.99), bf16 3.5-5.5 | 35-42 "
                    "(1.50), gemma-2b-sw4096 6.5-9 | 25-31; zamba2-7b 28-40 "
                    "| 90-150 (8.06); deepseek-moe-16b 30-42 | 80-125 "
                    "(19.55); qwen3-moe-235b-a22b on 2 layers 9-12.5 | "
                    "12-14 (7.43: nearly device-bound eager); xlstm-1.3b "
                    "6-12 | 60-70 (3.43); whisper-medium 12-18 | 35-45 "
                    "(0.99: its cross-attention projects the 1500 encoder "
                    "frames' k and v every step, ~0.6 TFLOP in float32 on "
                    "the CUDA cores, so compute, not the weights, bounds "
                    "it). Peak allocated within 0.5 GiB of eager's",
    "graphs": "each path's chunks through ChunkRunner bitwise run_chunk's "
              "(parameters, generator state, network state, epsilon "
              "moments, every output), one capture a length, each kernel "
              "as many launches a replay as an eager chunk; rounds/s in "
              "turns, graph against eager, from the device time under the "
              "host's launches (busy share x round time) plus ~1-2 us a "
              "graph node: the static flat round 0.6-0.8 ms (eager "
              "2.1-4.2), 3-6x; the static flat CLI at its defaults "
              "(evals and a 50-round capture included) 1.3-2x; the dynamic "
              "flat round (iot_dense) 0.8-1.2 ms (eager 4.2-5.7), 4-5x; "
              "the tree round 0.8-1.2 ms, 3-5x; the fleet at R 8 3.3-3.8 "
              "ms (eager 7.2), 1.8-2.2x; the sparse round at N = 2048 "
              "device-bound, its rounds writing the static buffer in "
              "place (no write-back): graph 86.5-88 ms, 1.5-2.5% under "
              "eager's in turns (the write-back cost 0.9-2.4%, PERF 6), "
              "peak allocated past the first chunk 28.5-29.5 GiB against "
              "eager's 40.0-40.5 (no carry of the chunk but the static "
              "one), reserved 52-61 GiB either way (the runner's eager "
              "first chunk's cache); the static "
              "flat round with telemetry (every field) 0.68-0.80 ms under "
              "the graph, 5-20% over the graph's round without it",
    "large_n": "dp_mix's large-N route (dp_mix_prep + dp_mix_tiled, the "
               "mix in split TF32 on wgmma) within dp_mix_tolerance of the "
               "plain twin at N = 51, 64, 65, 128, 256 and over three "
               "windows at 2048, noise fields bitwise at N = 128, HGMMA "
               ".TF32 in the library's SASS; at the path's d, float32 "
               "noisy: N = 64 1.0-1.1 ms (the CUDA-core mix: 1.008), 128 "
               "2.0-2.3 (2.392), 256 4.4-4.9 (6.510), 2048 92-102 (266.6) "
               "against a bound of 14.49 (operations: 2 "
               "N^2 d at 495 TFLOP/s TF32), the route's floor 51.8 (its "
               "split products 43.5 and the prep's workspace traffic 8.4) "
               "and the CUDA-core bound 113.4; torch.matmul(W, z) in "
               "float32 without TF32, the yardstick of the mix alone, "
               "130-145 ms; the plain twin over the whole round in "
               "2^16-column windows 4,000-4,500 ms",
    "split_precision": "the large-N route at N = 2048, d = 8192, float32 "
                       "noisy, within sqrt(N) 2^-23 scale of the exact "
                       "round in float64: under 0.05 of that bound on the "
                       "ring and on the complete graph (the CPU emulation "
                       "of split TF32: 0.005-0.01 and 0.0006-0.02), the "
                       "plain twin's float32 error under 0.02 of it (the "
                       "output's own roundings)",
    "plans": "dp_mix within dp_mix_tolerance of its plain twin under the "
             "dynamic, sampled and ring plans at (10, 855,050), float32 and "
             "bfloat16, and the dynamic plan at N = 50 (column route) and "
             "51 (large-N route); the rows with listen = 0 within 1 ULP of "
             "the plain twin's p - gamma g (0 ULP expected: both round p - "
             "gamma g once)",
    "dynamic_cli": "51 dp_mix launches in 51 rounds, every loss finite, the "
                   "per-round epsilon trajectory printed; 100-160 rounds/s "
                   "(the static flat CLI ran 174.11 in PR 19's call 11, and "
                   "a simulator round adds about 1 ms of launches); the "
                   "vehicular --total-epsilon 8 --accountant rdp run one "
                   "launch a round, its rdp total at most 8",
    "dynamic_tree": "one dp_perturb launch (sgd_update_leaves) a dynamic "
                    "tree round, 11 in 11, every loss finite",
    "cpu_vs_cuda": "the dynamic flat round on the card within 1e-4 (1 + "
                   "max|x|) of the CPU's, its dp_mix part within "
                   "dp_mix_tolerance",
    "sync": "no synchronizing call in sim.round, plan_dynamic and the dp_mix "
            "call under set_sync_debug_mode('error'); the whole round body "
            "(batch, gradients, metrics) also free of one",
    "profile": "the steady dynamic flat round 3.4-5.8 ms against the "
               "static flat round's 2.7-4.3, 12-22% busy; the simulator's "
               "round 0.6-1.5 ms of host time with about 105 launches, "
               "under 5% busy (N = 10: each kernel a few microseconds), so "
               "15-35% of the dynamic round",
    "turns": "right after the training phases, in turns: the static flat "
             "round 2.6-3.2 ms, the dynamic one 3.4-4.4, the simulator's "
             "round alone 1.0-1.6 (the phase-4 dynamic CLI ran 3.59 ms a "
             "round, evals included, in PR 20's call 3)",
    "cli_turns": "warm, without evals, in turns, right after the training "
                 "phases: the static flat CLI 280-360 rounds/s, the dynamic "
                 "one 220-300 (PR 20's call 3 measured 311.70-316.38 and "
                 "171.32-177.31 after serving)",
    "sparse_kernel": "the sparse round (dp_mix_prep + dp_mix_gather, the "
                     "gather's groups of 16 in the list's Morton order, "
                     "their union of rows staged once a slab by bulk "
                     "copies) within its tolerance of the plain twin at "
                     "(2048, 855,050, k 12) in float32 and bfloat16, noisy "
                     "and gossip; float32 noisy 23.5-26 ms (the design's "
                     "probe calls: prep 10.1-10.3, gather 14.6-14.9; the "
                     "one-receiver-a-block design 34.7-36.1) against a "
                     "bound of ~7 ms (operations) and a workspace floor of "
                     "18.8; with "
                     "zero weights bitwise the dense kernel's round at N "
                     "= 64 and 2048; the graph against SparseW.dense() at "
                     "N = 64 within 1e-5",
    "sparse_cli": "5 dp_mix_round_sparse calls in 5 rounds (the eager "
                  "first round's and the 4-round capture's) and no dense "
                  "dp_mix_round, every loss finite, epsilon over 5 rounds; "
                  "the executor ChunkRunner's graph, its rounds writing the "
                  "buffer in place; 6.8-7.5 rounds/s over the 5 rounds, "
                  "the first eval, first calls and the 4-round capture "
                  "included (7.12 when first measured; eager: 11.04-11.15, "
                  "PERF 6); peak allocated 33-36 GiB (eager 40.6-40.9: the "
                  "graph's rounds hold the static buffer, its clipped "
                  "gradient and the [2, N, d] workspace, 6.5 GiB each but "
                  "the workspace's 13, and no second carry), reserved "
                  "52-55 GiB (53.14 when first measured)",
    "sparse_sync": "no synchronizing call in sim.round's neighbor-list "
                   "build, plan_dynamic_sparse and the sparse dp_mix call at "
                   "N = 2048; the whole round body at N = 64 also free of one",
    "sparse_turns": "in turns at N = 2048: the sparse round in the "
                    "key's order 23.5-26 ms, the same list in index order "
                    "36-41 (no rows shared, so most of a group's union past "
                    "the staged rows reads from global memory: the design "
                    "probe's gather took 26.5 so; the one-receiver-a-block "
                    "design 35.6), the dense large-N route 92-102 ms "
                    "(split TF32 on wgmma), so 3.6-4.2x; apart, by CUDA "
                    "events: the prep 10.0-10.5 against its floor of 8.36 "
                    "(28 GB at 3.35 TB/s), the gather 14.4-15.2 against "
                    "10.45 (35 GB), a group of 16 reading 2.8-3.0 distinct "
                    "rows a receiver in the key's order against 10.3-10.6 "
                    "in index order (the probe: 2.93 and 10.41), 70 rows "
                    "staged a group at k 12; "
                    "torch.sparse.mm of the list as a CSR [N, N] against "
                    "z [2048, 855,050], the yardstick of the mix alone, "
                    "10-30 ms; the simulator's sparse round 1.5-2.5 ms "
                    "against its dense one's 0.9-1.3; the whole sparse "
                    "flat round 80-92 ms (96.7 with the earlier mix; the "
                    "mix 10-11 ms faster, the gradient pass, its clip and "
                    "the metrics unchanged)",
    "sparse_tree": "one dp_perturb launch (sgd_update_leaves) a sparse "
                   "dynamic tree round at N = 64, 11 in 11, W a SparseW, "
                   "every loss finite",
    "raxis": "dp_mix's replicate axis bitwise R separate launches (0 "
             "elements differ) at (R 8, N 10, 855,050) in float32 and "
             "bfloat16 (column route) and at (R 4, N 64) (large-N route), "
             "within dp_mix_tolerance of the plain twin replicate by "
             "replicate; R 8 float32 0.50-0.56 ms (PR 22's call 1: 0.517) "
             "against R separate launches' 0.56-0.62 (0.577-0.597) and a "
             "bound of ~0.262 ms (8 x 0.0328, operations); R 4 x N 64 "
             "float32 4.1-4.4 ms (4.650 with the CUDA-core mix) against "
             "a bound of ~0.78 (bytes)",
    "fleet_cli": "the fleet CLI (vehicular, R 8, N 10, full width, 101 "
                 "rounds) under the sync guard: 101 dp_mix launches in 101 "
                 "rounds, every loss finite, the epsilon report over 8 "
                 "replicates; 700-1500 replicate-rounds/s (call 1: 1374.9 "
                 "over 21 rounds); peak memory ~2-3 GiB (8 [10, 855,050] "
                 "buffers of 274 MB: p, g, out and the views of the "
                 "gradient pass)",
    "fleet_tree": "one sgd_update_leaves launch a fleet tree round (R 8, "
                  "use_pallas), 5 in 5, no per-leaf launch, under the sync "
                  "guard",
    "fleet_launches": "the same kernel launches per fleet round at R = 2 "
                      "and R = 8 (about 240, the single dynamic round's, "
                      "PERF.md §5); device busy 30-60% at R 8 (the gradient "
                      "pass and dp_mix grow 8x, the launches do not)",
    "fleet_turns": "in turns: the single dynamic flat round 3.5-6 ms (PR "
                   "20: 4.17-5.65), the R 8 fleet round 6-9 ms (device work "
                   "8 x ~0.8 ms under ~4-5 ms of host launches), so the "
                   "fleet 4-6x the single round's replicate-rounds/s",
    "telemetry": "the static and the iot_dense flat CLI (51 rounds) with a "
                 "run log: 51 round events of 7 fields, the epsilon events "
                 "at each eval, the report reading the directory back; "
                 "telemetry on against off in turns costs 3-15% of the "
                 "CLI's rounds/s (a few dozen small launches a round for "
                 "consensus and the stack, and one host read a chunk), so "
                 "it may miss the reference's 5% ceiling",
    "sweep": "the sweep (iot_dense and vehicular x N 8, 16 x eps 0.5, 1.0, "
             "R 8, 5 steps) writes 8 rows with the reference's keys, every "
             "number finite, in 10-40 s",
    "shard_logical": "the logical model-axis round at (10, 855,050) bitwise "
                     "the unsharded launch at S = 2 and 4 (0 elements "
                     "differ, the padding columns 0), one launch a round "
                     "over the padded width, each window within "
                     "dp_mix_tolerance of its plain twin and each window's "
                     "own launch (col0 = s shard_width) bitwise its "
                     "columns; the static and dynamic sharded steps bitwise "
                     "the unsharded steps (buffer and metrics); on the "
                     "device (CUDA graphs) 0.074-0.080 ms at S = 2 and 4, "
                     "within 3% of the unpadded call's 0.074-0.077 (0.12% "
                     "and 0.06% more columns; before, S calls a window: "
                     "0.178 and 0.214); on the host's clock within 0.01 ms "
                     "of the unpadded call (one wrapper call, as it)",
    "shard_cli": "the flat CLI with --model-shards 2 (logical) and "
                 "--checkpoint: 10 dp_mix launches in 10 rounds (1 a "
                 "round), every loss finite, the buffer and losses bitwise "
                 "the unsharded CLI's; the checkpoint restored and run 10 "
                 "more rounds through the trajectory body bitwise the "
                 "20-round CLI's buffer and its last 10 losses",
    "worker_axis": "the worker axis at (2048, 855,050, k 12) on one card: "
                   "dp_mix_prep_rows and dp_mix_gather_rows on each of S = "
                   "2 row windows (global counters from row0; each "
                   "window's gather in its own rows' key order, its "
                   "receivers' own z from its workspace), their z "
                   "gathered by hand, bitwise the unsharded "
                   "dp_mix_round_sparse (0 elements differ) and within "
                   "the sparse round's tolerance of the plain twins; the "
                   "row-window kernels alone (two preps, two gathers) "
                   "30-34 ms against the unsharded round's 23.5-26 (a "
                   "group stages its receivers' own rows from the "
                   "workspace besides z_src's copies of them, which its "
                   "padded slots read: the design probe took 32.7 so; the "
                   "one-receiver-a-block design: 38.3 and 34.8); the "
                   "stitched round with its copies (z's and the outputs', "
                   "28 GB) 35-40; peak 38-41 GiB (first measured: 39.4)",
    "mesh_one_rank": "one-rank NCCL groups: the model-axis mesh step (S = "
                     "1: all_to_all and all-gathers over one rank, under the "
                     "CLI's sync guard, its communicators started when the "
                     "mesh is made) bitwise "
                     "the logical S = 1 step at (10, 855,050); the 2-D (1, "
                     "1) fleet round bitwise the logical fleet round at R 2; "
                     "the worker-axis trajectory at N = 2048 (mesh_sparse, "
                     "k 12, 3 rounds): one dp_mix_prep_rows and one "
                     "dp_mix_gather_rows launch a round under the guard, no "
                     "dp_mix_round_sparse call, its buffer bitwise the "
                     "unsharded trajectory's, peak 45-55 GiB",
    "two_cards": "the CLI on two cards, each rank started as torchrun "
                 "starts it (its card set from LOCAL_RANK, NCCL bound to "
                 "it), 6 rounds in chunks of 2, each rank naming "
                 "ChunkRunner's graph (the eager first chunk, a capture "
                 "with the chunk's NCCL collectives, a replay): "
                 "--model-shards 2 at (10, 855,050) bitwise the logical "
                 "run on one card, buffer and losses; --worker-shards 2 "
                 "on mesh_sparse at (2048, 855,050, k 12) within rtol "
                 "1e-5, atol 3e-5 of the unsharded CLI, its losses "
                 "bitwise; each start 12-30 s; with --runlog-dir on both "
                 "runs one run log, rank 0's, its rows the one-card run's "
                 "telemetry (model: bitwise but consensus, within rtol "
                 "1e-6; worker: within rtol 1e-5)",
    "mesh_graph": "on two NCCL ranks (the runner closed before the "
                  "group is destroyed: NCCL keeps a communicator while a "
                  "graph of its collectives exists: the two-card hang of "
                  "PERF 6): one "
                  "all_reduce captured and replayed twice, its values "
                  "right; the model axis (4 "
                  "rounds a chunk), the fleet on (replicas 1, model 2) and "
                  "the worker axis at (2048, 855,050, k 12, 2 rounds a "
                  "chunk) through ChunkRunner bitwise run_chunk, one "
                  "capture a rank, NCCL's kernels and dp_mix_columns (or "
                  "dp_mix_prep and dp_mix_gather) once a round in a "
                  "replay's trace. ms a round graph | eager in turns: the "
                  "model axis 1.11-1.19 | 8.6-9.4, the fleet 3.7-3.95 | "
                  "11.5-12.8, the worker axis 57.5-61 | 58.7-62.5 (the "
                  "first two-card call's within 3%); peak allocated a "
                  "rank: the model axis and the fleet within 0.1 GiB of "
                  "eager's, the worker axis's past its first chunk 3-6 "
                  "GiB under eager's 30.5 (the in-place rounds hold no "
                  "second carry; a rank's carry is 3.27 GiB)",
    "fleet_sparse_kernel": "the sparse round's replicate axis at (R 4, N "
                           "512, 855,050, k 12, float32, noisy): one wrapper "
                           "count, bitwise the 4 separate launches (0 "
                           "elements differ), within the sparse round's "
                           "tolerance of the plain twin on three column "
                           "windows of each replicate; 22-27 ms against "
                           "the separate launches' 23-28 (the same 2048 "
                           "rows as the N = 2048 round, each replicate's "
                           "list in its own key's order; the "
                           "one-receiver-a-block design "
                           "34.7), within 5% of each other; a bound of "
                           "6.3-6.9 ms (operations); the twin 3.5-5 s in "
                           "2^16-column windows",
    "fleet_sparse_cli": "the fleet sparse CLI (mesh_sparse, R 4 x N 512, k "
                        "12, 6 rounds) under the sync guard: 6 "
                        "dp_mix_round_sparse calls in 6 rounds and no "
                        "dense one, every loss finite, the epsilon report "
                        "over 4 replicates and 6 rounds; 5-9 rounds/s, so "
                        "20-36 replicate-rounds/s with the first round and "
                        "eval (the N = 2048 sparse CLI ran 7.51 rounds/s on "
                        "the same 2048 rows); peak 38-44 GiB (as the N = "
                        "2048 CLI's 40.6: the same buffer, gradient, output "
                        "and workspace sizes); under torch.profiler 2 "
                        "dp_mix_prep and 2 dp_mix_gather kernels in 2 "
                        "rounds and no dense kernel",
    "fleet_sparse_cpu_vs_cuda": "a reduced fleet sparse round (R 2 x N 16, "
                                "hidden 16, k 4, with the fallback) on the "
                                "card within 1e-4 (1 + max|x|) of the "
                                "CPU's (the earlier small rounds measured "
                                "~1e-7)",
    "mesh_telemetry": "on one-rank NCCL groups under the sync guard, "
                      "telemetry on: the model-axis trajectory at (10, "
                      "855,050), 10 rounds, and the worker-axis one at N = "
                      "2048, 2 rounds, their rows and carry.eps bitwise "
                      "the logical mode's (0 elements differ); telemetry's "
                      "cost in turns 3-20% of the model-axis round (a "
                      "host-bound 3-6 ms round; PR 22 read 3.8-14.3% on "
                      "the CLI, plus one scalar all_reduce) and 8-25% of "
                      "the worker-axis round (~100 ms; consensus reads the "
                      "7 GB buffer about six times, ~13-15 ms at the HBM "
                      "rate)",
    "zoo_deepseek": "deepseek-moe-16b at full width and depth in float32 "
                    "(61.0 GiB of parameters): no kernel launched; the CLI "
                    "(4 x 64, gen 32) and the driver (4 x 1024) finite. "
                    "The driver's prefill 0.5-1.0 s (the data-sheet floor: "
                    "~27 TFLOP at 67 TFLOP/s, >= 0.40 s; cuBLAS's float32 "
                    "GEMMs reach 60-80% of it, and the experts' products "
                    "are 64 batched [480, 2048] x [2048, 1408] a layer), so "
                    "4-8k prefill tokens/s; a decode step 22-40 ms (the HBM "
                    "floor 19.6 ms: at T = 4 the capacity is 4 and the "
                    "einsum dispatch reads all 64 experts of all 27 MoE "
                    "layers, 65.5 GB; its M = 4 batched products stream "
                    "below the peak rate, and ~3,500 launches a step take "
                    "about as long on the host), so 100-180 decode tokens/s; "
                    "peak 66-70 GiB; under the profiler the decode step "
                    "80-100% busy, aten::bmm of the experts most of it",
    "zoo_qwen3": "qwen3-moe-235b-a22b at full width on 2 of its 94 layers "
                 "(6.22 G parameters, 23.2 GiB): no kernel launched, "
                 "finite, the cache's dense part None; the driver's prefill "
                 "(4 x 64, 20 slots an expert) 15-60 ms, a decode step "
                 "3-8 ms (7.5 GB of experts, attention and unembedding: "
                 "2.2 ms at the HBM rate, ~400 launches), peak 25-28 GiB",
    "zoo_xlstm": "xlstm-1.3b at full width and depth (2.88 G parameters): "
                 "no kernel launched, finite; the driver's prefill (4 x "
                 "1024: 8 mLSTM chunks a layer, the sLSTM loop 1024 steps "
                 "in each of 6 layers, ~20 launches a step) 1.5-4 s, the "
                 "sLSTM layers 60-85% of it and the 42 mLSTM layers "
                 "0.3-0.8 s (~20 TFLOP of projections); a decode step "
                 "8-20 ms (~1,000 launches; the 11.5 GB of weights take "
                 "3.4 ms at the HBM rate), so 200-500 decode tokens/s; "
                 "peak 14-20 GiB",
    "zoo_whisper": "whisper-medium at full width and depth: no kernel "
                   "launched, prefill logits [4, 64, 51865] finite; the "
                   "CLI's prefill (the encoder over 4 x 1500 frames, ~5 "
                   "TFLOP) 0.1-0.3 s; a decode step 12-25 ms, the "
                   "cross-attention's k/v projected from the encoder's "
                   "output again in every layer at every step (~0.6 TFLOP "
                   "a step, as in the reference)",
    "zoo_cpu_vs_cuda": "each of the four archs at reduced() served on the "
                       "card within 1e-4 of the largest logit of the same "
                       "run on the CPU (prefill and the last decode "
                       "step): no router choice flips at these sizes",
    "lm_tree": "olmo-1b at full width and depth (1,176,764,416 parameters "
               "a worker, 8 leaves), N = 2, batch 4 x 128 a worker, "
               "make_train_step(dwfl, use_pallas) through the trajectory "
               "body: 4 rounds, one sgd_update_leaves launch a round and "
               "no other kernel, every loss finite (the first near ln "
               "50,304 = 10.8 at a random init; at eps = 1 a round the "
               "DP noise then lifts it); a warm round 0.22-0.32 s (~7.2 "
               "TFLOP of float32 GEMMs, ~0.17 s, and the elementwise "
               "passes over the [2, d] trees: clip, local step, two "
               "normal fields, the mix; 0.55-0.60 s were read while "
               "each layer was taken by a select, before unbind); peak "
               "64-68 GiB (66.13 read before; the parameters, the local "
               "step's output, the two noise fields and the exchange's "
               "output, 8.77 GiB each, and a leaf's temporaries)",
    "lm_flat": "olmo-1b at full width on 4 of 16 layers (d = 371,458,048), "
               "N = 4: N roundup(d, 128) = 1,485,832,192 <= 2^31 (full "
               "depth at N = 2: 2,353,528,832, refused), the flat round "
               "through the trajectory body: 4 rounds, one dp_mix launch "
               "a round (the column route) and no other kernel, every "
               "loss finite; a warm round 0.1-0.2 s; peak 20-32 GiB "
               "(the buffer, the per-leaf gradients, their ravel, the "
               "clipped gradient and dp_mix's output, 5.53 GiB each)",
    "lm_kernels": "dp_mix at (4, 371,458,048) f32 noisy within "
                  "dp_mix_tolerance of its twin on three column windows; "
                  "10-13 ms (at dwfl-paper's shape it runs 2.2x its "
                  "bound; here the bound is ~5.3-5.5 ms, bytes 17.8 GB "
                  "and ~180 G lane-instructions about even); its twin "
                  "over the round in 2^22-column windows 2-8 s. "
                  "sgd_update_leaves over olmo-1b's 8 leaves at N = 2 "
                  "(2.35 G elements, 28.2 GB): 8.8-10.5 ms against its "
                  "8.43 ms bound (bytes), within 10% of "
                  "torch._foreach_add, the plain version 2-4x slower",
    "lm_profile_tree": "2 warm tree rounds under torch.profiler: 0.22-0.32 "
                       "s a round, the device busy 90-100%; float32 GEMMs "
                       "(the forward and backward, ~7.2 TFLOP) ~0.17 s, "
                       "add, add_ and fill_ under 60 ms together (each "
                       "family's layers taken by unbind once; taken by a "
                       "select each, they cost 0.34 s a round in the "
                       "zero-filled gradients), the rest the exchange's "
                       "elementwise passes",
    "lm_profile_flat": "2 warm flat rounds under torch.profiler: 0.17-0.19 "
                       "s a round, busy 90-100%; GEMMs ~0.09 s, dp_mix "
                       "11.2 ms, the gradients' ravel and the clip most of "
                       "the rest",
    "lm_cli": "python -m repro_torch.launch.train --arch olmo-1b "
              "--workers 2 --batch-size 4 --seq-len 128 --steps 3: it "
              "prints 'executor: ChunkRunner (one CUDA graph of a round', "
              "4 rounds in chunks of 1 (eager, with the eval) and 3 (the "
              "round's graph replayed 3 times), no kernel launched (the CLI "
              "never sets use_pallas), every loss finite, 1.8-2.8 "
              "rounds/s over the loop with its first round, eval and "
              "capture (1.72-2.47 eager, PERF 6), peak 60-68 GiB; with "
              "--flat-buffer it exits naming C2 before a round",
    "graph_lm": "olmo-1b's tree round at full depth (N = 2, use_pallas) "
                "and flat round on 4 of 16 layers (N = 4) through "
                "ChunkRunner, 2 rounds a chunk: two eager runs of the same "
                "chunks bitwise each other (the embedding's backward is a "
                "sorted index_put, the loss's gather takes one label a "
                "row) and the graph bitwise them; one capture; "
                "dp_perturb_kernel (tree) or dp_mix_columns (flat) once a "
                "round in a replay's trace and an eager chunk's. In turns, "
                "ms a round graph | eager: tree 315-335 | 382-392 (the "
                "device's 83.5% busy share of the round), flat 160-185 | "
                "174-199; peak allocated under the graph within 1 GiB of "
                "eager's (66.13 and 29.36 GiB read eagerly, PERF 5), "
                "reserved up to 4 GiB over it",
    "graph_mesh": "on one-rank NCCL meshes, the model-axis round "
                  "(iot_dense at (10, 855,050), one window) without and "
                  "with telemetry and the fleet (vehicular, R 8) on a (1, "
                  "1) mesh through ChunkRunner, 4 rounds a chunk: the "
                  "collectives (all_to_all_single, all_gather, the clip's "
                  "and the consensus's all_reduce) captured, graph bitwise "
                  "eager and eager bitwise itself, one capture, "
                  "dp_mix_columns once a round in a replay's trace. In "
                  "turns, ms a round graph | eager: the model-axis round "
                  "0.7-1.3 | 12.5-14.5, with telemetry 0.7-1.5 | "
                  "13.9-15.2, the fleet 3.4-4.5 | 9-20; peak memory within "
                  "0.5 GiB of eager's",
    "lm_cpu_vs_cuda": "one reduced olmo-1b round (N = 3, batch 2 x 32) on "
                      "the card against the CPU's from the same "
                      "parameters, batch and seed or normals, flat and "
                      "tree: within 1e-4 (1 + max|out|), as the earlier "
                      "slices' small rounds (measured there ~1e-7)",
    "tooling_analysis": "the 8 single-card programs at dwfl-paper's width "
                        "(N = 6, batch 4, 2 chunks of 3 rounds under the "
                        "sync guard): 0 ERROR findings; dp_mix_round 6 "
                        "launches in 6 rounds on static-flat, "
                        "dynamic-flat-tele, fleet-flat (one for both "
                        "replicates) and shard-flat-s2, dp_mix_round_sparse "
                        "6 in 6 on dynamic-sparse-flat, none on the tree "
                        "programs, whose noise the key check reads as "
                        "generator draws (78 on static-tree, 96 on "
                        "dynamic-tree and fleet-tree, each from a state of "
                        "its own, as on the CPU); every draw's counters "
                        "from 0 to "
                        "10,261,779 (2 (5 x 855,168 + 855,049) + 1; "
                        "shard-flat-s2's padded window clipped at the "
                        "stride, 10,262,015); 2-10 s a program",
    "tooling_rounds": "op_cost on meta equal to the card's, FLOPs, bytes "
                      "and ops exactly, for both rounds (the clip's row "
                      "sums run the card's three reductions on meta too); "
                      "dwfl-paper's flat round: 161 ops, 1,060,034,864 "
                      "bytes, bound 0.316 ms (memory; compute 0.020) "
                      "against 3-5 ms measured, 6-10% of the roofline "
                      "(host-bound); olmo-1b's tree round: bound 169-170 ms "
                      "(memory, ~568 GB; compute 109.0 ms of 7.30 TFLOP at "
                      "67 TFLOP/s) against 376-400 ms, 42-45%; olmo-1b's "
                      "arguments 9,414,115,328 bytes on "
                      "meta equal to the card's allocation; the recorder's "
                      "peak 57.07 GiB on meta and on the card against "
                      "max_memory_allocated's 60-67 GiB (PR 25: 66.13; the "
                      "kernel's workspace and the allocator's blocks are "
                      "not in the recorder's count)",
    "tooling_serve": "the batched serving loop at gemma-2b's full width "
                     "(2,506,172,416 float32 parameters), 2 waves of 4 "
                     "requests, prompt 48, 24 generated: finite logits, 0 "
                     "kernel launches, 1-4 s a wave (its 23 decode steps "
                     "host-bound, ~540 launches a step)",
    "tooling_dryrun": "66 OK records (33 pairs x 2 meshes), 0 failures, in "
                      "150-350 s with 7 processes (the sandbox's CPU: 329 s "
                      "with 4 processes beside a test run); the longest "
                      "pair xlstm-1.3b train_4k (its 5 fit steps, ~300 s "
                      "of one core a mesh), then zamba2-7b train_4k (~100 "
                      "s) and qwen3-moe-235b-a22b train_4k (~70 s)",
    "examples_quickstart": "examples/port_quickstart.py at its defaults "
                           "(N 10, input 256, hidden 64: d = 21,258, 301 "
                           "rounds): dp_mix launched 301 times and no other "
                           "kernel; the last round's output within "
                           "dp_mix_tolerance of the plain twin on the same "
                           "buffer, gradient and seed (max err ~6e-8); eval "
                           "accuracy 0.075, 0.139, 0.211, 0.243 at rounds 0, "
                           "100, 200, 300 (the card's first run; the port's "
                           "own draws, >= 0.20 and rising required); the "
                           "same run on the CPU from the card's draws within "
                           "301 x tol_f32 = 8.6e-4 of the buffer (the "
                           "second run: 7.4e-5) and the same accuracies "
                           "within two samples (equal there), 15-40 s; 1-3 s "
                           "for the card's 301 rounds with its libraries "
                           "built (host-bound)",
    "examples_dynamic": "examples/port_dynamic_quickstart.py (iot_dense, N "
                        "10, hidden 64, the tree round, 151 rounds): every "
                        "round guarded (sync-debug mode, no host read, no "
                        "build after round 0) and each dispatching the same "
                        "360-380 device operations (367 on the CPU; the "
                        "autograd engine's device thread keeps the dispatch "
                        "mode), no kernel launched; eps 1.000 every round, "
                        "composed ~300-350 over 151 (the reference's CPU "
                        "run: 324.05); 2-6 s",
    "examples_fleet": "examples/port_fleet_quickstart.py (R 8 x N 8, "
                      "hidden 32, the tree round, 30 rounds): every round "
                      "guarded, the same 370-380 operations each (376 on "
                      "the CPU), no kernel launched; composed eps 80.3 "
                      "with a CI of ~4e-6 (the reference's: 80.3 +- "
                      "3.9e-6); 1-3 s",
    "examples_compare": "examples/port_compare_schemes.py at its defaults "
                        "(N 10, 250 steps a scheme, eps 0.5 a round): eps/"
                        "round 0.5 for each scheme (the same host math as "
                        "on the CPU); us/step 2,000-6,000 (host-bound tree "
                        "rounds, gossip the least); both claims lines "
                        "REPRODUCED (the CPU with other draws: dwfl 0.280 "
                        "against orthogonal 0.108 and centralized 0.162); "
                        "5-15 s",
    "examples_e2e": "examples/port_train_dwfl_e2e.py --size 100m --steps 20 "
                    "(128,994,048 parameters a worker, 4 workers, batch 8 "
                    "x 128, dwfl at eps 2 a round): 21 finite losses near "
                    "ln 32,768 = 10.4, at the DP noise floor; 0.08-0.2 s a "
                    "round (~3.2 TFLOP of float32 GEMMs on the CUDA cores "
                    "at ~30-50 TFLOP/s), 5-12 rounds/s and 20,000-50,000 "
                    "tokens/s over the run with its first round; peak 10-20 "
                    "GiB (the [4, d] tree 2.06 GB, its gradients, the "
                    "local step's output, two noise fields, the mix); the "
                    "checkpoint (2.06 GB) restored bitwise",
    "examples_dev_smoke": "scripts/port_dev_smoke.py over the 11 archs at "
                          "reduced(): every loss and gradient norm finite, "
                          "every LM's decode logits [2, 1, vocab] finite, no "
                          "kernel launched; under 20 s",
    "turns_late": "the same in turns after serving gemma-2b and the "
                  "profiles: the static round within 10% of its early "
                  "reading, the dynamic one and the simulator's 1.0-2.0 ms "
                  "slower than early (call 3: 4.98-5.57 and 2.37-2.46), with "
                  "the collector tracking several times more objects",
}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    return out.splitlines()[0]


def sass_text(lib) -> str:
    """A built library's SASS (cuobjdump, beside nvcc in the toolkit)."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    try:
        return subprocess.run([str(cuobjdump), "-sass", str(lib.path)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"cuobjdump -sass {lib.path.name}: {e}")


def sass_count(lib, *words: str) -> int:
    """Lines of a built library's SASS that hold every one of ``words``."""
    return sum(all(w in line for w in words)
               for line in sass_text(lib).splitlines())


def sass_until_exit(lib) -> dict:
    """{function: its SASS instructions up to and including the first
    EXIT} of a library of straight-line kernels."""
    import re
    counts, name, done = {}, None, True
    for line in sass_text(lib).splitlines():
        if "Function : " in line:
            name, done = line.split("Function : ")[1].strip(), False
            counts[name] = 0
        elif name and not done and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name] += 1
            done = "EXIT" in line
    return counts


def noise_count_library():
    """NOISE_COUNT_SRC as a library of its own (built beside the kernels)."""
    from repro_torch.kernels import build
    header = SRC / "repro_torch" / "kernels" / "csrc" / "noise.cuh"
    src = build.BUILD_DIR / "noise_count.cu"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(NOISE_COUNT_SRC.format(header=header))
    return build.Library("noise_count", sources=(src,), headers=(header,))


def noise_instructions(lib) -> dict:
    """Instructions of one dp_mix normal on each branch (small, large:
    the whole normal with the central polynomial; tail: what the tail
    polynomial and its square root add), from the SASS."""
    c = sass_until_exit(lib)
    base = c["k_empty"]
    small, large = c["k_small"] - base, c["k_large"] - base
    tail_extra = c["k_tail"] - c["k_central"]
    if min(small, large, c["k_central"] - base) <= 0 or tail_extra <= 0:
        fail(f"noise instruction counts make no sense: {c}")
    return {"small": small, "large": large, "tail_extra": tail_extra,
            "sass": c}


def check_lattice_normals(lib) -> dict:
    """Every one of the 2^24 lattice normals drawn by noise.cuh on the card
    (k_lattice: one launch of 65,536 x 256), bitwise the plain generator's
    (kernels/noise.py::normal_from_bits). The division in log1p's small
    branch is the compiler's sequence without its slow path, correct only
    within the range the lattice gives it: this is the check that it is."""
    import ctypes
    import torch
    from repro_torch.kernels import build, noise
    fn = build.load(lib).lattice_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 2, ctypes.c_int
    y = torch.empty(1 << 24, device="cuda")
    rc = fn(y.data_ptr(), torch.cuda.current_stream().cuda_stream)
    k = torch.arange(1 << 24, dtype=torch.int64, device="cuda")
    want = noise.normal_from_bits((k << 8) | 0x5A)
    torch.cuda.synchronize()
    rec = {"normals": 1 << 24, "rc": rc,
           "differ": int((y.view(torch.int32) != want.view(torch.int32)).sum())}
    del y, k, want
    print(f"[kernels] dp_mix lattice normals {json.dumps(rec)}", flush=True)
    if rc or rec["differ"]:
        fail(f"noise.cuh's lattice normals are not the plain generator's: {rec}")
    return rec


def card_rates() -> dict:
    """SMs and the SM clock's maximum (nvidia-smi clocks.max.sm)."""
    import torch
    try:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
        fail(f"nvidia-smi clocks.max.sm: {e}")
    return {"sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "sm_clock_hz": mhz * 1e6}


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 10, iters: int = 20) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a
    CUDA graph and replayed ``iters`` times, timed by CUDA events, so no
    host time is in it (cuda_ms of a call that the host launches slower
    than the card runs it measures the host)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, iters) / calls
    del graph
    return ms


def dp_mix_case(N: int, d: int, dtype, noisy: bool, seed: int):
    """Inputs of one round at [N, d]: a realized channel's plan (sigma
    calibrated to eps = 1, as the trainer does) and random p, g."""
    import torch
    from repro_torch.core.protocol import ProtocolConfig
    proto = ProtocolConfig(scheme="dwfl" if noisy else "gossip", n_workers=N,
                           gamma=0.01, eta=0.4, target_epsilon=1.0, seed=seed)
    plan = proto.plan(proto.channel(), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn((N, d), generator=gen, device="cuda").to(dtype)
    g = (0.1 * torch.randn((N, d), generator=gen, device="cuda")).to(dtype)
    return proto, plan, p, g


def noise_branches(N: int, d: int, cw: int, seed: int, col0: int = 0,
                   device: str = "cuda") -> dict:
    """How many of a round's 2 N d normals take each branch: log1p's small
    (|t^2| < sqrt(2) - 1) or large one, and the erfinv tail (w >= 5,
    within |t| > 0.99), from the plain version's counters and hash bits
    (rows a chunk at a time)."""
    import torch
    from repro_torch.kernels import noise
    n = {"small": 0, "large": 0, "tail": 0}
    rows = max(1, (1 << 24) // d)
    for r0 in range(0, N, rows):
        idx2 = (noise.counters((min(rows, N - r0), d), cw, col0, r0,
                               device=device) * 2) & noise.MASK32
        for f in (0, 1):
            bits = noise.hash_bits(idx2 + f, seed)
            t = ((bits >> 8).to(torch.float32) - (float(1 << 23) - 0.5)) \
                * (1.0 / (1 << 23))
            x = t * -t
            small = x.abs() < noise._L1P_SMALL
            n["small"] += int(small.sum())
            n["large"] += int((~small).sum())
            far = x[t.abs() > 0.99]
            n["tail"] += int((-noise.log1p_xla(far) >= 5.0).sum())
    return n


def dp_mix_work(N: int, d: int, elem: int, noisy: bool, counts: dict,
                rates: dict, branches: Optional[dict] = None) -> dict:
    """The least time the card could take for a round, the longest of:
    its bytes (p, g read and out written once, W and the vectors) over
    3.35 TB/s; its instructions (each normal on the branches its t takes,
    from the SASS, and dp_mix_element_ops an element) over SMs x 128
    lanes x the SM clock; the mix's operations on the route an H100 takes
    at N (kernels.work.dp_mix_work): the column route's N^2 d fused
    multiply-adds at 67 TFLOP/s, the large-N route's 2 N^2 d operations at
    the TF32 tensor cores' 495 TFLOP/s, where the mix's N FMAs an element
    leave the instructions. On the large-N route also: split_ms, its own
    products (three TF32 products a product) at that peak; route_floor_ms,
    those and the prep's workspace traffic (p, g read, z and nf written);
    cuda_core_bound_ms, the route's bound with its mix on the CUDA cores.
    ``terms_ms`` keeps each term, ``cuda_core_terms_ms`` the CUDA cores'."""
    work = declared_dp_mix_work(N, d, elem)
    nbytes = work.nbytes
    instr = N * d * dp_mix_element_ops(N, noisy)
    if noisy:
        instr += (branches["small"] * counts["small"]
                  + branches["large"] * counts["large"]
                  + branches["tail"] * counts["tail_extra"])
    lanes = rates["sms"] * 128 * rates["sm_clock_hz"]
    t = {"bytes": nbytes / HBM_BYTES_PER_S, "instructions": instr / lanes,
         "fma": 2 * dp_mix_fmas(N, d) / F32_FLOP_PER_S}
    rec = {"bytes": nbytes, "fmas": dp_mix_fmas(N, d),
           "bytes_ms": 1e3 * t["bytes"], "fma_ms": 1e3 * t["fma"],
           "compute_class": work.compute_class}
    if work.compute_class == "tf32":
        cuda_core = t
        instr -= N * N * d
        t = {"bytes": t["bytes"], "instructions": instr / lanes,
             "tensor": work.flops / work.rate}
        prep = (2 * elem + (8 if noisy else 4)) * N * d / HBM_BYTES_PER_S
        rec.update({"tensor_ms": 1e3 * t["tensor"],
                    "split_ms": 1e3 * work.kernel_flops / work.rate,
                    "route_floor_ms": 1e3 * (prep + work.kernel_flops
                                             / work.rate),
                    "cuda_core_bound_ms": 1e3 * max(cuda_core.values()),
                    "cuda_core_terms_ms": {k: 1e3 * v
                                           for k, v in cuda_core.items()}})
    bound = max(t.values())
    rec.update({"lane_instructions": instr,
                "instructions_ms": 1e3 * t["instructions"],
                "terms_ms": {k: 1e3 * v for k, v in t.items()},
                "bound_ms": 1e3 * bound,
                "bound_by": "bytes" if t["bytes"] == bound else "operations"})
    return rec


def dp_mix_scale(p, g, gamma, plan, noisy) -> float:
    """The largest magnitude a round's mix sums: max|x| + max|n/c| +
    max|m_scale sigma_m Gm| (|G| <= 5.42 on the 24-bit lattice)."""
    x = p.float() - gamma * g.float()
    scale = float(x.abs().max())
    if noisy:
        scale += 5.42 * float((plan.amp / plan.c.reshape(())).abs().max()
                              + (plan.m_scale * plan.sigma_m).abs().max())
    return scale


def dp_mix_tolerance(N, p, g, gamma, plan, noisy, k32, r32, bf16):
    """|kernel - plain| allowed elementwise: both sum N products in float32
    in different orders, each within N 2^-24 sum_k |W_ik z_k| <= N 2^-24
    max|z| of the exact sum (W is stochastic); with the few roundings
    around the sum, (N + 8) 2^-23 scale, scale = max|x| + max|n/c| +
    max|m_scale sigma_m Gm| (|G| <= 5.42 on the 24-bit lattice). The noise
    itself is bitwise the same in both. A bfloat16 output may further land
    one bfloat16 step apart, 2^-7 of its magnitude. Returns (allowed,
    tol_f32)."""
    import torch
    tol = (N + 8) * 2.0 ** -23 * dp_mix_scale(p, g, gamma, plan, noisy)
    step = 2.0 ** -7 * torch.maximum(k32.abs(), r32.abs()) if bf16 else 0.0
    return tol + step, tol


def dp_mix_args(N, d, dtype, noisy, seed=1234567):
    """A case's operands as ops._launch takes them, and its keywords."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    proto, plan, p, g = dp_mix_case(N, d, dtype, noisy, seed=N)
    seed_t, col0 = (torch.tensor([s], dtype=torch.int32, device="cuda")
                    for s in (seed, 0))
    c = plan.c.reshape(())
    scal = torch.stack([c, plan.sigma_m.reshape(())])
    ones = torch.ones(N, device="cuda")
    args = (p, g, seed_t, col0, scal, plan.amp, ones, plan.m_scale, ones,
            plan.W.contiguous())
    kw = dict(gamma=proto.gamma, eta=proto.eta, noisy=noisy,
              counter_width=ops._roundup(d, ops.LANES))
    return proto, plan, args, kw


def dp_mix_route(N: int, d: int) -> str:
    """The route dp_mix's C launch takes at [N, d]."""
    from repro_torch.kernels.dp_mix import ops
    floats = ops._library().dp_mix_workspace_floats(N, d)
    return "columns" if floats == 0 else "large-N"


# the training path's kernels by the names a profiler trace gives them,
# and those a dp_mix_round call launches on each route
TRAIN_KERNELS = ("dp_mix_columns", "dp_mix_prep", "dp_mix_tiled",
                 "dp_mix_gather", "dp_perturb_kernel")
ROUTE_KERNELS = {"columns": ("dp_mix_columns",),
                 "large-N": ("dp_mix_prep", "dp_mix_tiled")}


def train_kernels(prof, names=TRAIN_KERNELS) -> dict:
    """{kernel: launches} of ``names`` (TRAIN_KERNELS) in a torch.profiler
    trace (a CUDA graph's replays included: the trace sees each kernel it
    launches)."""
    from torch.autograd import DeviceType
    got = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for name in names:
                if name in e.key:
                    got[name] = got.get(name, 0) + e.count
    return got


def traced(fn, names=TRAIN_KERNELS):
    """``fn()`` under torch.profiler's device trace: (its result,
    ``train_kernels`` of the trace for ``names``, the count of device
    operations in the trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    ops = sum(e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA)
    return res, train_kernels(prof, names), ops


TRACE_SESSIONS = 3


def traced_seen(fn, names=TRAIN_KERNELS, reset=None):
    """``traced(fn, names)`` of a repeatable ``fn``, in a new profiler
    session while the last one recorded no device operation at all (the
    trace, not the work, came back empty: seen once in a whole run, on a
    CUDA graph's replay after a dozen earlier sessions), at most
    TRACE_SESSIONS: (the kernels of ``names`` summed over every session,
    the last session's device operations, the sessions taken).
    ``reset()``, if given, runs before each session, outside it (to put
    back the state ``fn`` starts from)."""
    got = {}
    for n in range(1, TRACE_SESSIONS + 1):
        if reset is not None:
            reset()
        _, kernels, ops = traced(fn, names)
        for name, c in kernels.items():
            got[name] = got.get(name, 0) + c
        if ops:
            break
        print(f"[trace] profiler session {n} of {TRACE_SESSIONS} recorded no "
              f"device operation", flush=True)
    return got, ops, n


def cli_launches(what: str, launches: int, device: dict, rounds: int,
                 want: dict) -> None:
    """A counted CLI run's launches: the trace holds ``want`` (each of its
    kernels once a round) and no other training kernel; the wrapper,
    which counts its eager and captured rounds (a graph's replay runs no
    Python), at least once and at most once a round."""
    if device != want or not 1 <= launches <= rounds:
        fail(f"{what}: kernels in the trace {device} (want {want}), the "
             f"wrapper counted {launches}, for {rounds} rounds")


def check_dp_mix(N: int, d: int, dtype, noisy: bool, timed: bool,
                 counts: Optional[dict] = None,
                 rates: Optional[dict] = None) -> dict:
    """Kernel vs plain on the card (dp_mix_tolerance); timed: the kernel,
    the plain version and the bound (dp_mix_work)."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.kernels.dp_mix.dp_mix import dp_mix_plain
    proto, plan, args, kw = dp_mix_args(N, d, dtype, noisy)
    kernel = lambda: ops._launch(*args, **kw)
    plain = lambda: dp_mix_plain(*args, **kw)
    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    k32, r32 = out.float(), ref.float()
    del out, ref
    if not torch.isfinite(k32).all():
        fail(f"dp_mix N={N} {dtype} noisy={noisy}: non-finite output")
    p, g = args[0], args[1]
    allowed, tol = dp_mix_tolerance(N, p, g, proto.gamma, plan, noisy, k32,
                                    r32, dtype == torch.bfloat16)
    err = (k32 - r32).abs()
    max_err = float(err.max())
    bad = int((err > allowed).sum())
    del k32, r32, err, allowed
    rec = {"N": N, "d": d, "dtype": str(dtype).split(".")[-1],
           "noisy": noisy, "route": dp_mix_route(N, d),
           "max_abs_err": max_err, "tol_f32": tol, "violations": bad}
    if timed:
        rec["ms"] = cuda_ms(kernel, iters=20 if N <= 64 else 5)
        rec["plain_ms"] = cuda_ms(plain, iters=3, warmup=1)
        branches = (noise_branches(N, d, kw["counter_width"], 1234567)
                    if noisy else None)
        rec.update(dp_mix_work(N, d, p.element_size(), noisy, counts, rates,
                               branches))
        rec["branches"] = branches
    print(f"[kernels] dp_mix {json.dumps(rec)}", flush=True)
    if bad:
        fail(f"dp_mix N={N} {rec['dtype']} noisy={noisy}: {bad} elements "
             f"beyond tolerance (max err {max_err:.3g}, tol {tol:.3g})")
    return rec


def check_dp_mix_windows(N: int, d: int, counts: dict, rates: dict,
                         width: int = 4096,
                         plain_window: Optional[int] = None,
                         matmul: bool = False) -> dict:
    """A round too large for the plain version at full width (N = 2048 at
    the path's d: p, g and out 21 GB, the workspace 14 GB; olmo-1b's flat
    LM round, 1.49 G elements): the kernel once, held against the plain
    version over three column windows (the first, one in the middle, the
    ragged last), each with its col0 and the full counter_width, so the
    window draws the same noise; then timed, and with ``plain_window``
    the plain version too, over the whole round in windows that wide;
    with ``matmul``, torch.matmul(W, z) alone as a yardstick of the mix."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.kernels.dp_mix.dp_mix import dp_mix_plain
    proto, plan, args, kw = dp_mix_args(N, d, torch.float32, True)
    p, g, seed, _, *rest = args
    kernel = lambda: ops._launch(*args, **kw)
    out = kernel()
    torch.cuda.synchronize()
    max_err, bad, tol = 0.0, 0, 0.0
    last = d - (d % width or width)
    for a in (0, (d // 2) // width * width, last):
        b = min(a + width, d)
        col0 = torch.tensor([a], dtype=torch.int32, device="cuda")
        ref = dp_mix_plain(p[:, a:b].contiguous(), g[:, a:b].contiguous(),
                           seed, col0, *rest, **kw).float()
        k32 = out[:, a:b].float()
        allowed, tol = dp_mix_tolerance(N, p[:, a:b], g[:, a:b], proto.gamma,
                                        plan, True, k32, ref, False)
        err = (k32 - ref).abs()
        max_err = max(max_err, float(err.max()))
        bad += int((err > allowed).sum())
        if not torch.isfinite(k32).all():
            fail(f"dp_mix N={N}: non-finite output in columns [{a}, {b})")
    del out, ref, k32, err, allowed
    rec = {"N": N, "d": d, "dtype": "float32", "noisy": True,
           "route": dp_mix_route(N, d), "windows": 3, "window": width,
           "max_abs_err": max_err, "tol_f32": tol, "violations": bad,
           "ms": cuda_ms(kernel, iters=2, warmup=1)}
    if plain_window:
        torch.cuda.empty_cache()

        def plain(a):
            b = min(a + plain_window, d)
            col0 = torch.tensor([a], dtype=torch.int32, device="cuda")
            return dp_mix_plain(p[:, a:b].contiguous(),
                                g[:, a:b].contiguous(), seed, col0, *rest,
                                **kw)
        plain(0)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for a in range(0, d, plain_window):
            plain(a)
        end.record()
        torch.cuda.synchronize()
        rec["plain_ms"] = start.elapsed_time(end)
        rec["plain_window"] = plain_window
    if matmul:
        # the mix alone as one float32 GEMM (TF32 off in main): a yardstick,
        # labelled as such; the port never calls it. p has z's shape.
        W = rest[-1]
        rec["matmul_ms"] = cuda_ms(lambda: torch.matmul(W, p), iters=2,
                                   warmup=1)
        rec["matmul_note"] = ("torch.matmul(W, z) in float32, highest "
                              "precision: the mix alone, a yardstick")
        torch.cuda.empty_cache()
    branches = noise_branches(N, d, kw["counter_width"], 1234567)
    rec.update(dp_mix_work(N, d, 4, True, counts, rates, branches))
    rec["branches"] = branches
    print(f"[kernels] dp_mix {json.dumps(rec)}", flush=True)
    if bad:
        fail(f"dp_mix N={N} windows: {bad} elements beyond tolerance "
             f"(max err {max_err:.3g})")
    return rec


def dp_mix_exact(p, g, seed, col0, scal, amp, selfs, mscale, listen, W, *,
                 gamma: float, eta: float, noisy: bool,
                 counter_width: int):
    """dp_mix_plain's round in float64 from the same float32 x, n/c and
    noise fields: the exact sums that the kernel's and the plain version's
    float32 ones approximate."""
    import torch
    from repro_torch.kernels import noise
    N, D = p.shape
    x = p.float() - gamma * g.float()
    col = lambda v: v.reshape(N, 1).double()
    if noisy:
        g_n, g_m = noise.normal_pair_hash(
            (N, D), counter_width, col0.reshape(-1)[0], seed.reshape(-1)[0],
            device=p.device)
        nf = (amp.reshape(N, 1) / scal[0]) * g_n
        upd = (W.double() @ (x.double() + nf.double())
               - col(selfs) * nf.double()
               + col(mscale) * float(scal[1]) * g_m.double())
    else:
        upd = W.double() @ x.double()
    return x.double() + eta * col(listen) * (upd - x.double())


def dp_mix_split_tolerance(N: int, scale: float) -> float:
    """|kernel - exact| allowed on the large-N route, sqrt(N) 2^-23 scale:
    the size of N float32 roundings of random sign. Split TF32 keeps each
    product within 2^-21 of float32's; one TF32 pass (the lo products
    dropped) errs 2^-11 a product, past this bound wherever a row has few
    weights (14 of these units on a ring at N = 2048, 5-88 at N = 64-300,
    in tests/test_torch_dp_mix_split.py's emulation, where the split errs
    at most 0.04), while dp_mix_tolerance's (N + 8) 2^-23 scale, 45 of
    these units at N = 2048, would let it pass."""
    return N ** 0.5 * 2.0 ** -23 * scale


def check_dp_mix_precision(N: int, d: int, kind: str) -> dict:
    """The large-N route in split TF32 held to dp_mix_split_tolerance
    against the exact round (dp_mix_exact, float64), float32 noisy under
    the ring's plan (three weights a row) or the complete graph's, beside
    the plain version's own float32 error."""
    import torch
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.kernels.dp_mix.dp_mix import dp_mix_plain
    predict("split_precision")
    proto = ProtocolConfig(n_workers=N, gamma=0.01, eta=0.4,
                           target_epsilon=1.0, seed=N,
                           topology="ring" if kind == "ring" else "complete")
    plan = proto.plan(proto.channel(), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(N + d)
    p = torch.randn((N, d), generator=gen, device="cuda")
    g = 0.1 * torch.randn((N, d), generator=gen, device="cuda")
    seed, col0 = (torch.tensor([s], dtype=torch.int32, device="cuda")
                  for s in (1234567, 0))
    ones = torch.ones(N, device="cuda")
    args = (p, g, seed, col0,
            torch.stack([plan.c.reshape(()), plan.sigma_m.reshape(())]),
            plan.amp, ones, plan.m_scale, ones, plan.W.contiguous())
    kw = dict(gamma=proto.gamma, eta=proto.eta, noisy=True,
              counter_width=ops._roundup(d, ops.LANES))
    exact = dp_mix_exact(*args, **kw)
    err = lambda out: float((out.double() - exact).abs().max())
    scale = dp_mix_scale(p, g, proto.gamma, plan, True)
    tol = dp_mix_split_tolerance(N, scale)
    rec = {"plan": kind, "N": N, "d": d, "route": dp_mix_route(N, d),
           "max_abs_err_vs_float64": err(ops._launch(*args, **kw)),
           "plain_max_abs_err_vs_float64": err(dp_mix_plain(*args, **kw)),
           "scale": scale, "tol": tol}
    rec["err_over_tol"] = rec["max_abs_err_vs_float64"] / tol
    print(f"[kernels] dp_mix split precision {json.dumps(rec)}", flush=True)
    if rec["route"] != "large-N" or not rec["err_over_tol"] <= 1.0:
        fail(f"dp_mix's large-N route under the {kind} plan at N={N}: "
             f"{rec['max_abs_err_vs_float64']:.3g} from the exact round, "
             f"beyond sqrt(N) 2^-23 scale = {tol:.3g}")
    return rec


def check_noise_fields(N: int, d: int) -> dict:
    """Both noise fields through the kernel, bitwise the plain version's:
    p = g = 0, W = I, amp = c = 1, self = m_scale = 0, eta = listen = 1
    gives out = Gn; W = 0, amp = self = 0, m_scale = sigma_m = 1 gives
    out = Gm (every sum has one nonzero term, so no order shows)."""
    import torch
    from repro_torch.kernels import noise
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.kernels.dp_mix.dp_mix import dp_mix_plain
    zeros = torch.zeros((N, d), device="cuda")
    seed, col0 = (torch.tensor([s], dtype=torch.int32, device="cuda")
                  for s in (1234567, 0))
    one, zero = torch.ones(N, device="cuda"), torch.zeros(N, device="cuda")
    scal = torch.ones(2, device="cuda")
    cw = ops._roundup(d, ops.LANES)
    kw = dict(gamma=0.0, eta=1.0, noisy=True, counter_width=cw)
    fields = noise.normal_pair_hash((N, d), cw, 0, 1234567, device="cuda")
    rec = {"N": N, "d": d, "route": dp_mix_route(N, d)}
    for name, field, amp, ms, W in (
            ("Gn", fields[0], one, zero, torch.eye(N, device="cuda")),
            ("Gm", fields[1], zero, one, torch.zeros((N, N), device="cuda"))):
        args = (zeros, zeros, seed, col0, scal, amp, zero, ms, one, W)
        bits = lambda t: t.contiguous().view(torch.int32)
        out = ops._launch(*args, **kw)
        ref = dp_mix_plain(*args, **kw)
        torch.cuda.synchronize()
        rec[f"{name}_differ"] = int((bits(out) != bits(ref)).sum())
        rec[f"{name}_plain_vs_field_differ"] = int(
            (bits(ref) != bits(field)).sum())
        del out, ref
    del fields
    rec["branches"] = noise_branches(N, d, cw, 1234567)
    print(f"[kernels] dp_mix noise fields {json.dumps(rec)}", flush=True)
    if any(v for k, v in rec.items() if k.endswith("differ")):
        fail(f"dp_mix noise fields not bitwise the plain version's: {rec}")
    return rec


def flat_cli(workers: int, steps: int) -> dict:
    """The flat CLI at ``workers`` (its chunks through ChunkRunner: the
    first eager, the rest CUDA graph replays) under the profiler's device
    trace, dp_mix's count set to 0 just before and read just after: the
    trace holds one launch a round of each kernel of dp_mix's route and
    no other training kernel (``cli_launches``); every loss finite."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.launch import train
    ops.dp_mix_round.launches = 0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    res, device, _ = traced(lambda: train.run([
        "--arch", "dwfl-paper", "--flat-buffer", "--workers", str(workers),
        "--batch-size", "32", "--steps", str(steps), "--eval-every",
        str(steps // 2), "--device", "cuda"]))
    launches = ops.dp_mix_round.launches
    peak = torch.cuda.max_memory_allocated()
    losses, rounds = res["losses"], res["rounds"]
    route = dp_mix_route(workers, PATH_D)
    print(f"[train] N = {workers}: {rounds} rounds in {res['seconds']:.3f}s "
          f"= {rounds / res['seconds']:.2f} rounds/s (traced); peak device "
          f"memory {peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB held "
          f"before the run); dp_mix ({route} route) counted {launches}, "
          f"kernels in the trace {device}; first/last loss "
          f"{float(losses[0]):.4f}/{float(losses[-1]):.4f}", flush=True)
    if losses.numel() != rounds or not torch.isfinite(losses).all():
        fail(f"train N={workers}: expected {rounds} finite losses, got "
             f"{losses.tolist()}")
    cli_launches(f"train N={workers}", launches, device, rounds,
                 {k: rounds for k in ROUTE_KERNELS[route]})
    if not torch.isfinite(res["params"]).all():
        fail(f"train N={workers}: non-finite parameters")
    return {"launches": launches, "device_launches": device,
            "rounds": rounds}


def predict(phase: str) -> None:
    print(f"[predict] {phase}: {PREDICTIONS[phase]}", flush=True)


def dynamic_proto(N: int, scenario: str = DYN_SCENARIO, **kw):
    from repro_torch.core.protocol import ProtocolConfig
    return ProtocolConfig(n_workers=N, gamma=0.01, eta=0.4,
                          target_epsilon=1.0, channel_model="dynamic",
                          scenario=scenario, **kw)


def dynamic_round(N: int, seed: int = 0):
    """A churned iot_dense round of the port's simulator on the card: the
    first whose W has identity rows (a worker churned out, so listen = 0)
    beside at least two listening workers and a Metropolis W. Returns
    (proto, plan, chan, W)."""
    import torch
    proto = dynamic_proto(N)
    sim = proto.simulator("cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = sim.init(gen)
    for _ in range(200):
        state, chan, mask, W = sim.round(gen, state)
        plan = proto.plan(chan, "cuda", W)
        idle = plan.listen == 0
        if bool((~mask).any()) and int((~idle).sum()) >= 2:
            return proto, plan, chan, W
    fail(f"no churned iot_dense round at N = {N} in 200 rounds")


def mix_plans(N: int) -> dict:
    """dp_mix's plans of this slice at N workers: the dynamic round's, the
    sampled one with every other worker silent (half of self_scale 0) and
    the ring's (a sparse W, m_scale 1/(c deg))."""
    import torch
    from repro_torch.core import exchange as X
    from repro_torch.core.protocol import ProtocolConfig
    kw = dict(n_workers=N, gamma=0.01, eta=0.4, target_epsilon=1.0)
    sampled = ProtocolConfig(participation=0.5, **kw)
    ring = ProtocolConfig(topology="ring", **kw)
    return {"dynamic": dynamic_round(N)[:2],
            "sampled": (sampled, X.plan_sampled(
                sampled, sampled.channel(), "cuda",
                torch.arange(N, device="cuda") % 2 == 0)),
            "ring": (ring, ring.plan(ring.channel(), "cuda"))}


def check_dp_mix_plan(name: str, proto, plan, N: int, d: int, dtype) -> dict:
    """dp_mix under one of this slice's plans against its plain twin on
    the card (dp_mix_tolerance), and the rows with listen = 0 — no noise,
    no mix: p - gamma g — within 1 ULP of the plain twin's (in the output's
    dtype)."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.kernels.dp_mix.dp_mix import dp_mix_plain
    gen = torch.Generator(device="cuda").manual_seed(N + d)
    p = torch.randn((N, d), generator=gen, device="cuda").to(dtype)
    g = (0.1 * torch.randn((N, d), generator=gen, device="cuda")).to(dtype)
    seed, col0 = (torch.tensor([s], dtype=torch.int32, device="cuda")
                  for s in (1234567, 0))
    c = plan.c.reshape(())
    ones = torch.ones(N, device="cuda")
    vec = lambda v: ones if v is None else v
    args = (p, g, seed, col0, torch.stack([c, plan.sigma_m.reshape(())]),
            plan.amp, vec(plan.self_scale), plan.m_scale, vec(plan.listen),
            plan.W.contiguous())
    kw = dict(gamma=proto.gamma, eta=proto.eta, noisy=True,
              counter_width=ops._roundup(d, ops.LANES))
    out = ops._launch(*args, **kw)
    ref = dp_mix_plain(*args, **kw)
    torch.cuda.synchronize()
    k32, r32 = out.float(), ref.float()
    del out, ref
    if not torch.isfinite(k32).all():
        fail(f"dp_mix {name} N={N} {dtype}: non-finite output")
    bf16 = dtype == torch.bfloat16
    allowed, tol = dp_mix_tolerance(N, p, g, proto.gamma, plan, True, k32,
                                    r32, bf16)
    err = (k32 - r32).abs()
    rec = {"plan": name, "N": N, "d": d, "dtype": str(dtype).split(".")[-1],
           "route": dp_mix_route(N, d), "max_abs_err": float(err.max()),
           "tol_f32": tol, "violations": int((err > allowed).sum()),
           "self_zero": int((vec(plan.self_scale) == 0).sum()),
           "listen_zero": int((vec(plan.listen) == 0).sum())}
    del err, allowed
    idle = vec(plan.listen) == 0
    if bool(idle.any()):
        ulps = ulp_dist(k32[idle], r32[idle])
        rec["idle_max_ulp"] = int(ulps.max()) // (1 << 16 if bf16 else 1)
    print(f"[kernels] dp_mix plan {json.dumps(rec)}", flush=True)
    if rec["violations"] or rec.get("idle_max_ulp", 0) > 1:
        fail(f"dp_mix under the {name} plan at N={N} {rec['dtype']}: {rec}")
    return rec


def dp_mix_plans_phase() -> list:
    """dp_mix under the dynamic, sampled and ring plans at the path's shape
    in float32 and bfloat16, and the dynamic plan also at N = 50 and 51."""
    import torch
    predict("plans")
    recs = []
    for N in DYN_PLAN_N:
        plans = mix_plans(N)
        for name in (plans if N == PATH_N else ("dynamic",)):
            for dtype in (torch.float32, torch.bfloat16):
                recs.append(check_dp_mix_plan(name, *plans[name], N, PATH_D,
                                              dtype))
                torch.cuda.empty_cache()
    routes = {r["route"] for r in recs if r["plan"] == "dynamic"}
    if routes != {"columns", "large-N"}:
        fail(f"the dynamic plan ran on the routes {routes}, not on both")
    return recs


def dynamic_cli() -> dict:
    """The dynamic flat CLI at full width (iot_dense, N = 10, 51 rounds)
    under the profiler's device trace, dp_mix's count set to 0 just
    before and read just after: one launch a round in the trace
    (``cli_launches``), every loss finite, the epsilon trajectory over
    every round; then vehicular under a total budget (--total-epsilon 8
    --accountant rdp), 5 rounds. Returns {scenario: (the wrapper's count,
    the trace's kernels)}."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.launch import train
    predict("dynamic_cli")
    counts = {}
    for scenario, steps, extra in (
            (DYN_SCENARIO, DYN_STEPS, []),
            ("vehicular", 4, ["--total-epsilon", "8", "--accountant", "rdp"])):
        ops.dp_mix_round.launches = 0
        res, device, _ = traced(lambda: train.run([
            "--arch", "dwfl-paper", "--flat-buffer", "--channel-model",
            "dynamic", "--scenario", scenario, "--workers", str(PATH_N),
            "--batch-size", "32", "--steps", str(steps), "--eval-every",
            str(max(steps // 2, 1)), "--device", "cuda", *extra]))
        launches = ops.dp_mix_round.launches
        rep, losses, rounds = res["epsilon_report"], res["losses"], res["rounds"]
        rec = {"scenario": scenario, "rounds": rounds,
               "seconds": res["seconds"],
               "rounds_per_s_traced": rounds / res["seconds"],
               "launches": launches, "device_launches": device,
               "first_loss": float(losses[0]), "last_loss": float(losses[-1]),
               "eps_rounds": rep["rounds"], "eps_worst": rep["epsilon_worst"],
               "eps_total": rep["epsilon_total"],
               "eps_rdp": rep["epsilon_rdp"]}
        print(f"[dynamic] cli {json.dumps(rec)}", flush=True)
        cli_launches(f"dynamic cli {scenario}", launches, device, rounds,
                     {k: rounds for k in ROUTE_KERNELS[
                         dp_mix_route(PATH_N, PATH_D)]})
        if rep["rounds"] != rounds:
            fail(f"dynamic cli {scenario}: epsilon over {rep['rounds']} "
                 f"rounds, for {rounds} rounds")
        if not (torch.isfinite(losses).all()
                and torch.isfinite(res["params"]).all()
                and np_finite(rep["epsilon_per_round"])):
            fail(f"dynamic cli {scenario}: non-finite losses, parameters or "
                 f"epsilons")
        if extra and rep["epsilon_rdp"] > 8.0 * (1 + 1e-6):
            fail(f"dynamic cli {scenario}: rdp total {rep['epsilon_rdp']} "
                 f"over its budget of 8")
        counts[scenario] = (launches, device)
    return counts


def np_finite(a) -> bool:
    import numpy as np
    return bool(np.isfinite(np.asarray(a)).all())


def dynamic_tree(store) -> int:
    """The dynamic worker-tree round at full width through
    make_dynamic_train_step (drone_sparse, use_pallas=True) in the
    trajectory body, the dp_perturb counts set to 0 just before and read
    just after: one sgd_update_leaves launch a round."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    from repro_torch.kernels.dp_perturb import ops
    predict("dynamic_tree")
    proto = dynamic_proto(PATH_N, DYN_TREE_SCENARIO, use_pallas=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    wp = P.init_worker_params(gen, DWFL_PAPER, PATH_N, "cuda")
    sim = proto.simulator("cuda")
    body = TJ.make_round_body(DWFL_PAPER, proto, store, device="cuda",
                              sim=sim)
    carry = TJ.TrajCarry(gen, wp, sim.init(gen))
    ops.sgd_update_leaves.launches = 0
    ops.sgd_update.launches = ops.dp_perturb.launches = 0
    carry, out = TJ.run_chunk(body, carry, TREE_ROUNDS)
    torch.cuda.synchronize()
    launches = ops.sgd_update_leaves.launches
    others = ops.sgd_update.launches + ops.dp_perturb.launches
    rep = P.epsilon_report(proto, out["chan"], Ws=out["W"])
    losses = out["metrics"]["loss"].cpu()
    rec = {"scenario": DYN_TREE_SCENARIO, "rounds": TREE_ROUNDS,
           "launches": launches, "first_loss": float(losses[0]),
           "last_loss": float(losses[-1]), "eps_worst": rep["epsilon_worst"]}
    print(f"[dynamic] tree {json.dumps(rec)}", flush=True)
    if launches != TREE_ROUNDS or others:
        fail(f"dynamic tree: sgd_update_leaves launched {launches} times for "
             f"{TREE_ROUNDS} rounds, the per-leaf wrappers {others} times")
    if not (torch.isfinite(losses).all() and tree_leaves_finite(carry.params)
            and np_finite(rep["epsilon_per_round"])):
        fail("dynamic tree: non-finite losses, parameters or epsilons")
    return launches


def dynamic_round_cpu_vs_cuda() -> float:
    """One dynamic flat round (hidden 16, N = 10, iot_dense) on the card
    against the same round on the CPU from the same replayed channel, W,
    buffer, batch and seed (within 1e-4 (1 + max|x|): the gradients'
    products differ); and its dp_mix part from the same gradients within
    dp_mix_tolerance."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.kernels.dp_mix import ops
    predict("cpu_vs_cuda")
    cfg = dataclasses.replace(DWFL_PAPER, d_model=16)
    proto = dynamic_proto(PATH_N)
    sim = proto.simulator("cpu")
    gen = torch.Generator().manual_seed(7)
    state = sim.init(gen)
    for _ in range(3):
        state, chan, _, W = sim.round(gen, state)
    wp = P.init_worker_params(gen, cfg, PATH_N, "cpu")
    spec = X.FlatSpec(wp)
    flat = spec.flatten(wp)
    batch = {"x": torch.randn((PATH_N, 8, 3072), generator=gen),
             "y": torch.randint(0, 10, (PATH_N, 8), generator=gen)}
    seed = torch.tensor([99], dtype=torch.int32)
    to = lambda tree, dev: X.tree_map(lambda t: t.to(dev), tree)
    outs, mixes = {}, {}
    g = P.make_flat_local_pass(cfg, proto, spec)(flat, batch)[1]
    for dev in ("cpu", "cuda"):
        step = P.make_dynamic_flat_train_step(cfg, proto, spec, dev)
        out, _ = step(flat.to(dev), to(batch, dev), seed.to(dev),
                      chan.to(dev), W.to(dev))
        outs[dev] = out.cpu()
        plan = proto.plan(chan.to(dev), dev, W.to(dev))
        mixes[dev] = ops.dp_mix_round_plan(
            flat.to(dev), g.to(dev), seed.to(dev), plan, gamma=proto.gamma,
            eta=proto.eta).cpu()
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    tol = 1e-4 * (1.0 + float(outs["cpu"].abs().max()))
    allowed, mix_tol = dp_mix_tolerance(PATH_N, flat, g, proto.gamma, plan,
                                        True, mixes["cuda"], mixes["cpu"],
                                        False)
    mix_err = float((mixes["cuda"] - mixes["cpu"]).abs().max())
    print(f"[dynamic] small round cuda vs cpu: max_abs_err={err:.3g} "
          f"(tol {tol:.3g}); its dp_mix: max_abs_err={mix_err:.3g} "
          f"(tol {mix_tol:.3g})", flush=True)
    if not math.isfinite(err) or err > tol or mix_err > mix_tol:
        fail(f"dynamic round: cuda and cpu differ by {err:.3g} (tol "
             f"{tol:.3g}), their dp_mix by {mix_err:.3g} (tol {mix_tol:.3g})")
    return err


def dynamic_round_sync_free(store) -> dict:
    """A warm full-width dynamic flat round with the device's synchronizing
    calls made errors (torch.cuda.set_sync_debug_mode("error")): first
    around sim.round, plan_dynamic and the dp_mix call, which must pass;
    then around the whole round body (batch, gradients, metrics), noted.
    A .item() under the same mode must raise, or the guard guards
    nothing."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    from repro_torch.kernels.dp_mix import ops
    predict("sync")
    proto = dynamic_proto(PATH_N)
    gen = torch.Generator(device="cuda").manual_seed(0)
    wp = P.init_worker_params(gen, DWFL_PAPER, PATH_N, "cuda")
    spec = X.FlatSpec(wp)
    sim = proto.simulator("cuda")
    body = TJ.make_round_body(DWFL_PAPER, proto, store, spec, "cuda", sim=sim)
    carry, _ = TJ.run_chunk(body, TJ.TrajCarry(gen, spec.flatten(wp),
                                               sim.init(gen)), 3)
    g = P.make_flat_local_pass(DWFL_PAPER, proto, spec)(
        carry.params, store.draw(gen))[1]
    probe = torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    rec, out = {}, None
    torch.cuda.set_sync_debug_mode("error")
    try:
        try:
            net, chan, _, W = sim.round(gen, carry.net)
            plan = proto.plan(chan, "cuda", W)
            out = ops.dp_mix_round_plan(carry.params, g, TJ.round_seed(gen),
                                        plan, gamma=proto.gamma,
                                        eta=proto.eta)
            rec["round_sync_free"] = True
        except RuntimeError as e:
            rec["round_sync_free"] = False
            rec["round_error"] = str(e).splitlines()[0]
        try:
            body(TJ.TrajCarry(gen, carry.params, carry.net))
            rec["body_sync_free"] = True
        except RuntimeError as e:
            rec["body_sync_free"] = False
            rec["body_error"] = str(e).splitlines()[0]
        try:
            probe.sum().item()
            rec["guard_raises"] = False
        except RuntimeError:
            rec["guard_raises"] = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"[dynamic] sync debug mode 'error': {json.dumps(rec)}", flush=True)
    if not (rec["round_sync_free"] and rec["guard_raises"]):
        fail(f"the dynamic round synchronizes with the host: {rec}")
    if not torch.isfinite(out).all():
        fail("the guarded dynamic round gave non-finite parameters")
    return rec


def profile_simulator(n_rounds: int = 20) -> dict:
    """The simulator's round alone (iot_dense, N = 10, the CLI's
    calibration): host time per round around n_rounds ending in a
    synchronize, and under torch.profiler its launches and busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sim = dynamic_proto(PATH_N).simulator("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = sim.init(gen)
    for _ in range(5):
        state, *_ = sim.round(gen, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        state, *_ = sim.round(gen, state)
    torch.cuda.synchronize()
    round_ms = 1e3 * (time.perf_counter() - t0) / n_rounds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_rounds):
            state, *_ = sim.round(gen, state)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    stats = prof.key_averages()
    busy_us = device_us(stats)
    launches = sum(e.count for e in stats if e.key == "cudaLaunchKernel")
    rec = {"path": "simulator", "round_ms": round_ms, "rounds": n_rounds,
           "profiled_round_ms": wall_us / 1e3 / n_rounds,
           "launches_per_round": launches / n_rounds,
           "device_us_per_round": busy_us / n_rounds,
           "device_busy_share": (busy_us / wall_us if busy_us > 0
                                 else "not measured"),
           "top_host_us_per_round": [
               (e.key, e.self_cpu_time_total / n_rounds) for e in
               sorted(stats, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:8]]}
    print(f"[profile] {json.dumps(rec)}", flush=True)
    return rec


def round_turns(store, when: str, n_rounds: int = 30) -> dict:
    """The static and the dynamic flat round at full width, and the
    simulator's round alone, each warm, timed by the host clock around
    ``n_rounds`` rounds ending in a synchronize, in turns (static,
    dynamic, simulator, simulator, dynamic, static): the host's speed
    drifts within a call, so the three are compared only side by side.
    ``when`` names the point of the run (the phases before it), printed
    with the Python objects the collector tracks then."""
    import gc
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    ticks = {}
    for name in ("static", "dynamic"):
        proto = (dynamic_proto(PATH_N) if name == "dynamic" else
                 P.ProtocolConfig(n_workers=PATH_N, gamma=0.01, eta=0.4,
                                  target_epsilon=1.0))
        gen = torch.Generator(device="cuda").manual_seed(0)
        wp = P.init_worker_params(gen, DWFL_PAPER, PATH_N, "cuda")
        spec = X.FlatSpec(wp)
        sim = proto.simulator("cuda") if name == "dynamic" else None
        body = TJ.make_round_body(DWFL_PAPER, proto, store, spec, "cuda",
                                  sim=sim)
        state = {"carry": TJ.TrajCarry(gen, spec.flatten(wp),
                                       sim.init(gen) if sim else None)}

        def tick(body=body, state=state):
            state["carry"] = body(state["carry"])[0]

        ticks[name] = tick
    net = {"state": sim.init(gen)}

    def sim_tick():
        net["state"] = sim.round(gen, net["state"])[0]

    ticks["simulator"] = sim_tick
    for tick in ticks.values():
        for _ in range(5):
            tick()
    ms = {name: [] for name in ticks}
    for name in ("static", "dynamic", "simulator", "simulator", "dynamic",
                 "static"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_rounds):
            ticks[name]()
        torch.cuda.synchronize()
        ms[name].append(1e3 * (time.perf_counter() - t0) / n_rounds)
    rec = {"when": when, "gc_objects": len(gc.get_objects()),
           "rounds": n_rounds, "round_ms": ms,
           "dynamic_minus_static_ms": [d - s for d, s in
                                       zip(ms["dynamic"], ms["static"])],
           "simulator_share_of_dynamic": [
               s / d for s, d in zip(ms["simulator"], ms["dynamic"])]}
    print(f"[profile] in turns {json.dumps(rec)}", flush=True)
    return rec


def cli_turns(steps: int = 50) -> dict:
    """The flat CLI on the static and on the dynamic (iot_dense) channel,
    warm and without evals, in turns (static, dynamic, dynamic, static):
    rounds/s of each, as the CLI measures it (its loop, ending in a
    synchronize)."""
    from repro_torch.launch import train
    rate = {"static": [], "dynamic": []}
    for name in ("static", "dynamic", "dynamic", "static"):
        extra = (["--channel-model", "dynamic", "--scenario", DYN_SCENARIO]
                 if name == "dynamic" else [])
        res = train.run(["--arch", "dwfl-paper", "--flat-buffer",
                         "--workers", str(PATH_N), "--steps", str(steps),
                         "--eval-every", "0", "--device", "cuda", *extra])
        rate[name].append(res["rounds"] / res["seconds"])
    print(f"[profile] cli in turns, rounds/s {json.dumps(rate)}", flush=True)
    return rate


# ---- the sparse round (neighbor-list mixing, ROADMAP A10) -------------------


def sparse_proto(N: int, **kw):
    """The worker-scale path's protocol: mesh_sparse with a degree cap of
    SPARSE_K."""
    return dynamic_proto(N, SPARSE_SCENARIO, sparse_neighbors=SPARSE_K, **kw)


def sparse_round(N: int, seed: int = 0):
    """A mesh_sparse round of the port's simulator on the card at N
    workers: (proto, plan, chan, W), W a SparseW, the plan
    plan_dynamic_sparse's."""
    import torch
    proto = sparse_proto(N)
    sim = proto.simulator("cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state, chan, _, W = sim.round(gen, sim.init(gen))
    return proto, proto.plan(chan, "cuda", W), chan, W


def sparse_args(plan, p, g, seed: int = 1234567, col0: int = 0):
    """A sparse round's operands as ops._launch_sparse takes them."""
    import torch
    N = p.shape[0]
    seed_t, col0_t = (torch.tensor([s], dtype=torch.int32, device="cuda")
                      for s in (seed, col0))
    c = plan.c.reshape(())
    ones = torch.ones(N, device="cuda")
    return (p, g, seed_t, col0_t, torch.stack([c, plan.sigma_m.reshape(())]),
            plan.amp, ones, plan.m_scale, plan.listen,
            plan.W.idx.contiguous(), plan.W.w.contiguous(),
            plan.W.self_w.contiguous())


def sparse_element_ops(slots: float, noisy: bool) -> float:
    """dp_mix_element_ops with the mix's N products replaced by the
    element's realized slots and its self term."""
    return 2 + (7 if noisy else 1) + 1 + slots + 1


def sparse_work(N: int, d: int, k: int, elem: int, noisy: bool, nnz: int,
                counts: dict, rates: dict, branches: Optional[dict]) -> dict:
    """The least time the card could take for a sparse round, the longest
    of: its bytes (p and g read, out written once, the neighbor list and
    the vectors) over 3.35 TB/s; its instructions (each normal on the
    branches its t takes, from the SASS, and sparse_element_ops at this
    run's mean realized slots an element) over SMs x 128 lanes x the SM
    clock; the mix's (nnz + N) d fused multiply-adds (the realized slots
    and the self term) at 67 TFLOP/s. Beside it, the design's own floor:
    the prep writes z and nf (float32) and the gather reads p, g, nf and z
    once, so 2 (elem + 8) + elem bytes an element (gathered_from_hbm_ms:
    each of the k gathered rows of z from HBM as well)."""
    nbytes = sparse_bytes(N, d, k, elem)
    instr = N * d * sparse_element_ops(nnz / N, noisy)
    if noisy:
        instr += (branches["small"] * counts["small"]
                  + branches["large"] * counts["large"]
                  + branches["tail"] * counts["tail_extra"])
    t = {"bytes": nbytes / HBM_BYTES_PER_S,
         "instructions": instr / (rates["sms"] * 128 * rates["sm_clock_hz"]),
         "fma": 2 * sparse_fmas(N, d, nnz) / F32_FLOP_PER_S}
    bound = max(t.values())
    ws = (2 * elem + (8 if noisy else 4)) + (2 * elem + (8 if noisy else 4)
                                             + elem)
    return {"bytes": nbytes, "lane_instructions": instr,
            "fmas": sparse_fmas(N, d, nnz), "bytes_ms": 1e3 * t["bytes"],
            "instructions_ms": 1e3 * t["instructions"],
            "fma_ms": 1e3 * t["fma"], "bound_ms": 1e3 * bound,
            "bound_by": "bytes" if t["bytes"] == bound else "operations",
            "workspace_bytes": N * d * ws,
            "workspace_floor_ms": 1e3 * N * d * ws / HBM_BYTES_PER_S,
            "gathered_from_hbm_ms": 1e3 * N * d * (ws + 4 * k)
            / HBM_BYTES_PER_S}


def check_sparse(N: int, d: int, dtype, noisy: bool, counts: dict,
                 rates: dict, timed: bool, width: int = 4096) -> dict:
    """The sparse round (dp_mix_prep + dp_mix_gather) at [N, d] on a
    mesh_sparse round's neighbor list, once, held against its plain twin
    over three column windows (the first, one in the middle, the ragged
    last), each with its col0 and the full counter_width so it draws the
    same noise; tolerance dp_mix_tolerance with the k + 1 terms of the
    mix in place of N. The kernel takes the receivers in the list's key
    order, as the wrapper does. Timed: the kernel, the plain twin over the
    whole round in windows of 2^16 columns, and the bound (sparse_work)."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.kernels.dp_mix.dp_mix import dp_mix_sparse_plain
    from repro_torch.net.sparse import isolated_count
    proto, plan, _, W = sparse_round(N)
    gen = torch.Generator(device="cuda").manual_seed(N + d)
    p = torch.randn((N, d), generator=gen, device="cuda").to(dtype)
    g = (0.1 * torch.randn((N, d), generator=gen, device="cuda")).to(dtype)
    args = sparse_args(plan, p, g)
    kw = dict(gamma=proto.gamma, eta=proto.eta, noisy=noisy,
              counter_width=ops._roundup(d, ops.LANES))
    order = ops.locality_order(W, N, "cuda")   # the wrapper's: the list's key
    kernel = lambda: ops._launch_sparse(*args, **kw, order=order)
    out = kernel()
    torch.cuda.synchronize()
    seed, _, *rest = args[2:]

    def window(a, b):
        col0 = torch.tensor([a], dtype=torch.int32, device="cuda")
        return dp_mix_sparse_plain(p[:, a:b].contiguous(),
                                   g[:, a:b].contiguous(), seed, col0, *rest,
                                   **kw)

    max_err, bad, tol = 0.0, 0, 0.0
    k = W.k
    for a in (0, (d // 2) // width * width, d - (d % width or width)):
        b = min(a + width, d)
        ref = window(a, b).float()
        k32 = out[:, a:b].float()
        if not torch.isfinite(k32).all():
            fail(f"sparse round N={N}: non-finite output in [{a}, {b})")
        allowed, tol = dp_mix_tolerance(k + 1, p[:, a:b], g[:, a:b],
                                        proto.gamma, plan, noisy, k32, ref,
                                        dtype == torch.bfloat16)
        err = (k32 - ref).abs()
        max_err = max(max_err, float(err.max()))
        bad += int((err > allowed).sum())
        del ref, k32, err, allowed
    del out
    nnz = int(W.valid().sum())
    rec = {"N": N, "d": d, "k": k, "dtype": str(dtype).split(".")[-1],
           "noisy": noisy, "realized_slots": nnz,
           "isolated": int(isolated_count(W)), "windows": 3, "window": width,
           "max_abs_err": max_err, "tol_f32": tol, "violations": bad}
    if timed:
        rec["ms"] = cuda_ms(kernel, iters=3, warmup=1)
        torch.cuda.empty_cache()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        window(0, min(d, 1 << 16))
        torch.cuda.synchronize()
        start.record()
        for a in range(0, d, 1 << 16):
            window(a, min(a + (1 << 16), d))
        end.record()
        torch.cuda.synchronize()
        rec["plain_ms"] = start.elapsed_time(end)
        branches = (noise_branches(N, d, kw["counter_width"], 1234567)
                    if noisy else None)
        rec.update(sparse_work(N, d, k, p.element_size(), noisy, nnz, counts,
                               rates, branches))
        rec["branches"] = branches
    print(f"[kernels] dp_mix sparse {json.dumps(rec)}", flush=True)
    if bad:
        fail(f"sparse round N={N} {rec['dtype']} noisy={noisy}: {bad} "
             f"elements beyond tolerance (max err {max_err:.3g})")
    return rec


def check_sparse_against_dense(N: int, d: int, col0: int) -> dict:
    """With every slot weight and self_w 0 the sparse round is v alone:
    bitwise the dense kernel's round with W = 0 at the same seed, col0 and
    counter_width (the noise fields of both, and v, the same arithmetic).
    With the round's own neighbor list, the sparse kernel against the
    dense kernel given SparseW.dense() (N = 64 only: an [N, N] W), within
    1e-5 (their sums run in other orders)."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    _, plan, _, W = sparse_round(N)
    gen = torch.Generator(device="cuda").manual_seed(N)
    p = torch.randn((N, d), generator=gen, device="cuda")
    g = 0.1 * torch.randn((N, d), generator=gen, device="cuda")
    args = list(sparse_args(plan, p, g, col0=col0))
    kw = dict(gamma=0.01, eta=0.4, noisy=True,
              counter_width=ops._roundup(d + col0, ops.LANES))
    rec = {"N": N, "d": d, "col0": col0, "dense_route": dp_mix_route(N, d)}
    if N <= 64:
        sparse = ops._launch_sparse(*args, **kw)
        dense = ops._launch(*args[:9], W.dense().contiguous(), **kw)
        torch.cuda.synchronize()
        rec["graph_max_abs_err"] = float((sparse - dense).abs().max())
        del sparse, dense
    args[10], args[11] = torch.zeros_like(args[10]), torch.zeros_like(args[11])
    sparse = ops._launch_sparse(*args, **kw)
    torch.cuda.synchronize()
    dense = ops._launch(*args[:9], torch.zeros((N, N), device="cuda"), **kw)
    torch.cuda.synchronize()
    rec["zero_w_differ"] = int((sparse.view(torch.int32)
                                != dense.view(torch.int32)).sum())
    del sparse, dense
    print(f"[kernels] dp_mix sparse vs dense {json.dumps(rec)}", flush=True)
    if rec["zero_w_differ"] or rec.get("graph_max_abs_err", 0.0) > 1e-5:
        fail(f"the sparse round against the dense one: {rec}")
    return rec


def sparse_kernel_phase(counts: dict, rates: dict) -> dict:
    """The sparse round at the path's shape (N = 2048, d = 855,050, k =
    12) in float32 and bfloat16, noisy and gossip, float32 noisy timed;
    bitwise the dense kernel with zero weights at N = 64 and 2048; the
    prediction printed first."""
    import torch
    predict("sparse_kernel")
    path = None
    for dtype in (torch.float32, torch.bfloat16):
        for noisy in (True, False):
            timed = dtype == torch.float32
            rec = check_sparse(SPARSE_N, PATH_D, dtype, noisy, counts, rates,
                               timed)
            if timed and noisy:
                path = rec
            torch.cuda.empty_cache()
    for N, col0 in ((64, 0), (64, 4096), (SPARSE_N, 0)):
        check_sparse_against_dense(N, PATH_D - col0, col0)
        torch.cuda.empty_cache()
    return path


def sparse_cli() -> dict:
    """The worker-scale CLI at full width (dwfl-paper, mesh_sparse, N =
    2048, --sparse-neighbors 12, 5 rounds: the first eager, then one
    chunk of 4 through ChunkRunner's graph, its rounds writing the buffer
    in place), the dp_mix counts set to 0 just before and read just
    after: one dp_mix_round_sparse call a round (the eager round's and
    the capture's) and no dense dp_mix_round; every loss finite, the
    epsilon trajectory over every round; the executor it names; its
    rounds/s, peak device memory allocated and reserved and the active
    workers the CLI found isolated in its first graph draw (it prints a
    warning when there are any)."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.launch import train
    predict("sparse_cli")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.dp_mix_round_sparse.launches = ops.dp_mix_round.launches = 0
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        res = train.run(["--arch", "dwfl-paper", "--flat-buffer",
                         "--channel-model", "dynamic", "--scenario",
                         SPARSE_SCENARIO, "--sparse-neighbors",
                         str(SPARSE_K), "--workers", str(SPARSE_N),
                         "--steps", str(SPARSE_STEPS), "--device", "cuda"])
    sparse, dense = ops.dp_mix_round_sparse.launches, ops.dp_mix_round.launches
    executor = [l for l in tee.lines if l.startswith("[train] executor:")]
    rep, losses, rounds = res["epsilon_report"], res["losses"], res["rounds"]
    rec = {"scenario": SPARSE_SCENARIO, "N": SPARSE_N, "k": SPARSE_K,
           "rounds": rounds, "seconds": res["seconds"],
           "rounds_per_s": rounds / res["seconds"],
           "sparse_launches": sparse, "dense_launches": dense,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
           "executor": executor,
           "isolated_workers": res["isolated_workers"],
           "first_loss": float(losses[0]), "last_loss": float(losses[-1]),
           "eps_rounds": rep["rounds"], "eps_worst": rep["epsilon_worst"],
           "eps_total": rep["epsilon_total"]}
    print(f"[sparse] cli {json.dumps(rec)}", flush=True)
    if sparse != rounds or dense or rep["rounds"] != rounds:
        fail(f"sparse cli: {sparse} sparse and {dense} dense dp_mix calls, "
             f"epsilon over {rep['rounds']} rounds, for {rounds} rounds")
    if len(executor) != 1 or not executor[0].startswith(
            "[train] executor: ChunkRunner (one CUDA graph"):
        fail(f"sparse cli: executor {executor}, expected ChunkRunner's "
             f"graph")
    if not (torch.isfinite(losses).all()
            and torch.isfinite(res["params"]).all()
            and np_finite(rep["epsilon_per_round"])):
        fail("sparse cli: non-finite losses, parameters or epsilons")
    return rec


def sparse_round_sync_free() -> dict:
    """The sparse dynamic flat round with the device's synchronizing calls
    made errors, as dynamic_round_sync_free: sim.round (the neighbor-list
    build), plan_dynamic_sparse and the sparse dp_mix call at N = 2048,
    which must pass; the whole round body at N = 64 (batch, gradients,
    metrics), noted."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    from repro_torch.kernels.dp_mix import ops
    predict("sparse_sync")
    proto = sparse_proto(SPARSE_N)
    sim = proto.simulator("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    net = sim.init(gen)
    net, *_ = sim.round(gen, net)
    flat = torch.randn((SPARSE_N, PATH_D), generator=gen, device="cuda")
    g = 0.1 * torch.randn((SPARSE_N, PATH_D), generator=gen, device="cuda")
    small = sparse_proto(64)
    store = paper_store(64)
    wp = P.init_worker_params(gen, DWFL_PAPER, 64, "cuda")
    spec = X.FlatSpec(wp)
    small_sim = small.simulator("cuda")
    body = TJ.make_round_body(DWFL_PAPER, small, store, spec, "cuda",
                              sim=small_sim)
    carry, _ = TJ.run_chunk(body, TJ.TrajCarry(gen, spec.flatten(wp),
                                               small_sim.init(gen)), 2)
    probe = torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    rec, out = {}, None
    torch.cuda.set_sync_debug_mode("error")
    try:
        try:
            net, chan, _, W = sim.round(gen, net)
            plan = proto.plan(chan, "cuda", W)
            out = ops.dp_mix_round_plan(flat, g, TJ.round_seed(gen), plan,
                                        gamma=proto.gamma, eta=proto.eta)
            rec["round_sync_free"] = True
        except RuntimeError as e:
            rec["round_sync_free"] = False
            rec["round_error"] = str(e).splitlines()[0]
        try:
            body(carry)
            rec["body_sync_free"] = True
        except RuntimeError as e:
            rec["body_sync_free"] = False
            rec["body_error"] = str(e).splitlines()[0]
        try:
            probe.sum().item()
            rec["guard_raises"] = False
        except RuntimeError:
            rec["guard_raises"] = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"[sparse] sync debug mode 'error': {json.dumps(rec)}", flush=True)
    if not (rec["round_sync_free"] and rec["guard_raises"]):
        fail(f"the sparse round synchronizes with the host: {rec}")
    if not torch.isfinite(out).all():
        fail("the guarded sparse round gave non-finite parameters")
    return rec


def sparse_flat_round_ms(proto, n_rounds: int = 3) -> list:
    """The whole dynamic sparse flat round at full width and N = 2048
    (batch, the simulator's round, gradients and clip, the sparse dp_mix
    call, metrics) through the trajectory body, warm: host clock around
    ``n_rounds`` rounds ending in a synchronize, twice."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    gen = torch.Generator(device="cuda").manual_seed(0)
    wp = P.init_worker_params(gen, DWFL_PAPER, SPARSE_N, "cuda")
    spec = X.FlatSpec(wp)
    sim = proto.simulator("cuda")
    body = TJ.make_round_body(DWFL_PAPER, proto, paper_store(SPARSE_N), spec,
                              "cuda", sim=sim)
    carry = TJ.TrajCarry(gen, spec.flatten(wp), sim.init(gen))
    del wp
    carry, _ = TJ.run_chunk(body, carry, 2)
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, _ = TJ.run_chunk(body, carry, n_rounds)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0) / n_rounds)
    return out


def group_rows(sw, order, G: int) -> dict:
    """Distinct rows of z (each receiver's own and its slots') that the
    gather's groups of G receivers read, taken in ``order`` (None: index
    order): the mean a receiver and the largest group's."""
    import torch
    N = sw.n_workers
    rows = torch.cat([torch.arange(N, device=sw.device)[:, None],
                      sw.idx.long()], 1)
    if order is not None:
        rows = rows[order.long()]
    pad = -N % G
    if pad:
        rows = torch.cat([rows, rows[-1:].expand(pad, -1)])
    srt = rows.reshape(-1, G * rows.shape[1]).sort(dim=1).values
    distinct = 1 + (srt[:, 1:] != srt[:, :-1]).sum(1)
    return {"per_receiver": float(distinct.sum()) / N,
            "largest_group": int(distinct.max())}


def sparse_turns() -> dict:
    """At N = 2048 and the path's d, in turns (keyed, index, dense, dense,
    index, keyed), each timed by CUDA events: the sparse round's kernels
    with the receivers in the list's key order (the wrapper's), the same
    list in index order, and the dense large-N route given the same
    round's SparseW.dense(); the prep and the gather apart beside their
    floors (the bytes each must move at 3.35 TB/s) and the distinct rows a
    gather group reads a receiver in either order (group_rows); one
    torch.sparse.mm of the list as a CSR [N, N] by z [N, d], the yardstick
    of the mix alone, which the port never calls; then the simulator's
    mesh_sparse round with the neighbor list against the same scenario's
    dense round (Metropolis weights of the [N, N] unit-disk graph), host
    clock around 10 rounds ending in a synchronize, in turns; then the
    whole sparse flat round (sparse_flat_round_ms)."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    predict("sparse_turns")
    proto, plan, _, W = sparse_round(SPARSE_N)
    gen = torch.Generator(device="cuda").manual_seed(5)
    p = torch.randn((SPARSE_N, PATH_D), generator=gen, device="cuda")
    g = 0.1 * torch.randn((SPARSE_N, PATH_D), generator=gen, device="cuda")
    args = sparse_args(plan, p, g)
    kw = dict(gamma=proto.gamma, eta=proto.eta, noisy=True,
              counter_width=ops._roundup(PATH_D, ops.LANES))
    order = ops.locality_order(W, SPARSE_N, "cuda")
    dense_W = W.dense().contiguous()
    runs = {"keyed": lambda: ops._launch_sparse(*args, **kw, order=order),
            "index": lambda: ops._launch_sparse(*args, **kw),
            "dense": lambda: ops._launch(*args[:9], dense_W, **kw)}
    ms = {name: [] for name in runs}
    for name in ("keyed", "index", "dense", "dense", "index", "keyed"):
        ms[name].append(cuda_ms(runs[name], iters=2, warmup=1))
        torch.cuda.empty_cache()
    prep = lambda: ops._launch_prep(p, g, *args[2:6], gamma=proto.gamma,
                                    noisy=True,
                                    counter_width=kw["counter_width"],
                                    row0=0)
    ws = prep()
    gather = lambda: ops._launch_gather(p, g, ws, ws[0], *args[2:], row0=0,
                                        **kw, order=order)
    halves = {"prep": [], "gather": []}
    for name in ("prep", "gather", "gather", "prep"):
        halves[name].append(cuda_ms(prep if name == "prep" else gather,
                                    iters=3, warmup=1))
    del ws
    torch.cuda.empty_cache()
    floors = {"prep": SPARSE_N * PATH_D * 16 / HBM_BYTES_PER_S * 1e3,
              "gather": SPARSE_N * PATH_D * 20 / HBM_BYTES_PER_S * 1e3}
    # the list as a CSR [N, N] (self_w on the diagonal, the slots' w), z
    rows = torch.arange(SPARSE_N, device="cuda")
    cols = torch.cat([rows[:, None], W.idx.long()], 1)
    vals = torch.cat([W.self_w[:, None], W.w], 1)
    csr = torch.sparse_coo_tensor(
        torch.stack([rows[:, None].expand_as(cols).reshape(-1),
                     cols.reshape(-1)]), vals.reshape(-1),
        (SPARSE_N, SPARSE_N)).coalesce().to_sparse_csr()
    z = p - proto.gamma * g
    del p, g, args, runs
    torch.cuda.empty_cache()
    mm_ms = cuda_ms(lambda: torch.sparse.mm(csr, z), iters=3, warmup=1)
    del z
    torch.cuda.empty_cache()
    sims = {"sparse": proto.simulator("cuda"),
            "dense": dynamic_proto(SPARSE_N, SPARSE_SCENARIO).simulator(
                "cuda")}
    gens = {n: torch.Generator(device="cuda").manual_seed(0) for n in sims}
    states = {n: sims[n].init(gens[n]) for n in sims}
    for n in sims:
        for _ in range(3):
            states[n] = sims[n].round(gens[n], states[n])[0]
    sim_ms = {"sparse": [], "dense": []}
    for name in ("sparse", "dense", "dense", "sparse"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            states[name] = sims[name].round(gens[name], states[name])[0]
        torch.cuda.synchronize()
        sim_ms[name].append(1e3 * (time.perf_counter() - t0) / 10)
    rec = {"N": SPARSE_N, "d": PATH_D, "k": SPARSE_K, "round_ms": ms,
           "prep_ms": halves["prep"], "gather_ms": halves["gather"],
           "prep_floor_ms": floors["prep"],
           "gather_floor_ms": floors["gather"],
           "rows_a_receiver": {
               "key_order_group_16": group_rows(W, order, 16),
               "index_order_group_16": group_rows(W, None, 16)},
           "rows_staged_a_group": ops.gather_capacity(SPARSE_K),
           "sparse_mm_ms": mm_ms,
           "sparse_mm_note": "torch.sparse.mm(CSR [N, N], z [N, d]): the "
                             "mix alone, a yardstick the port never calls",
           "simulator_round_ms": sim_ms,
           "flat_round_ms": sparse_flat_round_ms(proto)}
    print(f"[sparse] in turns {json.dumps(rec)}; {nvidia_smi()}", flush=True)
    return rec


def sparse_tree(N: int = 64) -> int:
    """The dynamic worker-tree round with the neighbor list (mesh_sparse,
    --sparse-neighbors, use_pallas=True) at full width and N workers
    through the trajectory body, dp_perturb's counts set to 0 just before
    and read just after: one sgd_update_leaves launch a round."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    from repro_torch.kernels.dp_perturb import ops
    from repro_torch.net.sparse import SparseW
    predict("sparse_tree")
    proto = sparse_proto(N, use_pallas=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    wp = P.init_worker_params(gen, DWFL_PAPER, N, "cuda")
    sim = proto.simulator("cuda")
    body = TJ.make_round_body(DWFL_PAPER, proto, paper_store(N),
                              device="cuda", sim=sim)
    carry = TJ.TrajCarry(gen, wp, sim.init(gen))
    ops.sgd_update_leaves.launches = 0
    ops.sgd_update.launches = ops.dp_perturb.launches = 0
    carry, out = TJ.run_chunk(body, carry, TREE_ROUNDS)
    torch.cuda.synchronize()
    launches = ops.sgd_update_leaves.launches
    others = ops.sgd_update.launches + ops.dp_perturb.launches
    rep = P.epsilon_report(proto, out["chan"], Ws=out["W"])
    losses = out["metrics"]["loss"].cpu()
    rec = {"scenario": SPARSE_SCENARIO, "N": N, "k": SPARSE_K,
           "rounds": TREE_ROUNDS, "launches": launches,
           "w_is_sparse": isinstance(out["W"], SparseW),
           "first_loss": float(losses[0]), "last_loss": float(losses[-1]),
           "eps_worst": rep["epsilon_worst"]}
    print(f"[sparse] tree {json.dumps(rec)}", flush=True)
    if launches != TREE_ROUNDS or others or not rec["w_is_sparse"]:
        fail(f"sparse tree: sgd_update_leaves launched {launches} times for "
             f"{TREE_ROUNDS} rounds, the per-leaf wrappers {others} times, "
             f"W sparse: {rec['w_is_sparse']}")
    if not (torch.isfinite(losses).all() and tree_leaves_finite(carry.params)
            and np_finite(rep["epsilon_per_round"])):
        fail("sparse tree: non-finite losses, parameters or epsilons")
    return launches


def ulp_dist(a, b):
    """Elementwise ULP distance of two float32 tensors."""
    import torch
    ia, ib = (t.float().contiguous().view(torch.int32).long() for t in (a, b))
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


def check_dp_perturb(shape, dtype, noisy: bool, timed: bool) -> dict:
    """Kernel vs plain on the card at one leaf. Tolerance: x within 1 ULP
    (both are p - gamma g rounded once, but the plain version's fused
    multiply-add goes through float64 and may round twice); the noisy xt
    within 4 ULP of its noise term plus 2 ULP of itself — both use IEEE
    logf, cosf and square root on the card, and the CPU tests hold the
    plain normals within 4 ULP of the reference's; a bfloat16 output may
    land one bfloat16 step (2^-7 of its magnitude) further."""
    import torch
    from repro_torch.kernels.dp_perturb import ops
    from repro_torch.kernels.dp_perturb.dp_perturb import dp_perturb_plain
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    p = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = (0.1 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    gamma = 0.01
    kw = (dict(gamma=gamma, sigma=1.0, s_sig=0.7, s_noise=1.3) if noisy
          else dict(gamma=gamma, sigma=0.0, s_sig=1.0, s_noise=0.0))
    seed = torch.tensor([1234567], dtype=torch.int32, device="cuda")
    if noisy:
        kernel = lambda: ops.dp_perturb(p, g, seed, **kw)
    else:
        kernel = lambda: (ops.sgd_update(p, g, gamma), None)
    plain = lambda: dp_perturb_plain(p, g, seed, **kw)
    (kx, kxt), (rx, rxt) = kernel(), plain()
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    step = lambda a, b: (2.0 ** -7 * torch.maximum(a.abs(), b.abs()) if bf16
                         else 0.0)
    k32, r32 = kx.float(), rx.float()
    if not torch.isfinite(k32).all():
        fail(f"dp_perturb {shape} {dtype}: non-finite x")
    x_ok = (ulp_dist(k32, r32) <= 1) | ((k32 - r32).abs() <= step(k32, r32))
    bad = int((~x_ok).sum())
    err = float((k32 - r32).abs().max())
    if noisy:
        k32, r32 = kxt.float(), rxt.float()
        if not torch.isfinite(k32).all():
            fail(f"dp_perturb {shape} {dtype}: non-finite xt")
        term = (r32 - 0.7 * rx.float()).abs()
        allowed = (4 * 2.0 ** -23 * term + 2 * 2.0 ** -23 * r32.abs()
                   + 2.0 ** -126 + step(k32, r32))
        bad += int(((k32 - r32).abs() > allowed).sum())
        err = max(err, float((k32 - r32).abs().max()))
    rec = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "noisy": noisy, "max_abs_err": err, "violations": bad}
    if timed:
        w = perturb_work(p.numel(), p.element_size(), noisy,
                         outputs=2 if noisy else 1)
        nbytes, flops = w.nbytes, w.flops
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
        rec["ms"] = cuda_ms(kernel, iters=50)
        rec["plain_ms"] = cuda_ms(plain, iters=5, warmup=1)
        rec["library_ms"] = (None if noisy else cuda_ms(
            lambda: torch.add(p, g, alpha=-gamma), iters=50))
        rec["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        rec["bytes"], rec["flops"] = nbytes, flops
    print(f"[kernels] dp_perturb {json.dumps(rec)}", flush=True)
    if bad:
        fail(f"dp_perturb {shape} {rec['dtype']} noisy={noisy}: {bad} "
             f"elements beyond tolerance (max err {err:.3g})")
    return rec


def check_leaves(dtype, timed: bool, shapes=MLP_LEAVES,
                 graphs: bool = True) -> dict:
    """sgd_update_leaves, the tree path's local step, over its leaves
    (``shapes``: dwfl-paper's six, or olmo-1b's eight) in one launch: each
    leaf bitwise the per-leaf kernel (a table of one entry) and within 1
    ULP of the plain version (a bfloat16 output one bfloat16 step
    further), compared a leaf at a time. Timed, per round: the one launch,
    beside the per-leaf kernel's launches, the plain version, a
    ``torch.add`` a leaf and one ``torch._foreach_add`` over the leaves
    (library_ms; the port calls neither); the bound: p and g read and x
    written once over 3.35 TB/s, one FMA per element over 67 TFLOP/s.
    With ``graphs`` the one launch and ``_foreach_add`` are also timed
    inside a CUDA graph (device_ms, library_device_ms): the device's time
    without the host's (at olmo-1b's leaves the graph's ten outputs would
    not fit, and the host's time is no part of a 9 ms launch)."""
    import torch
    from repro_torch.kernels.dp_perturb import ops
    gen = torch.Generator(device="cuda").manual_seed(11)
    ps = [torch.randn(s, generator=gen, device="cuda").to(dtype)
          for s in shapes]
    gs = [(0.1 * torch.randn(s, generator=gen, device="cuda")).to(dtype)
          for s in shapes]
    gamma = 0.01
    kernel = lambda: ops.sgd_update_leaves(ps, gs, gamma)
    per_leaf = lambda: [ops.sgd_update(p, g, gamma) for p, g in zip(ps, gs)]
    plain = lambda: ops.sgd_update_leaves_plain(ps, gs, gamma)
    xs = kernel()
    torch.cuda.synchronize()
    bad, err = 0, 0.0
    for x, p, g in zip(xs, ps, gs):
        one = ops.sgd_update(p, g, gamma)
        r = ops.sgd_update_plain(p, g, gamma)
        bad += int((x != one).sum())
        k32, r32 = x.float(), r.float()
        if not torch.isfinite(k32).all():
            fail(f"sgd_update_leaves {dtype}: non-finite x")
        step = (2.0 ** -7 * torch.maximum(k32.abs(), r32.abs())
                if dtype == torch.bfloat16 else 0.0)
        ok = (ulp_dist(k32, r32) <= 1) | ((k32 - r32).abs() <= step)
        bad += int((~ok).sum())
        err = max(err, float((k32 - r32).abs().max()))
        del one, r, k32, r32, ok
    del xs
    rec = {"leaves": len(shapes), "dtype": str(dtype).split(".")[-1],
           "elements": sum(math.prod(s) for s in shapes),
           "max_abs_err": err, "violations": bad}
    if timed:
        w = perturb_work(sum(p.numel() for p in ps), ps[0].element_size(),
                         False, outputs=1)
        nbytes, flops = w.nbytes, w.flops
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
        rec["ms"] = cuda_ms(kernel, iters=50)
        rec["per_leaf_ms"] = cuda_ms(per_leaf, iters=50)
        rec["plain_ms"] = cuda_ms(plain, iters=5, warmup=1)
        rec["torch_add_ms"] = cuda_ms(lambda: [
            torch.add(p, g, alpha=-gamma) for p, g in zip(ps, gs)], iters=50)
        rec["library_ms"] = cuda_ms(
            lambda: torch._foreach_add(ps, gs, alpha=-gamma), iters=50)
        if graphs:
            rec["device_ms"] = graph_ms(kernel)
            rec["library_device_ms"] = graph_ms(
                lambda: torch._foreach_add(ps, gs, alpha=-gamma))
        rec["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        rec["bytes"], rec["flops"] = nbytes, flops
    print(f"[kernels] dp_perturb sgd_update_leaves per round {json.dumps(rec)}",
          flush=True)
    if bad:
        fail(f"sgd_update_leaves {rec['dtype']}: {bad} elements not bitwise "
             f"the per-leaf kernel or beyond 1 ULP of the plain version")
    return rec


def dp_perturb_phase() -> dict:
    """Every case at the tree path's leaves, each leaf in a launch of its
    own; the float32 cases timed, and their sums per round printed. Then
    sgd_update_leaves, what the path launches (once per round), in float32
    (timed; returned) and bfloat16."""
    import torch
    recs = []
    for shape in MLP_LEAVES:
        for dtype in (torch.float32, torch.bfloat16):
            for noisy in (False, True):
                recs.append(check_dp_perturb(shape, dtype, noisy,
                                             timed=dtype == torch.float32))
                torch.cuda.empty_cache()
    timed = [r for r in recs if "ms" in r]
    rnd = {}
    for noisy in (False, True):
        rs = [r for r in timed if r["noisy"] == noisy]
        keys = ("ms", "plain_ms", "bound_ms", "bytes", "flops") + (
            () if noisy else ("library_ms",))
        rnd["noisy" if noisy else "sgd_update"] = {
            k: sum(r[k] for r in rs) for k in keys}
    print(f"[kernels] dp_perturb per round (6 leaves, 6 launches) "
          f"{json.dumps(rnd)}", flush=True)
    rec = check_leaves(torch.float32, timed=True)
    check_leaves(torch.bfloat16, timed=False)
    torch.cuda.empty_cache()
    return rec


def train_step_cpu_vs_cuda() -> float:
    """One small round (hidden 16, N = 4) on the card against the same
    round on the CPU from the same buffer, batch and seed: the CPU round
    runs the plain versions the tests hold against the JAX reference."""
    import dataclasses
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    cfg = dataclasses.replace(DWFL_PAPER, d_model=16)
    proto = P.ProtocolConfig(n_workers=4, gamma=0.01, eta=0.4,
                             target_epsilon=1.0)
    gen = torch.Generator().manual_seed(3)
    wp = P.init_worker_params(gen, cfg, 4, "cpu")
    spec = X.FlatSpec(wp)
    flat = spec.flatten(wp)
    batch = {"x": torch.randn((4, 8, 3072), generator=gen),
             "y": torch.randint(0, 10, (4, 8), generator=gen)}
    outs = {}
    for dev in ("cpu", "cuda"):
        step = P.make_flat_train_step(cfg, proto, spec, dev)
        out, _ = step(flat.to(dev), {k: v.to(dev) for k, v in batch.items()},
                      torch.tensor([99], dtype=torch.int32, device=dev))
        outs[dev] = out.cpu()
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    tol = 1e-4 * (1.0 + float(outs["cpu"].abs().max()))
    print(f"[train] small round cuda vs cpu: max_abs_err={err:.3g} "
          f"(tol {tol:.3g})", flush=True)
    if not math.isfinite(err) or err > tol:
        fail(f"small round: cuda and cpu differ by {err:.3g} > {tol:.3g}")
    return err


def tree_round_cpu_vs_cuda() -> float:
    """One small worker-tree round (hidden 16, N = 4, use_pallas=True) on
    the card against the same round on the CPU from the same parameters,
    batch and standard normals: the CPU round runs the plain versions the
    tests hold against the JAX reference."""
    import dataclasses
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    cfg = dataclasses.replace(DWFL_PAPER, d_model=16)
    proto = P.ProtocolConfig(n_workers=4, gamma=0.01, eta=0.4,
                             target_epsilon=1.0, use_pallas=True)
    gen = torch.Generator().manual_seed(5)
    wp = P.init_worker_params(gen, cfg, 4, "cpu")
    batch = {"x": torch.randn((4, 8, 3072), generator=gen),
             "y": torch.randint(0, 10, (4, 8), generator=gen)}
    normals = X.draw_normals(wp, gen)
    to = lambda tree, dev: X.tree_map(lambda t: t.to(dev), tree)
    outs = {}
    for dev in ("cpu", "cuda"):
        step = P.make_train_step(cfg, proto, dev)
        out, _ = step(to(wp, dev), to(batch, dev), None,
                      normals=to(normals, dev))
        outs[dev] = X.flatten_worker_tree(to(out, "cpu"))
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    tol = 1e-4 * (1.0 + float(outs["cpu"].abs().max()))
    print(f"[tree] small round cuda vs cpu: max_abs_err={err:.3g} "
          f"(tol {tol:.3g})", flush=True)
    if not math.isfinite(err) or err > tol:
        fail(f"small tree round: cuda and cpu differ by {err:.3g} > {tol:.3g}")
    return err


def tree_leaves_finite(tree) -> bool:
    import torch
    from repro_torch.core import exchange as X
    return all(bool(torch.isfinite(l).all()) for l in X.tree_flatten(tree)[0])


def paper_store(N: int = PATH_N):
    """dwfl-paper's training data on the card for N workers, as the CLI
    builds it."""
    from repro_torch.data import (ClassificationStore, classification_dataset,
                                  dirichlet_partition)
    x, y = classification_dataset(20000, seed=0)
    return ClassificationStore.build(
        x, y, dirichlet_partition(y, N, alpha=0.5, seed=0), 32, "cuda")


def train_tree_schemes(store) -> int:
    """The worker-tree path at full width for each scheme through the
    trajectory body, dp_perturb's counts set to 0 just before each
    scheme's run and read just after: one launch per round, all six
    leaves in it. Returns the launches of all four."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    from repro_torch.kernels.dp_perturb import ops
    total = 0
    for scheme in SCHEMES:
        proto = P.ProtocolConfig(scheme=scheme, n_workers=PATH_N, gamma=0.01,
                                 eta=0.4, use_pallas=True, target_epsilon=1.0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        wp = P.init_worker_params(gen, DWFL_PAPER, PATH_N, "cuda")
        body = TJ.make_round_body(DWFL_PAPER, proto, store, device="cuda")
        ops.sgd_update_leaves.launches = 0
        ops.sgd_update.launches = ops.dp_perturb.launches = 0
        t0 = time.perf_counter()
        carry, res = TJ.run_chunk(body, TJ.TrajCarry(gen, wp), TREE_ROUNDS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.sgd_update_leaves.launches
        others = ops.sgd_update.launches + ops.dp_perturb.launches
        losses = res["metrics"]["loss"].cpu()
        print(f"[tree] {json.dumps({'scheme': scheme, 'rounds': TREE_ROUNDS, 'seconds': seconds, 'launches': launches, 'first_loss': float(losses[0]), 'last_loss': float(losses[-1])})}",
              flush=True)
        if not torch.isfinite(losses).all():
            fail(f"tree {scheme}: non-finite losses {losses.tolist()}")
        if launches != TREE_ROUNDS or others:
            fail(f"tree {scheme}: sgd_update_leaves launched {launches} "
                 f"times for {TREE_ROUNDS} rounds (one each), the per-leaf "
                 f"wrappers {others} times (none)")
        if not tree_leaves_finite(carry.params):
            fail(f"tree {scheme}: non-finite parameters")
        total += launches
    return total


def tree_cli() -> None:
    """The CLI without --flat-buffer (the worker-tree path), chunked and
    with --no-scan."""
    import torch
    from repro_torch.launch import train
    for extra in ([], ["--no-scan"]):
        res = train.run(["--arch", "dwfl-paper", "--scheme", "orthogonal",
                         "--workers", str(PATH_N), "--steps", "10",
                         "--eval-every", "5", "--device", "cuda", *extra])
        losses = res["losses"]
        print(f"[tree] cli {' '.join(extra) or 'chunked'}: {res['rounds']} "
              f"rounds in {res['seconds']:.3f}s; first/last loss "
              f"{float(losses[0]):.4f}/{float(losses[-1]):.4f}", flush=True)
        if losses.numel() != res["rounds"] or not torch.isfinite(losses).all():
            fail(f"tree cli {extra}: losses {losses.tolist()}")
        if not tree_leaves_finite(res["params"]):
            fail(f"tree cli {extra}: non-finite parameters")


def device_us(stats) -> float:
    """Device time in a profile: the sum over the kernels' own rows. An
    operator's row (aten::mm) repeats the time of the kernels it launched,
    so summing every row would count most of the time twice."""
    from torch.autograd import DeviceType
    return sum(self_device_us(e) for e in stats
               if e.device_type != DeviceType.CPU)


def self_device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profile_rounds(store, flat: bool, n_rounds: int = 20,
                   dynamic: bool = False) -> dict:
    """Where a full-width round's time goes on one path (flat: the dp_mix
    round; else the worker-tree round, dwfl with use_pallas=True; with
    ``dynamic`` on the iot_dense network, the simulator's round in it):
    the round body after a warm-up, timed by the host clock around
    ``n_rounds`` rounds ending in a synchronize, then the same number of
    rounds under torch.profiler for the device's busy share and the top
    operators by device and host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    proto = (dynamic_proto(PATH_N, use_pallas=not flat) if dynamic else
             P.ProtocolConfig(n_workers=PATH_N, gamma=0.01, eta=0.4,
                              target_epsilon=1.0, use_pallas=not flat))
    gen = torch.Generator(device="cuda").manual_seed(0)
    wp = P.init_worker_params(gen, DWFL_PAPER, PATH_N, "cuda")
    spec = X.FlatSpec(wp) if flat else None
    sim = proto.simulator("cuda") if dynamic else None
    body = TJ.make_round_body(DWFL_PAPER, proto, store, spec, "cuda", sim=sim)
    carry = TJ.TrajCarry(gen, spec.flatten(wp) if flat else wp,
                         sim.init(gen) if dynamic else None)
    carry, _ = TJ.run_chunk(body, carry, 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = TJ.run_chunk(body, carry, n_rounds)
    torch.cuda.synchronize()
    round_ms = 1e3 * (time.perf_counter() - t0) / n_rounds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry, _ = TJ.run_chunk(body, carry, n_rounds)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    stats = prof.key_averages()
    dev, busy_us = self_device_us, device_us(stats)
    rec = {"path": ("dynamic " if dynamic else "") + ("flat" if flat
                                                      else "tree"),
           "round_ms": round_ms,
           "rounds": n_rounds,
           "profiled_round_ms": wall_us / 1e3 / n_rounds,
           "device_busy_share": (busy_us / wall_us if busy_us > 0
                                 else "not measured"),
           "top_device_us_per_round": [
               (e.key, dev(e) / n_rounds) for e in
               sorted(stats, key=dev, reverse=True)[:8] if dev(e) > 0],
           "top_host_us_per_round": [
               (e.key, e.self_cpu_time_total / n_rounds) for e in
               sorted(stats, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:8]]}
    print(f"[profile] {json.dumps(rec)}", flush=True)
    if not tree_leaves_finite(carry.params):
        fail(f"profile {rec['path']}: non-finite parameters")
    return rec


def check_flash(shape, dtype, window, timed: bool) -> dict:
    """flash_attention's kernel vs its plain version on the card at one
    shape. Tolerance: both compute the scores, the softmax and the
    probability-weighted sum in float32 and differ only in the order of
    their sums, so |kernel - plain| <= 2e-5 (1 + |plain|) (the reference's
    float32 tolerance for its own kernel); a bfloat16 output may land one
    bfloat16 step (2^-7 of its magnitude) further. Both instantiations run
    their products on the tensor cores and keep that tolerance: float32
    takes each operand as two TF32 terms (three products, each term's
    residual ~2^-22 of the operand); bfloat16 has exact products of q k^T
    and takes P as two bfloat16 terms (P_hi + P_lo, a residual of at most
    2^-17 |P|). Timed: the kernel by CUDA events, beside the plain version,
    SDPA on [B, H, S, hd] views (library_ms) and the bound of its route
    (flash_work): 2 products of 2 hd flops per (query, key) pair the mask
    keeps, over 495 TFLOP/s in float32 (TF32 tensor cores) or 989 TFLOP/s
    in bfloat16, against q, k, v, o moved once over 3.35 TB/s. The
    route's own work, kernel_work_ms: 3 times the products in float32, 1.5
    times in bfloat16 (P v twice, for P_hi and P_lo)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_plain)
    B, S, H, Hkv, hd = shape
    gen = torch.Generator(device="cuda").manual_seed(S + hd)
    q, k, v = (torch.randn((B, S, n, hd), generator=gen, device="cuda").to(dtype)
               for n in (H, Hkv, Hkv))
    kernel = lambda: ops.flash_attention(q, k, v, causal=True,
                                         sliding_window=window)
    plain = lambda: flash_attention_plain(q, k, v, causal=True,
                                          sliding_window=window)
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    a, b = out.float(), ref.float()
    if not torch.isfinite(a).all():
        fail(f"flash_attention {shape} {dtype}: non-finite output")
    allowed = 2e-5 * (1 + b.abs())
    if dtype == torch.bfloat16:
        allowed = allowed + 2.0 ** -7 * torch.maximum(a.abs(), b.abs())
    err = (a - b).abs()
    bad = int((err > allowed).sum())
    rec = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "window": window, "max_abs_err": float(err.max()),
           "tol": "2e-5 (1 + |plain|)" + (" + 1 bf16 step"
                                          if dtype == torch.bfloat16 else ""),
           "violations": bad}
    if timed:
        qpos = torch.arange(S, device="cuda")[:, None]
        kpos = torch.arange(S, device="cuda")[None, :]
        keep = kpos <= qpos
        if window is not None:
            keep &= kpos > qpos - window
        w = flash_work(B, S, H, Hkv, hd, q.element_size(), window)
        if w.flops != 4 * hd * int(keep.sum()) * B * H:
            fail(f"flash_attention {shape}: flash_work counts {w.flops} flops, "
                 f"the mask keeps {int(keep.sum())} pairs")
        rec["kernel_work_ms"] = 1e3 * w.kernel_flops / w.rate
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rec["ms"] = cuda_ms(kernel, iters=20)
        rec["plain_ms"] = cuda_ms(plain, iters=3, warmup=1)
        rec["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
        rec["bound_ms"] = 1e3 * w.bound_s
        rec["bound_by"] = w.bound_by
        rec["bytes"], rec["flops"] = w.nbytes, w.flops
        if rec["ms"] < rec["bound_ms"]:
            fail(f"flash_attention {shape} {rec['dtype']}: {rec['ms']:.4f} ms "
                 f"is under its bound {rec['bound_ms']:.4f} ms")
    print(f"[kernels] flash_attention {json.dumps(rec)}", flush=True)
    if bad:
        fail(f"flash_attention {shape} {rec['dtype']} window={window}: {bad} "
             f"elements beyond tolerance (max err {rec['max_abs_err']:.3g})")
    return rec


def flash_phase():
    """gemma-2b's prefill shape and olmo-1b's heads in float32 and
    bfloat16 (all four timed), a sliding window and a ragged S in each
    dtype (the other shapes are tests/test_torch_cuda.py's FLASH_CASES, run
    by its gpu-marked tests); returns gemma-2b's float32 and bfloat16
    records, whose bounds are checked against the counts written in
    PERF.md: 17.2 GFLOP at 495 TFLOP/s (split TF32), 0.0347 ms, and at 989
    TFLOP/s (bfloat16), 0.0174 ms, both operations-bound; both
    instantiations run on the tensor cores."""
    import torch
    recs = []
    for dtype, want in ((torch.float32, 0.0347), (torch.bfloat16, 0.0174)):
        rec = check_flash(GEMMA_ATTN, dtype, None, timed=True)
        if rec["bound_by"] != "operations" or abs(rec["bound_ms"] / want - 1) > 0.01:
            fail(f"flash_attention {rec['dtype']} bound {rec['bound_ms']:.4f} "
                 f"ms ({rec['bound_by']}), expected {want} ms (operations)")
        recs.append(rec)
    check_flash(OLMO_ATTN, torch.float32, None, timed=True)
    check_flash(OLMO_ATTN, torch.bfloat16, None, timed=True)
    check_flash((2, 1024, 8, 1, 256), torch.float32, 200, timed=False)
    check_flash((2, 1024, 8, 1, 256), torch.bfloat16, 200, timed=False)
    check_flash((2, 1000, 4, 2, 64), torch.float32, None, timed=False)
    check_flash((2, 1000, 4, 2, 64), torch.bfloat16, None, timed=False)
    torch.cuda.empty_cache()
    return recs


def ssd_inputs(shape, dtype):
    """Inputs of the SSD step at one shape, as the reference's sweep draws
    them (tests/test_kernels.py::test_ssd_scan_sweep): x 0.5 N(0, 1), dt
    softplus(N(0, 1)), A -exp(0.3 N(0, 1)), Bm and Cm 0.3 N(0, 1); dA = dt A."""
    import torch
    import torch.nn.functional as F
    B, S, H, P, N, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(S + H + N)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = (0.5 * rnd(B, S, H, P)).to(dtype)
    dt = F.softplus(rnd(B, S, H))
    A = -torch.exp(0.3 * rnd(H))
    Bm, Cm = ((0.3 * rnd(B, S, N)).to(dtype) for _ in range(2))
    return x, dt, dt * A, Bm, Cm


def check_ssd(shape, dtype, timed: bool) -> dict:
    """ssd_scan's kernel vs its plain version on the card at one shape
    (B, S, H, P, N, chunk). Tolerance: the reference's own for its kernel,
    rtol 1e-4 / atol 1e-5 (tests/test_kernels.py::test_ssd_scan_sweep), on
    y_diag, the states and the chunk decays; a bfloat16 y may land one
    bfloat16 step (2^-7 of its magnitude) further. Both take cs in the
    reference's float32 order and differ in the order of the products'
    sums, the kernel's products as split TF32 (three TF32 products for each
    float32 one, each operand's residual under 2^-21 of it). The launch is
    the one ops.ssd_scan makes on the main path, which also writes cs, held
    against cumsum_f32 at the same tolerance (cs_bitwise: whether it is
    bitwise equal). Timed: that launch by CUDA events, beside the plain
    version (with cumsum_f32) and the bound of its route (ssd_work): its
    bytes over 3.35 TB/s against its operations over 495 TFLOP/s (TF32
    tensor cores); and the route's own work (kernel_work_ms). No single
    PyTorch call computes this function (library_ms null)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ssd_scan import cumsum_f32, ssd_intra_chunk_plain
    B, S, H, _, _, chunk = shape
    x, dt, dA, Bm, Cm = ssd_inputs(shape, dtype)
    kernel = lambda: ops._launch(x, dt, dA, Bm, Cm, chunk=chunk, with_cs=True)
    plain = lambda: (*ssd_intra_chunk_plain(x, dt, dA, Bm, Cm, chunk=chunk),
                     cumsum_f32(dA.reshape(B, S // chunk, chunk, H), dim=2))
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    bad, errs = 0, {}
    for name, a, b in zip(("y", "states", "cdecay", "cs"), got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"ssd_scan {shape}: {name} {tuple(a.shape)} {a.dtype} vs plain "
                 f"{tuple(b.shape)} {b.dtype}")
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            fail(f"ssd_scan {shape} {dtype}: non-finite {name}")
        allowed = 1e-5 + 1e-4 * b.abs()
        if name == "y" and dtype == torch.bfloat16:
            allowed = allowed + 2.0 ** -7 * torch.maximum(a.abs(), b.abs())
        err = (a - b).abs()
        bad += int((err > allowed).sum())
        errs[name] = float(err.max())
    rec = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "max_abs_err": max(errs.values()), "errs": errs,
           "y_scale": float(want[0].float().abs().max()),
           "cs_bitwise": bool(torch.equal(got[3], want[3])),
           "tol": "1e-5 + 1e-4 |plain|" + (" + 1 bf16 step on y"
                                          if dtype == torch.bfloat16 else ""),
           "violations": bad}
    if timed:
        w = ssd_work(shape, x.element_size())
        rec["kernel_work_ms"] = 1e3 * w.kernel_flops / w.rate
        rec["ms"] = cuda_ms(kernel, iters=20)
        rec["plain_ms"] = cuda_ms(plain, iters=3, warmup=1)
        rec["library_ms"] = None
        rec["bound_ms"] = 1e3 * w.bound_s
        rec["bound_by"] = w.bound_by
        rec["bytes"], rec["flops"] = w.nbytes, w.flops
        if rec["ms"] < rec["bound_ms"]:
            fail(f"ssd_scan {shape} {rec['dtype']}: {rec['ms']:.4f} ms is "
                 f"under its bound {rec['bound_ms']:.4f} ms")
    print(f"[kernels] ssd_scan {json.dumps(rec)}", flush=True)
    if bad:
        fail(f"ssd_scan {shape} {rec['dtype']}: {bad} elements beyond "
             f"tolerance (max err {rec['max_abs_err']:.3g})")
    del got, want, x, dt, dA, Bm, Cm
    torch.cuda.empty_cache()
    return rec


def check_ssd_scan_cs(shape) -> None:
    """ops.ssd_scan on the card takes the kernel's cs (its fourth output)
    and launches no cumsum_f32; its y and final state are bitwise those of
    the same scan with cumsum_f32's cs (the kernel's three outputs, then
    inter_chunk)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ssd_scan import cumsum_f32, inter_chunk
    B, S, H, P, N, chunk = shape
    x, dt, dA, Bm, Cm = ssd_inputs(shape, torch.float32)
    A = dA[0, 0] / dt[0, 0]
    calls = []
    counted = lambda *a, **k: calls.append(1) or cumsum_f32(*a, **k)
    ops.cumsum_f32, kept = counted, ops.cumsum_f32
    try:
        y, h = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    finally:
        ops.cumsum_f32 = kept
    dA = dt.float() * A.float()[None, None, :]
    nc = S // chunk
    y_diag, st, cd = ops.ssd_intra_chunk(x, dt, dA, Bm, Cm, chunk=chunk)
    y_off, h_ref = inter_chunk(st, cd, cumsum_f32(dA.reshape(B, nc, chunk, H), 2),
                               Cm.float().reshape(B, nc, chunk, N))
    y_ref = y_diag + y_off.reshape(B, S, H, P)
    torch.cuda.synchronize()
    same = bool(torch.equal(y, y_ref) and torch.equal(h, h_ref))
    print(f"[kernels] ssd_scan {list(shape)}: cumsum_f32 calls {len(calls)}, "
          f"y and final state bitwise those with cumsum_f32's cs: {same}",
          flush=True)
    if calls or not same:
        fail(f"ssd_scan {shape}: {len(calls)} cumsum_f32 calls; bitwise {same}")


def ssd_phase() -> dict:
    """zamba2-7b's prefill shape in float32 (timed) and bfloat16 (timed), S
    equal to the chunk at zamba2's heads, PERF.md's bound case (chunk 256,
    N 128; timed), the reference's sweep shapes, H < 8, and N = P = 128 at
    chunk 256 in one chunk, each in float32 and bfloat16; the full scan's
    cs from the kernel, bitwise; returns zamba2-7b's float32 record, whose
    bound is checked against the count written in PERF.md: 301.2 MB (cs
    included) at 3.35 TB/s, 0.0899 ms, bytes-bound (its operations on the
    TF32 tensor cores take 0.016 ms at 495 TFLOP/s)."""
    import torch
    rec = check_ssd(ZAMBA_SSD, torch.float32, timed=True)
    if rec["bound_by"] != "bytes" or abs(rec["bound_ms"] - 0.0899) > 0.0002:
        fail(f"ssd_scan bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
             f"expected 0.0899 ms (bytes)")
    check_ssd(ZAMBA_SSD, torch.bfloat16, timed=True)
    check_ssd(BOUND_SSD, torch.float32, timed=True)
    for shape in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            check_ssd(shape, dtype, timed=False)
    check_ssd_scan_cs(ZAMBA_SSD)
    return rec


def full_model(arch: str, n_params: int, prompt: int = SERVE_PROMPT,
               num_layers: Optional[int] = None):
    """An arch at its published width (and depth, unless ``num_layers``
    cuts it), random parameters from seed 0 on the card, and a batch of 4
    prompts of ``prompt`` tokens."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = get_arch(arch)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(gen, cfg, "cuda")
    n = M.count_params(params)
    if n != n_params:
        fail(f"{arch} has {n} parameters, expected {n_params}")
    print(f"[serve] {arch}: {n} parameters, {cfg.num_layers} layers", flush=True)
    batch = serve.build_prompt_batch(cfg, SERVE_BATCH, prompt, gen, "cuda")
    return cfg, params, batch


def kernel_wrappers() -> tuple:
    """Every kernel wrapper of the port; each counts its launches."""
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.kernels.dp_perturb import ops as dp_perturb_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return (ops.dp_mix_round, ops.dp_mix_round_sparse, ops.dp_mix_prep_rows,
            ops.dp_mix_gather_rows, dp_perturb_ops.sgd_update,
            dp_perturb_ops.sgd_update_leaves, dp_perturb_ops.dp_perturb,
            fa_ops.flash_attention, ssd_ops.ssd_intra_chunk)


def zero_counts(wrappers) -> None:
    for k in wrappers:
        k.launches = 0


def no_launches(what: str, wrappers) -> None:
    """Fails if any wrapper launched: the serve CLI leaves use_pallas off,
    and the MoE, xLSTM and encoder-decoder families hand it to nothing
    (as the reference's do)."""
    got = {k.__name__: k.launches for k in wrappers if k.launches}
    if got:
        fail(f"{what}: kernel launches {got}, expected none")


def serve_record(cfg, res, B: int, S: int, G: int) -> dict:
    """serve()'s times as tokens/s, and its logits checked finite."""
    import torch
    if not (torch.isfinite(res["prefill_logits"]).all()
            and torch.isfinite(res["logits"]).all()):
        fail(f"serve {cfg.name}: non-finite logits")
    return {"arch": cfg.name, "layers": cfg.num_layers, "vocab": cfg.vocab_size,
            "batch": B,
            "prompt": S, "gen": G, "prefill_ms": 1e3 * res["prefill_s"],
            "prefill_tok_s": B * S / res["prefill_s"],
            "decode_ms": 1e3 * res["decode_s"],
            "decode_step_ms": 1e3 * res["decode_s"] / (G - 1),
            "decode_tok_s": B * (G - 1) / res["decode_s"],
            "prefill_logits_shape": list(res["prefill_logits"].shape),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def serve_cli(arch: str) -> dict:
    """The reference's serve run at full width, ``--arch ARCH --full`` with
    its defaults (batch 4, prompt 64, gen 32), counted: the CLI leaves
    use_pallas off, so no kernel wrapper launches; finite logits, prefill
    logits [4, 64, V], tokens/s and peak device memory."""
    import torch
    from repro_torch.launch import serve
    wrappers = kernel_wrappers()
    zero_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    res = serve.run(["--arch", arch, "--full", "--device", "cuda"])
    rec = dict(serve_record(res["cfg"], res, 4, 64, 32), path="cli --full")
    del res
    torch.cuda.empty_cache()
    print(f"[serve] cli {json.dumps(rec)}", flush=True)
    no_launches(f"serve cli {arch}", wrappers)
    if rec["prefill_logits_shape"] != [4, 64, rec["vocab"]]:
        fail(f"serve cli {arch}: prefill logits {rec['prefill_logits_shape']}")
    return rec


def serve_kernel_path(cfg, params, batch, kernel, others=(),
                      rel_tol: float = 1e-3) -> int:
    """The serve driver with use_pallas=True at full width, counted:
    ``kernel`` launched once per layer that calls it in the prefill
    (cfg.num_layers: gemma-2b's attention layers, zamba2-7b's Mamba2
    layers) and never in a decode step; the wrappers in ``others`` never.
    Then a second, warm prefill, timed. Its prefill logits against a
    prefill without the kernel: |with - without| <= rel_tol max(1, max
    |without|). In float32 rel_tol is 1e-3 (every layer's float32 sums
    taken in other orders; one layer's outputs agree to ~1e-6 relative);
    in bfloat16 see BF16_SERVE_TOL. Returns the launches."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for k in (kernel, *others):
        k.launches = 0
    res = serve.serve(cfg, params, batch, SERVE_GEN, use_pallas=True,
                      device="cuda")
    launches = kernel.launches
    peak = torch.cuda.max_memory_allocated()
    B, S, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    rec = {"arch": cfg.name, "params": M.count_params(params), "batch": B,
           "prompt": S, "gen": G, "prefill_ms": 1e3 * res["prefill_s"],
           "prefill_tok_s": B * S / res["prefill_s"],
           "decode_ms": 1e3 * res["decode_s"],
           "decode_tok_s": B * (G - 1) / res["decode_s"],
           "kernel": kernel.__name__, "launches": launches,
           "other_launches": {k.__name__: k.launches for k in others},
           "peak_mib": peak / 2 ** 20, "held_mib": held / 2 ** 20}
    if launches != cfg.num_layers:
        fail(f"serve {cfg.name}: {kernel.__name__} launched {launches} times "
             f"in one prefill and {G - 1} decode steps, expected "
             f"{cfg.num_layers}")
    if any(rec["other_launches"].values()):
        fail(f"serve {cfg.name}: launches of {rec['other_launches']}")
    if not (torch.isfinite(res["prefill_logits"]).all()
            and torch.isfinite(res["logits"]).all()):
        fail(f"serve {cfg.name}: non-finite logits")
    # the prefill again, warm: the first one pays for cuBLAS's first calls
    # at this dtype and shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M.prefill(params, batch, cfg, use_pallas=True)
    torch.cuda.synchronize()
    rec["warm_prefill_ms"] = 1e3 * (time.perf_counter() - t0)
    rec["warm_prefill_tok_s"] = B * S / (rec["warm_prefill_ms"] / 1e3)
    plain_logits, pf = M.prefill(params, batch, cfg, use_pallas=False)
    scale = float(plain_logits.abs().max())
    err = float((res["prefill_logits"] - plain_logits).abs().max())
    tol = rel_tol * max(1.0, scale)
    rec.update(dtype=cfg.compute_dtype, prefill_logits_err=err,
               logits_scale=scale, tol=tol)
    del res, plain_logits
    # a decode step alone launches nothing
    cache = serve.splice_cache(M.init_cache(cfg, B, S + 1, "cuda"), pf)
    kernel.launches = 0
    M.decode_step(params, {"tokens": batch["tokens"][:, :1]}, cache, S, cfg)
    rec["decode_step_launches"] = kernel.launches
    del cache, pf
    print(f"[serve] {json.dumps(rec)}", flush=True)
    if rec["decode_step_launches"]:
        fail(f"serve {cfg.name}: a decode step launched {kernel.__name__} "
             f"{rec['decode_step_launches']} times")
    if not math.isfinite(err) or err > tol:
        fail(f"serve {cfg.name}: prefill logits with and without the kernel "
             f"differ by {err:.3g} (scale {scale:.3g})")
    torch.cuda.empty_cache()
    return launches


def serve_cpu_vs_cuda(arch: str) -> float:
    """A reduced prefill (use_pallas=True) and decode of ``arch`` on the
    card against the same on the CPU from the same parameters and prompts:
    the CPU run takes the plain versions the tests hold against the JAX
    reference. Tolerance 1e-4 of the largest logit (two float32 layers)."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import exchange as X
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = get_arch(arch).reduced()
    gen = torch.Generator().manual_seed(7)
    params = M.init_params(gen, cfg, "cpu")
    batch = serve.build_prompt_batch(cfg, 4, 64, gen, "cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        res = serve.serve(cfg, X.tree_map(lambda t: t.to(dev), params),
                          {k: v.to(dev) for k, v in batch.items()}, 8,
                          use_pallas=True, device=dev)
        outs[dev] = [res["prefill_logits"].cpu(), res["logits"].cpu()]
    scale = float(outs["cpu"][0].abs().max())
    err = max(float((a - b).abs().max()) for a, b in zip(outs["cuda"], outs["cpu"]))
    tol = 1e-4 * max(1.0, scale)
    print(f"[serve] reduced {arch} cuda vs cpu: max_abs_err={err:.3g} "
          f"(tol {tol:.3g})", flush=True)
    if not math.isfinite(err) or err > tol:
        fail(f"reduced {arch} serve: cuda and cpu differ by {err:.3g} > {tol:.3g}")
    return err


def profile_serve(cfg, params, batch) -> list:
    """One full-width prefill (use_pallas=True) and one decode step, each
    under torch.profiler after a warm-up: the device's busy share and the
    top operators by device and host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    B, S = batch["tokens"].shape
    tok = {"tokens": batch["tokens"][:, :1]}
    _, pf = M.prefill(params, batch, cfg, use_pallas=True)
    cache = serve.splice_cache(M.init_cache(cfg, B, S + 2, "cuda"), pf)
    del pf
    M.decode_step(params, tok, cache, S, cfg)
    windows = (("serve prefill", lambda: M.prefill(params, batch, cfg,
                                                   use_pallas=True)),
               ("serve decode step", lambda: M.decode_step(params, tok, cache,
                                                           S + 1, cfg)))
    recs = []
    for name, fn in windows:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        del out
        stats = prof.key_averages()
        busy_us = device_us(stats)
        rec = {"path": f"{cfg.name} {name}", "wall_ms": wall_us / 1e3,
               "device_busy_share": (busy_us / wall_us if busy_us > 0
                                     else "not measured"),
               "top_device_us": [(e.key, self_device_us(e)) for e in
                                 sorted(stats, key=self_device_us,
                                        reverse=True)[:8]
                                 if self_device_us(e) > 0],
               "top_host_us": [(e.key, e.self_cpu_time_total) for e in
                               sorted(stats, key=lambda e: e.self_cpu_time_total,
                                      reverse=True)[:8]]}
        print(f"[profile] {json.dumps(rec)}", flush=True)
        recs.append(rec)
    return recs

# ---- the zoo: the MoE, xLSTM and encoder-decoder families (ROADMAP A15) ---


def zoo_driver(cfg, params, batch, wrappers) -> dict:
    """The serve driver with use_pallas=True (which these families ignore)
    at the batch's size, gen 32, counted: no kernel launched, finite
    logits, tokens/s and peak device memory; then a second, warm prefill,
    timed."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    B, S = batch["tokens"].shape
    zero_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    res = serve.serve(cfg, params, batch, SERVE_GEN, use_pallas=True,
                      device="cuda")
    rec = dict(serve_record(cfg, res, B, S, SERVE_GEN), path="driver",
               held_gib=held / 2 ** 30)
    del res
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = M.prefill(params, batch, cfg, use_pallas=True)
    torch.cuda.synchronize()
    rec["warm_prefill_ms"] = 1e3 * (time.perf_counter() - t0)
    rec["warm_prefill_tok_s"] = B * S / (rec["warm_prefill_ms"] / 1e3)
    del out
    torch.cuda.empty_cache()
    print(f"[zoo] {json.dumps(rec)}", flush=True)
    no_launches(f"serve {cfg.name}", wrappers)
    return rec


def xlstm_layer_times(cfg, params, batch) -> dict:
    """One prefill with each mLSTM and sLSTM block timed on the host's
    clock between device synchronizes: the prefill's time in each kind."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import xlstm as X
    spent = {"mlstm": 0.0, "slstm": 0.0}
    blocks = {"mlstm": X.mlstm_block_apply, "slstm": X.slstm_block_apply}

    def timed(kind):
        def apply(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = blocks[kind](*args, **kw)
            torch.cuda.synchronize()
            spent[kind] += time.perf_counter() - t0
            return out
        return apply

    X.mlstm_block_apply, X.slstm_block_apply = timed("mlstm"), timed("slstm")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = M.prefill(params, batch, cfg, use_pallas=True)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        X.mlstm_block_apply, X.slstm_block_apply = blocks["mlstm"], blocks["slstm"]
    del out
    B, S = batch["tokens"].shape
    n_slstm = cfg.num_layers // cfg.slstm_every
    rec = {"arch": cfg.name, "batch": B, "prompt": S,
           "prefill_ms": 1e3 * total, "mlstm_ms": 1e3 * spent["mlstm"],
           "slstm_ms": 1e3 * spent["slstm"],
           "slstm_share": spent["slstm"] / total,
           "mlstm_layers": cfg.num_layers - n_slstm, "slstm_layers": n_slstm,
           "slstm_step_us": 1e6 * spent["slstm"] / (n_slstm * S)}
    print(f"[zoo] xlstm layers {json.dumps(rec)}", flush=True)
    return rec


def zoo_phase() -> dict:
    """Phase 9: deepseek-moe-16b at full width and depth in float32 (the
    CLI, the driver at 4 x 1024, the profile), qwen3-moe-235b-a22b at full
    width on 2 layers (the driver at 4 x 64), xlstm-1.3b at full width and
    depth (the CLI, the driver at 4 x 1024, the prefill's time by block
    kind) and whisper-medium at full width and depth (the CLI, the driver
    at 4 x 64), each with its decode graph (``decode_graph_phase``;
    qwen3's at a prompt of 1024) and freed before the next; then each at
    reduced() on the card against the CPU."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    wrappers = kernel_wrappers()
    recs = {}
    print(f"[zoo] held before: {torch.cuda.memory_allocated() / 2 ** 30:.3f} "
          f"GiB", flush=True)

    arch = "deepseek-moe-16b"
    predict("zoo_deepseek")
    recs["deepseek cli"] = serve_cli(arch)
    n_params, layers, prompt = ZOO[arch]
    cfg, params, batch = full_model(arch, n_params, prompt, layers)
    recs["deepseek driver"] = zoo_driver(cfg, params, batch, wrappers)
    zero_counts(wrappers)
    recs["deepseek profile"] = profile_serve(cfg, params, batch)
    no_launches(f"profile {arch}", wrappers)
    recs["decode"] = [decode_graph_phase(arch, cfg, params, batch)]
    del params, batch
    torch.cuda.empty_cache()

    arch = "qwen3-moe-235b-a22b"
    predict("zoo_qwen3")
    n_params, layers, prompt = ZOO[arch]
    cfg, params, batch = full_model(arch, n_params, prompt, layers)
    recs["qwen3 driver"] = zoo_driver(cfg, params, batch, wrappers)
    _, pf = M.prefill(params, {"tokens": batch["tokens"][:, :8]}, cfg)
    if pf["dense"] is not None or pf["moe"]["k"].shape[0] != layers:
        fail(f"{arch}: prefill cache dense {pf['dense'] is not None}, moe "
             f"{tuple(pf['moe']['k'].shape)}")
    del batch, pf
    batch = serve.build_prompt_batch(
        cfg, SERVE_BATCH, SERVE_PROMPT,
        torch.Generator(device="cuda").manual_seed(1), "cuda")
    recs["decode"].append(decode_graph_phase(f"{arch}, 2 layers", cfg,
                                             params, batch))
    del params, batch
    torch.cuda.empty_cache()

    arch = "xlstm-1.3b"
    predict("zoo_xlstm")
    recs["xlstm cli"] = serve_cli(arch)
    n_params, layers, prompt = ZOO[arch]
    cfg, params, batch = full_model(arch, n_params, prompt, layers)
    recs["xlstm driver"] = zoo_driver(cfg, params, batch, wrappers)
    recs["xlstm layers"] = xlstm_layer_times(cfg, params, batch)
    recs["decode"].append(decode_graph_phase(arch, cfg, params, batch))
    del params, batch
    torch.cuda.empty_cache()

    arch = "whisper-medium"
    predict("zoo_whisper")
    cli = recs["whisper cli"] = serve_cli(arch)
    if cli["prefill_logits_shape"] != [4, 64, 51865]:
        fail(f"{arch}: prefill logits {cli['prefill_logits_shape']}, expected "
             f"[4, 64, 51865]")
    n_params, layers, prompt = ZOO[arch]
    cfg, params, batch = full_model(arch, n_params, prompt, layers)
    recs["whisper driver"] = zoo_driver(cfg, params, batch, wrappers)
    recs["decode"].append(decode_graph_phase(arch, cfg, params, batch))
    del params, batch
    torch.cuda.empty_cache()

    predict("zoo_cpu_vs_cuda")
    recs["cpu vs cuda"] = {a: serve_cpu_vs_cuda(a) for a in ZOO}
    return recs


# ---- the decode step as one CUDA graph (DecodeRunner, ROADMAP A7b) ----------

# every kernel of the repo by the name a profiler trace gives it
REPO_KERNELS = TRAIN_KERNELS + ("flash_fwd", "flash_bf16", "ssd_intra")
# a decode turn's untimed steps: the runner's eager step and its capture
DECODE_UNTIMED = 2


def decode_start(cfg, params, batch, gen: int = SERVE_GEN) -> tuple:
    """(cache, token, S): the prompt ``batch`` prefilled, its cache spliced
    into a serving cache of S + gen positions, and the greedy first token,
    as ``serve.serve`` starts its decode."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    B, S = batch["tokens"].shape
    logits, pf = M.prefill(params, batch, cfg)
    cache = serve.splice_cache(
        M.init_cache(cfg, B, S + gen, batch["tokens"].device), pf)
    return cache, torch.argmax(logits[:, -1:], dim=-1), S


def ring_start(cfg, params, batch, gen: int = SERVE_GEN) -> tuple:
    """``decode_start`` for a sliding window W shorter than the cache: the
    prompt is one whole window (S = W), and the serving cache a ring of W
    slots, slot i holding position i's k/v (the state the reference's
    decode from an empty ring reaches at position W; it splices no prefill
    into a ring), so every decode step writes past the window and evicts
    the oldest position."""
    import torch
    from repro_torch.models import model as M
    B, S = batch["tokens"].shape
    W = cfg.sliding_window
    dev = batch["tokens"].device
    logits, pf = M.prefill(params, batch, cfg)
    cache = M.init_cache(cfg, B, S + gen, dev)
    if S != W or "pos" not in cache or cache["k"].shape[2] != W:
        fail(f"{cfg.name}: prompt {S} and cache {tuple(cache['k'].shape)} "
             f"are not one window of {W} in a ring")
    cache["k"].copy_(pf["k"])
    cache["v"].copy_(pf["v"])
    cache["pos"].copy_(torch.arange(W, dtype=torch.int32, device=dev)
                       .expand_as(cache["pos"]))
    return cache, torch.argmax(logits[:, -1:], dim=-1), S


def decode_greedy(decode, params, cache, tok, S: int,
                  steps: int = SERVE_GEN - 1) -> tuple:
    """``steps`` greedy decode steps through ``decode`` (a DecodeRunner, or
    the eager step) from ``cache`` and the token ``tok``: (each step's
    logits [B, steps, V], the tokens [B, steps + 1], the cache, the ms a
    step after the first DECODE_UNTIMED, host clock ending in a
    synchronize)."""
    import torch
    outs, toks = [], [tok]
    for i in range(steps):
        if i == DECODE_UNTIMED:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        logits, cache = decode(params, {"tokens": tok}, cache, S + i)
        tok = torch.argmax(logits, dim=-1)
        outs.append(logits)
        toks.append(tok)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (steps - DECODE_UNTIMED)
    return torch.cat(outs, dim=1), torch.cat(toks, dim=1), cache, ms


def decode_record(logits, toks, cache, copy: bool) -> dict:
    """What a graph and an eager decode are held on, by name: each step's
    logits, the tokens and every cache leaf (copies with ``copy``: the
    runner's cache is rewritten by its next step)."""
    from repro_torch.core import exchange as X
    rec = {"logits": logits, "tokens": toks}
    for i, t in enumerate(X.tree_flatten(cache)[0]):
        if t is not None:
            rec[f"cache/{i}"] = t.clone() if copy else t
    return rec


def decode_differ(got: dict, want: dict) -> list:
    """The names of ``decode_record``'s leaves whose bits differ."""
    return sorted(n for n in want if n not in got
                  or not same_bits(got[n], want[n]))


def decode_graph(cfg, params, batch, start=decode_start) -> dict:
    """One arch's decode through ``serve.DecodeRunner`` (on the card one
    CUDA graph of the step) against the eager ``decode_step``, in turns
    (graph, eager, eager, graph) from one prefilled cache (``start``), each
    turn SERVE_GEN - 1 greedy steps: the graph turns are one runner's two
    waves (its eager step and its capture in the first, replays alone in
    the second). Every turn's logits, tokens and cache leaves against the
    first eager turn's, bitwise; the runner's captures; the repo's kernels
    in a replay's device trace and in an eager step's; each turn's ms a
    step after its first two, tokens/s and peak device memory (allocated,
    reserved, and allocated over what was held at the turn's start: the
    harness holds other turns' caches, the graph's pool once captured);
    the floor: every weight read once, its bytes over the HBM rate."""
    import functools
    import torch
    from repro_torch.core import exchange as X
    from repro_torch.core import trajectory as TJ
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cache0, tok0, S = start(cfg, params, batch)
    B, steps = tok0.shape[0], SERVE_GEN - 1
    runner = serve.DecodeRunner(cfg)
    eager = functools.partial(M.decode_step, cfg=cfg)
    ms = {"graph": [], "eager": []}
    peak = {"graph": [], "eager": []}
    differ, want, first, held = {}, None, None, {}
    for i, turn in enumerate(("graph", "eager", "eager", "graph")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held_gib = torch.cuda.memory_allocated() / 2 ** 30
        logits, toks, cache, step_ms = decode_greedy(
            runner if turn == "graph" else eager, params, TJ.copy_tree(cache0),
            tok0, S, steps)
        ms[turn].append(step_ms)
        top = torch.cuda.max_memory_allocated() / 2 ** 30
        peak[turn].append((top, torch.cuda.max_memory_reserved() / 2 ** 30,
                           top - held_gib))
        # the runner's cache is its graph's buffer: the record copies it
        rec = decode_record(logits, toks, cache, copy=turn == "graph")
        held[turn] = cache
        del logits, toks, cache
        if i == 0:
            first = rec        # held against the first eager turn's
        elif i == 1:
            want = rec
            differ["turn 1 (graph)"] = decode_differ(first, want)
            first = None
        else:
            differ[f"turn {i + 1} ({turn})"] = decode_differ(rec, want)
        del rec
    tok, pos = want["tokens"][:, -1:], S + steps
    # each traced step rewrites the same cache slot with the same values:
    # a session that recorded nothing is repeated
    replay, replay_ops, replay_sessions = traced_seen(
        lambda: runner(params, {"tokens": tok}, held["graph"], pos),
        REPO_KERNELS)
    eager_k, eager_ops, eager_sessions = traced_seen(
        lambda: eager(params, {"tokens": tok}, held["eager"], pos),
        REPO_KERNELS)
    captures = runner.trace_counts()
    del runner, held, want, cache0
    torch.cuda.empty_cache()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in X.tree_flatten(params)[0])
    return {"arch": cfg.name, "dtype": cfg.compute_dtype, "batch": B,
            "prompt": S, "steps": steps,
            "timed_steps": steps - DECODE_UNTIMED, "step_ms": ms,
            "tok_s": {k: [B * 1e3 / m for m in v] for k, v in ms.items()},
            "speedup": [e / g for g, e in zip(ms["graph"],
                                              reversed(ms["eager"]))],
            "floor_ms": 1e3 * weight_bytes / HBM_BYTES_PER_S,
            "weight_gb": weight_bytes / 1e9, "peak_gib": peak,
            "differ": differ, "captures": captures,
            "replay_kernels": replay, "replay_device_ops": replay_ops,
            "replay_trace_sessions": replay_sessions,
            "eager_kernels": eager_k, "eager_device_ops": eager_ops,
            "eager_trace_sessions": eager_sessions}


def decode_graph_phase(label: str, cfg, params, batch,
                       start=decode_start) -> dict:
    """``decode_graph`` of one arch, counted (no kernel wrapper launches
    on a decode path) and held: graph == eager bitwise in every turn, one
    capture, no kernel of the repo in a replay's trace or in an eager
    step's, and traces that saw the replay and the eager step."""
    wrappers = kernel_wrappers()
    zero_counts(wrappers)
    rec = dict(decode_graph(cfg, params, batch, start), label=label)
    print(f"[decode] {json.dumps(rec)}", flush=True)
    no_launches(f"decode {label}", wrappers)
    bad = {turn: names for turn, names in rec["differ"].items() if names}
    if bad:
        fail(f"decode {label}: the graph's and the eager decode differ in "
             f"{bad}")
    if rec["captures"] != {"decode_step": 1}:
        fail(f"decode {label}: captures {rec['captures']}, expected one")
    if rec["replay_kernels"] or rec["eager_kernels"]:
        fail(f"decode {label}: the repo's kernels in a replay "
             f"{rec['replay_kernels']}, in an eager step "
             f"{rec['eager_kernels']}")
    if not rec["replay_device_ops"] or not rec["eager_device_ops"]:
        fail(f"decode {label}: in {TRACE_SESSIONS} profiler sessions each, "
             f"the profiler saw {rec['replay_device_ops']} device operations "
             f"of a replay and {rec['eager_device_ops']} of an eager step")
    return rec


def serve_graph_entry(cfg, params, batch) -> dict:
    """The serve driver, as a user calls it (its decode a DecodeRunner's
    graph on the card), against ``decode_start`` and the eager
    ``decode_step`` greedy loop: the same tokens and last logits, bitwise;
    serve()'s decode seconds over its gen - 1 steps (the runner's eager
    first step and capture included) and the eager loop's ms a step."""
    import functools
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    res = serve.serve(cfg, params, batch, SERVE_GEN,
                      device=batch["tokens"].device)
    cache, tok, S = decode_start(cfg, params, batch)
    logits, toks, cache, step_ms = decode_greedy(
        functools.partial(M.decode_step, cfg=cfg), params, cache, tok, S)
    rec = {"arch": cfg.name, "serve_decode_ms": 1e3 * res["decode_s"],
           "eager_step_ms": step_ms,
           "same": bool(torch.equal(res["tokens"], toks)
                        and same_bits(res["logits"], logits[:, -1:]))}
    del cache, logits
    print(f"[decode] serve() {json.dumps(rec)}", flush=True)
    if not rec["same"]:
        fail(f"serve {cfg.name}: serve()'s tokens or logits differ from the "
             f"eager decode's")
    return rec


# ---- phase 10: LM training (ROADMAP A15) ------------------------------------


def lm_store(N: int, cfg):
    """The CLI's token data on the card: lm_dataset(N 200,000) in N slices,
    windows of LM_SEQ, LM_BATCH a worker."""
    from repro_torch.data import LMStore, lm_dataset
    return LMStore.build(lm_dataset(N * 200_000, cfg.vocab_size, seed=0), N,
                         LM_BATCH, LM_SEQ, "cuda")


def lm_rounds(what: str, body, carry, wrappers, want: str) -> tuple:
    """LM_ROUNDS rounds of ``body``, every kernel count set to 0 just
    before and read just after: ``want`` launched once a round and nothing
    else, every loss finite. Returns (carry, record)."""
    import torch
    zero_counts(wrappers)
    ms, losses = [], []
    for _ in range(LM_ROUNDS):
        t0 = time.perf_counter()
        carry, out = body(carry)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(out["metrics"]["loss"]))
    launches = {k.__name__: k.launches for k in wrappers if k.launches}
    rec = {"rounds": LM_ROUNDS, "launches": launches, "round_ms": ms,
           "losses": losses,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"[lm] {what}: {json.dumps(rec)}", flush=True)
    if launches != {want: LM_ROUNDS}:
        fail(f"{what}: launches {launches}, expected {want} once in each "
             f"of {LM_ROUNDS} rounds")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{what}: non-finite losses {losses}")
    return carry, rec


def profile_lm(what: str, body, carry, n_rounds: int = 2) -> tuple:
    """Where a warm LM round's time goes: ``n_rounds`` rounds of ``body``
    under torch.profiler, the device's busy share and the top operators
    by device time. Returns (carry, record)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import trajectory as TJ
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry, _ = TJ.run_chunk(body, carry, n_rounds)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    stats = prof.key_averages()
    dev, busy_us = self_device_us, device_us(stats)
    rec = {"path": what, "rounds": n_rounds,
           "profiled_round_ms": wall_us / 1e3 / n_rounds,
           "device_busy_share": (busy_us / wall_us if busy_us > 0
                                 else "not measured"),
           "top_device_ms_per_round": [
               (e.key, dev(e) / 1e3 / n_rounds) for e in
               sorted(stats, key=dev, reverse=True)[:10] if dev(e) > 0]}
    print(f"[profile] {json.dumps(rec)}", flush=True)
    return carry, rec


def lm_tree_phase(wrappers) -> dict:
    """olmo-1b at full width and depth, N = LM_TREE_N, the worker-tree
    round with use_pallas through the trajectory body."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    predict("lm_tree")
    cfg, N = get_arch(LM_ARCH), LM_TREE_N
    proto = P.ProtocolConfig(scheme="dwfl", n_workers=N, gamma=0.01, eta=0.4,
                             target_epsilon=1.0, use_pallas=True)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    wp = P.init_worker_params(gen, cfg, N, "cuda")
    leaves = X.tree_flatten(wp)[0]
    n = sum(l[0].numel() for l in leaves)
    shapes = [tuple(l.shape) for l in leaves]
    print(f"[lm] {LM_ARCH}: {n} parameters a worker, {cfg.num_layers} layers, "
          f"{len(leaves)} leaves (sgd_update_leaves takes up to 16 a "
          f"launch), N = {N}", flush=True)
    if n != LM_PARAMS:
        fail(f"{LM_ARCH} has {n} parameters, expected {LM_PARAMS}")
    del leaves
    body = TJ.make_round_body(cfg, proto, lm_store(N, cfg), device="cuda")
    carry = TJ.TrajCarry(gen, wp)
    del wp
    carry, rec = lm_rounds(f"tree round, full depth, N = {N}", body, carry,
                           wrappers, "sgd_update_leaves")
    predict("lm_profile_tree")
    carry, rec["profile"] = profile_lm(f"lm tree, full depth, N = {N}", body,
                                       carry)
    if not tree_leaves_finite(carry.params):
        fail("lm tree round: non-finite parameters")
    rec["shapes"] = shapes
    del carry, body
    torch.cuda.empty_cache()
    return rec


def lm_flat_phase(wrappers) -> dict:
    """olmo-1b at full width on LM_FLAT_LAYERS layers, N = LM_FLAT_N, the
    flat round through the trajectory body. C2 cuts the depth: the full
    depth takes N = 1 alone."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    from repro_torch.kernels.dp_mix import ops
    predict("lm_flat")
    full, N = get_arch(LM_ARCH), LM_FLAT_N
    cw_full = ops._roundup(LM_PARAMS, ops.LANES)
    print(f"[lm] C2 (N roundup(d, 128) <= 2^31 = {ops.COUNTER_LIMIT}): "
          f"{LM_ARCH} at full depth {full.num_layers} layers, d = "
          f"{LM_PARAMS}: N = 2 needs {2 * cw_full} counters (refused), "
          f"the flat round fits N = {ops.COUNTER_LIMIT // cw_full}; cut to "
          f"{LM_FLAT_LAYERS} layers at full width for N = {N}", flush=True)
    cfg = dataclasses.replace(full, num_layers=LM_FLAT_LAYERS)
    proto = P.ProtocolConfig(scheme="dwfl", n_workers=N, gamma=0.01, eta=0.4,
                             target_epsilon=1.0)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    wp = P.init_worker_params(gen, cfg, N, "cuda")
    spec = X.make_flat_spec(wp)
    cw = ops.check_counter_limit(N, spec.d)
    print(f"[lm] flat buffer [{N}, {spec.d}]: {N * cw} counters", flush=True)
    if spec.d != LM_FLAT_D:
        fail(f"{LM_ARCH} on {LM_FLAT_LAYERS} layers has d = {spec.d}, "
             f"expected {LM_FLAT_D}")
    flat = spec.flatten(wp)
    del wp
    body = TJ.make_round_body(cfg, proto, lm_store(N, cfg), spec, "cuda")
    carry = TJ.TrajCarry(gen, flat)
    del flat
    carry, rec = lm_rounds(f"flat round, {LM_FLAT_LAYERS} of "
                           f"{full.num_layers} layers, N = {N}", body, carry,
                           wrappers, "dp_mix_round")
    predict("lm_profile_flat")
    carry, rec["profile"] = profile_lm(f"lm flat, {LM_FLAT_LAYERS} layers, "
                                       f"N = {N}", body, carry)
    if not torch.isfinite(carry.params).all():
        fail("lm flat round: non-finite buffer")
    del carry, body
    torch.cuda.empty_cache()
    return rec


def lm_cli() -> dict:
    """The LM CLI on the card, counted (no kernel: the CLI never sets
    use_pallas), then its --flat-buffer run refused by C2."""
    import torch
    from repro_torch.launch import train
    predict("lm_cli")
    wrappers = kernel_wrappers()
    argv = ["--arch", LM_ARCH, "--workers", str(LM_TREE_N), "--batch-size",
            str(LM_BATCH), "--seq-len", str(LM_SEQ), "--steps", "3"]
    torch.cuda.reset_peak_memory_stats()
    zero_counts(wrappers)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train.run(argv)
    print(out.getvalue(), end="", flush=True)
    # a replay runs no wrapper, but a kernel in the graph was counted when
    # the capture recorded it
    no_launches("the LM CLI", wrappers)
    losses = res["losses"]
    executor = [l for l in out.getvalue().splitlines()
                if l.startswith("[train] executor:")]
    rec = {"rounds": res["rounds"], "seconds": res["seconds"],
           "rounds_per_s": res["rounds"] / res["seconds"],
           "executor": executor, "losses": losses.tolist(),
           "evals": res["evals"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30}
    print(f"[lm] CLI {' '.join(argv)}: {json.dumps(rec)}", flush=True)
    if executor != ["[train] executor: ChunkRunner (one CUDA graph of a "
                    "round, replayed a chunk's rounds, the first chunk "
                    "eager)"]:
        fail(f"the LM CLI ran {executor}, expected ChunkRunner's graph")
    if losses.numel() != 4 or not torch.isfinite(losses).all():
        fail(f"the LM CLI: expected 4 finite losses, got {losses.tolist()}")
    del res
    torch.cuda.empty_cache()
    try:
        train.run(argv + ["--flat-buffer"])
    except SystemExit as e:
        msg = str(e)
    else:
        fail("the LM CLI with --flat-buffer at full depth, N = 2, ran: C2 "
             "should refuse it")
    print(f"[lm] CLI --flat-buffer refused: {msg}", flush=True)
    if "C2" not in msg or "exceeds 2^31" not in msg:
        fail(f"the --flat-buffer refusal does not name C2: {msg}")
    no_launches("the refused flat LM CLI", wrappers)
    torch.cuda.empty_cache()
    return rec


def lm_round_cpu_vs_cuda(flat: bool) -> float:
    """One reduced olmo-1b round (N = 3, batch 2 x 32) on the card against
    the CPU's from the same parameters, batch and seed (flat) or normals
    (tree, use_pallas)."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.data import LMStore, lm_dataset
    cfg, N = get_arch(LM_ARCH).reduced(), 3
    proto = P.ProtocolConfig(n_workers=N, gamma=0.01, eta=0.4,
                             target_epsilon=1.0, use_pallas=not flat)
    gen = torch.Generator().manual_seed(7)
    wp = P.init_worker_params(gen, cfg, N, "cpu")
    store = LMStore.build(lm_dataset(N * 2000, cfg.vocab_size, seed=7), N, 2,
                          32, "cpu")
    batch = store.draw(gen)
    normals = None if flat else X.draw_normals(wp, gen)
    spec = X.FlatSpec(wp)
    to = lambda tree, dev: X.tree_map(lambda t: t.to(dev), tree)
    outs = {}
    for dev in ("cpu", "cuda"):
        if flat:
            step = P.make_flat_train_step(cfg, proto, spec, dev)
            out, _ = step(spec.flatten(wp).to(dev), to(batch, dev),
                          torch.tensor([77], dtype=torch.int32, device=dev))
            outs[dev] = out.cpu()
        else:
            step = P.make_train_step(cfg, proto, dev)
            out, _ = step(to(wp, dev), to(batch, dev), None,
                          normals=to(normals, dev))
            outs[dev] = X.flatten_worker_tree(to(out, "cpu"))
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    tol = 1e-4 * (1.0 + float(outs["cpu"].abs().max()))
    what = "flat" if flat else "tree"
    print(f"[lm] reduced {LM_ARCH} {what} round cuda vs cpu: "
          f"max_abs_err={err:.3g} (tol {tol:.3g})", flush=True)
    if not math.isfinite(err) or err > tol:
        fail(f"reduced {LM_ARCH} {what} round: cuda and cpu differ by "
             f"{err:.3g} > {tol:.3g}")
    return err


def lm_train_phase(counts: dict, rates: dict) -> dict:
    """Phase 10: olmo-1b's tree round at full depth (N = 2, one
    sgd_update_leaves launch a round) and flat round on 4 of 16 layers (N
    = 4, one dp_mix launch a round); both kernels at these shapes against
    their plain twins, timed beside their bounds; the LM CLI on the card
    and its --flat-buffer refused by C2; a reduced round on the card
    against the CPU, flat and tree."""
    import torch
    wrappers = kernel_wrappers()
    print(f"[lm] held before: {torch.cuda.memory_allocated() / 2 ** 30:.3f} "
          f"GiB", flush=True)
    recs = {"tree": lm_tree_phase(wrappers), "flat": lm_flat_phase(wrappers)}
    predict("lm_kernels")
    recs["dp_mix"] = check_dp_mix_windows(LM_FLAT_N, LM_FLAT_D, counts, rates,
                                          plain_window=1 << 22)
    torch.cuda.empty_cache()
    recs["sgd_update_leaves"] = check_leaves(
        torch.float32, timed=True, shapes=recs["tree"]["shapes"],
        graphs=False)
    torch.cuda.empty_cache()
    recs["cli"] = lm_cli()
    predict("lm_cpu_vs_cuda")
    recs["cpu vs cuda"] = {"flat": lm_round_cpu_vs_cuda(True),
                           "tree": lm_round_cpu_vs_cuda(False)}
    return recs

# ---- the fleet (ROADMAP A12) and telemetry (A11) ----------------------------


def fleet_operands(R: int, N: int, d: int, dtype, seed: int = 3):
    """R rounds' operands of dp_mix at [R, N, d] from a fleet round of the
    port's simulator on the card (vehicular: listen = 0 rows where a
    worker straggles): the stacked plan, random p, g and R seeds. Returns
    (proto, args as ops._launch takes them, its keywords)."""
    import torch
    from repro_torch.fleet import FleetEngine
    from repro_torch.kernels.dp_mix import ops
    proto = dynamic_proto(N, FLEET_SCENARIO)
    fleet = FleetEngine(proto, R, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    st = fleet.init(gen)
    for _ in range(3):
        st, chans, _, Ws = fleet.round(gen, st)
    plan = proto.plan(chans, "cuda", Ws)
    p = torch.randn((R, N, d), generator=gen, device="cuda").to(dtype)
    g = (0.1 * torch.randn((R, N, d), generator=gen, device="cuda")).to(dtype)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (R,), dtype=torch.int32,
                          generator=gen, device="cuda")
    vecs = ops._round_vectors(N, p.device, seeds, 0, plan.amp, plan.c,
                              plan.sigma_m, plan.self_scale, plan.m_scale,
                              plan.listen, (R,))
    kw = dict(gamma=proto.gamma, eta=proto.eta, noisy=True,
              counter_width=ops._roundup(d, ops.LANES))
    return proto, (p, g, *vecs, plan.W.contiguous()), kw


def replicate_args(args, r: int):
    """Replicate r's operands of a stack, as one round's launch takes them
    (col0 is shared)."""
    p, g, seed, col0, scal, amp, selfs, mscale, listen, W = args
    return (p[r], g[r], seed[r:r + 1], col0, scal[r], amp[r], selfs[r],
            mscale[r], listen[r], W[r])


def check_raxis(R: int, N: int, d: int, dtype, timed: bool,
                counts: dict, rates: dict) -> dict:
    """dp_mix's replicate axis: one launch over [R, N, d] bitwise R
    separate launches on each replicate's operands, and within
    dp_mix_tolerance of the plain twin replicate by replicate; timed: the
    launch and the R separate launches in turns, the plain stack, and the
    bound (the R rounds' terms summed, on N's route)."""
    import torch
    from types import SimpleNamespace
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.kernels.dp_mix.dp_mix import dp_mix_plain
    proto, args, kw = fleet_operands(R, N, d, dtype)
    batched = lambda: ops._launch(*args, **kw)
    separate = lambda: [ops._launch(*replicate_args(args, r), **kw)
                        for r in range(R)]
    out = batched()
    sep = torch.stack(separate())
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    differ = int((out.view(bits) != sep.view(bits)).sum())
    del sep
    max_err, bad, tol = 0.0, 0, 0.0
    for r in range(R):
        a = replicate_args(args, r)
        ref = dp_mix_plain(*a, **kw).float()
        k32 = out[r].float()
        plan = SimpleNamespace(amp=a[5], c=a[4][0], m_scale=a[7],
                               sigma_m=a[4][1])
        allowed, tol_r = dp_mix_tolerance(N, a[0], a[1], proto.gamma, plan,
                                          True, k32, ref,
                                          dtype == torch.bfloat16)
        err = (k32 - ref).abs()
        max_err = max(max_err, float(err.max()))
        bad += int((err > allowed).sum())
        tol = max(tol, tol_r)
        if not torch.isfinite(k32).all():
            fail(f"dp_mix replicate axis R={R} N={N}: non-finite output")
    del out
    rec = {"R": R, "N": N, "d": d, "dtype": str(dtype).split(".")[-1],
           "route": dp_mix_route(N, d), "differ_vs_separate": differ,
           "max_abs_err": max_err, "tol_f32": tol, "violations": bad,
           "listen_zero": int((args[8] == 0).sum())}
    if timed:
        ms = {"batched": [], "separate": []}
        for name in ("batched", "separate", "separate", "batched"):
            ms[name].append(cuda_ms(batched if name == "batched" else separate,
                                    iters=20 if N <= 16 else 3))
        rec["ms_in_turns"] = ms
        rec["ms"] = min(ms["batched"])
        rec["separate_ms"] = min(ms["separate"])
        rec["plain_ms"] = cuda_ms(lambda: [dp_mix_plain(
            *replicate_args(args, r), **kw) for r in range(R)], iters=1,
            warmup=1)
        works = [dp_mix_work(N, d, args[0].element_size(), True, counts,
                             rates, noise_branches(N, d, kw["counter_width"],
                                                   int(args[2][r])))
                 for r in range(R)]
        # the R rounds' terms summed (dp_mix_work's, on N's route)
        summed = lambda key: {k: sum(w[key][k] for w in works)
                              for k in works[0][key]}
        t = summed("terms_ms")
        bound = max(t.values())
        rec.update({"bytes_ms": t["bytes"],
                    "instructions_ms": t["instructions"], "terms_ms": t,
                    "bound_ms": bound,
                    "bound_by": ("bytes" if t["bytes"] == bound
                                 else "operations")})
        if "cuda_core_terms_ms" in works[0]:
            rec["cuda_core_bound_ms"] = max(
                summed("cuda_core_terms_ms").values())
    print(f"[kernels] dp_mix replicate axis {json.dumps(rec)}", flush=True)
    if differ or bad:
        fail(f"dp_mix replicate axis R={R} N={N} {rec['dtype']}: {differ} "
             f"elements differ from the separate launches, {bad} beyond the "
             f"plain twin's tolerance (max err {max_err:.3g})")
    return rec


def raxis_phase(counts: dict, rates: dict) -> dict:
    """The replicate axis on both routes; returns the path case's record
    (R 8, N 10, float32)."""
    import torch
    predict("raxis")
    path_rec = None
    for R, N, d in RAXIS_CASES:
        for dtype in ((torch.float32, torch.bfloat16) if N == PATH_N
                      else (torch.float32,)):
            rec = check_raxis(R, N, d, dtype, True, counts, rates)
            if N == PATH_N and dtype == torch.float32:
                path_rec = rec
            torch.cuda.empty_cache()
    return path_rec


def shard_logical_phase(store, counts: dict, rates: dict) -> dict:
    """The model axis's logical mode at the path's shape: dp_mix over the
    padded buffer of S column windows (one launch, col0 = 0, the layout's
    counter width) bitwise the one launch over the unpadded buffer at S =
    2 and 4, each window within dp_mix_tolerance of its plain twin at its
    col0, and each window's own launch (the mesh's form: col0 = s
    shard_width) bitwise the same columns; timed in turns with the
    unpadded launch through the same wrapper (the device's time, by CUDA
    graphs: the host's, which a call of a few kernels outlasts, as well),
    beside the plain twins and the bound (dp_mix_work over the padded
    width); then the static and dynamic sharded steps against the
    unsharded steps. Returns S = 2's record."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.kernels.dp_mix.dp_mix import dp_mix_plain
    from repro_torch.shard import (ShardLayout, dp_mix_round_sharded,
                                   make_sharded_dynamic_flat_train_step,
                                   make_sharded_flat_train_step,
                                   shard_window_round)
    predict("shard_logical")
    proto, plan, args, kw = dp_mix_args(PATH_N, PATH_D, torch.float32, True)
    p, g, seed, _, *rest = args
    whole = lambda: ops.dp_mix_round_plan(p, g, seed, plan, gamma=proto.gamma,
                                          eta=proto.eta)
    out = whole()
    bits = lambda t: t.contiguous().view(torch.int32)
    first = None
    for S in SHARD_COUNTS:
        lay = ShardLayout(PATH_D, S)
        pp, gp = lay.pad(p), lay.pad(g)
        sharded = lambda: dp_mix_round_sharded(
            pp, gp, seed, plan, lay, gamma=proto.gamma, eta=proto.eta)
        ops.dp_mix_round.launches = 0
        got = sharded()
        torch.cuda.synchronize()
        launches = ops.dp_mix_round.launches
        sw = lay.shard_width
        windows = [(s * sw, (s + 1) * sw) for s in range(S)]

        def plain():
            return [dp_mix_plain(
                pp[:, a:b].contiguous(), gp[:, a:b].contiguous(), seed,
                torch.tensor([a], dtype=torch.int32, device="cuda"), *rest,
                gamma=kw["gamma"], eta=kw["eta"], noisy=True,
                counter_width=lay.counter_width) for a, b in windows]

        max_err, bad = 0.0, 0
        for (a, b), ref in zip(windows, plain()):
            real = min(b, PATH_D) - a
            k32, r32 = got[:, a:a + real].float(), ref[:, :real].float()
            allowed, tol = dp_mix_tolerance(PATH_N, pp[:, a:a + real],
                                            gp[:, a:a + real], proto.gamma,
                                            plan, True, k32, r32, False)
            err = (k32 - r32).abs()
            max_err = max(max_err, float(err.max()))
            bad += int((err > allowed).sum())
        windows_differ = sum(int((bits(shard_window_round(
            pp[:, a:b].contiguous(), gp[:, a:b].contiguous(), seed, plan, a,
            lay, gamma=proto.gamma, eta=proto.eta)) != bits(got[:, a:b]))
            .sum()) for a, b in windows)
        rec = {"S": S, "shard_width": sw, "padded_width": lay.padded_width,
               "launches": launches, "windows_differ": windows_differ,
               "differ": int((bits(lay.unpad(got)) != bits(out)).sum()),
               "padding_nonzero": int((got[:, PATH_D:] != 0).sum()),
               "max_abs_err": max_err, "tol_f32": tol, "violations": bad}
        del got
        ms = [graph_ms(f) for f in (whole, sharded, sharded, whole)]
        host = [cuda_ms(f, iters=20) for f in (whole, sharded, sharded,
                                                whole)]
        rec.update(whole_ms=[ms[0], ms[3]], ms=min(ms[1], ms[2]),
                   ms_turns=[ms[1], ms[2]], host_ms=host,
                   plain_ms=cuda_ms(plain, iters=2, warmup=1))
        branches = noise_branches(PATH_N, lay.padded_width,
                                  lay.counter_width, 1234567)
        rec.update(dp_mix_work(PATH_N, lay.padded_width, 4, True, counts,
                               rates, branches))
        print(f"[shard] model-axis windows {json.dumps(rec)}", flush=True)
        if (launches != 1 or rec["differ"] or rec["padding_nonzero"]
                or windows_differ or bad):
            fail(f"the model axis's windows at S = {S}: {rec}")
        first = first or rec
        torch.cuda.empty_cache()
    del out
    # the sharded steps at full width against the unsharded ones
    cfg = DWFL_PAPER
    gen = torch.Generator(device="cuda").manual_seed(0)
    wp = P.init_worker_params(gen, cfg, PATH_N, "cuda")
    batch = store.draw(gen)
    dproto = dynamic_proto(PATH_N, flat_buffer=True)
    sim = dproto.simulator("cuda")
    _, chan, _, W = sim.round(gen, sim.init(gen))
    spec0 = X.FlatSpec(wp)
    sproto = dataclasses.replace(dproto, channel_model="static")
    want_s = P.make_flat_train_step(cfg, sproto, spec0, "cuda")(
        spec0.flatten(wp), batch, 77)
    want_d = P.make_dynamic_flat_train_step(cfg, dproto, spec0, "cuda")(
        spec0.flatten(wp), batch, 78, chan, W)
    steps = {}
    for S in SHARD_COUNTS:
        spec = X.make_flat_spec(wp, n_shards=S)
        got_s = make_sharded_flat_train_step(cfg, sproto, spec,
                                             device="cuda")(
            spec.flatten(wp), batch, 77)
        got_d = make_sharded_dynamic_flat_train_step(cfg, dproto, spec,
                                                     device="cuda")(
            spec.flatten(wp), batch, 78, chan, W)
        for name, want, got in (("static", want_s, got_s),
                                ("dynamic", want_d, got_d)):
            steps[f"{name} S={S}"] = {
                "differ": int((bits(spec.unpad(got[0])) != bits(want[0]))
                              .sum()),
                "metrics_differ": [k for k in want[1] if not torch.equal(
                    want[1][k], got[1][k])]}
    print(f"[shard] sharded steps against the unsharded ones "
          f"{json.dumps(steps)}", flush=True)
    if any(v["differ"] or v["metrics_differ"] for v in steps.values()):
        fail(f"a logical sharded step is not bitwise the unsharded one: "
             f"{steps}")
    return first


def _free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def shard_cli_checkpoint() -> dict:
    """The sharded flat CLI (--model-shards 2, logical on one card) with
    --checkpoint, dp_mix's count set to 0 just before and read just after
    (one launch a round); its buffer and losses against the unsharded
    CLI's; then the resume: the checkpoint restored (checkpoint.
    restore_flat, resume_carry) and run CKPT_STEPS + 1 more rounds through
    the trajectory body, against the CLI run for all the rounds at once."""
    import torch
    from repro_torch import checkpoint
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.launch import train
    predict("shard_cli")
    path = str(ROOT / "build" / "chip_smoke_checkpoint" / "run")
    base = ["--arch", "dwfl-paper", "--flat-buffer", "--workers",
            str(PATH_N), "--eval-every", "0", "--device", "cuda"]
    sharded = base + ["--model-shards", "2"]
    ops.dp_mix_round.launches = 0
    res = train.run(sharded + ["--steps", str(CKPT_STEPS), "--checkpoint",
                               path])
    launches = ops.dp_mix_round.launches
    plain = train.run(base + ["--steps", str(CKPT_STEPS)])
    d = plain["params"].shape[1]
    bits = lambda t: t.contiguous().view(torch.int32)
    whole_args = sharded + ["--steps", str(2 * CKPT_STEPS + 1)]
    whole = train.run(whole_args)
    args = train.parse_args(whole_args)
    wp = P.init_worker_params(torch.Generator(device="cuda"), DWFL_PAPER,
                              PATH_N, "cuda")
    spec = X.make_flat_spec(wp, n_shards=2)
    del wp
    flat, state, manifest = checkpoint.restore_flat(
        path, spec, {"generator": torch.Generator(device="cuda").get_state()},
        "cuda")
    body = TJ.make_round_body(DWFL_PAPER, train.protocol_config(args),
                              paper_store(), spec, "cuda")
    carry, out = TJ.run_chunk(body, checkpoint.resume_carry(state, flat,
                                                            "cuda"),
                              CKPT_STEPS + 1)
    rounds = res["rounds"]
    rec = {"rounds": rounds, "launches": launches,
           "vs_unsharded_differ": int(
               (bits(res["params"][:, :d]) != bits(plain["params"])).sum()),
           "losses_equal": bool(torch.equal(res["losses"], plain["losses"])),
           "checkpoint_step": manifest["step"],
           "checkpoint_leaves": sorted(manifest["leaves"]),
           "resume_differ": int((bits(carry.params)
                                 != bits(whole["params"])).sum()),
           "resume_losses_equal": bool(torch.equal(
               out["metrics"]["loss"].cpu(), whole["losses"][rounds:]))}
    print(f"[shard] sharded CLI and checkpoint {json.dumps(rec)}", flush=True)
    if (launches != rounds or rec["vs_unsharded_differ"]
            or not rec["losses_equal"] or rec["resume_differ"]
            or not rec["resume_losses_equal"]
            or not torch.isfinite(res["losses"]).all()):
        fail(f"the sharded CLI or its resume: {rec}")
    return rec


def worker_rows_case(proto, plan, p, g, S: int):
    """(stitched, plain_window): the worker axis's round on one card, S row
    windows stitched by hand (each prep with its row0, every window's z
    concatenated, each gather), and its plain twin over a column window
    [a, b) of every row window."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.kernels.dp_mix.dp_mix import (dp_mix_gather_plain,
                                                   dp_mix_prep_plain)
    N = p.shape[0]
    nb = N // S
    rows = [slice(s * nb, (s + 1) * nb) for s in range(S)]
    kw = dict(gamma=proto.gamma, eta=proto.eta)

    def stitched():
        ws = [ops.dp_mix_prep_rows(p[r], g[r], 1234567, plan.amp[r], plan.c,
                                   gamma=proto.gamma, row0=r.start,
                                   n_workers=N) for r in rows]
        z = torch.cat([w[0] for w in ws])
        outs = [ops.dp_mix_gather_rows(
            p[r], g[r], w, z, 1234567, plan.W[r], plan.amp[r], plan.c,
            plan.sigma_m, row0=r.start, m_scale=plan.m_scale[r],
            listen=plan.listen[r], **kw) for r, w in zip(rows, ws)]
        del ws, z
        return torch.cat(outs)

    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device="cuda")
    scal = torch.stack([plan.c.reshape(()), plan.sigma_m.reshape(())])
    cw = ops._roundup(p.shape[1], ops.LANES)

    def plain_window(a, b):
        pw, gw = p[:, a:b].contiguous(), g[:, a:b].contiguous()
        ws = [dp_mix_prep_plain(pw[r], gw[r], i32(1234567), i32(a), scal,
                                plan.amp[r], gamma=proto.gamma, noisy=True,
                                counter_width=cw, row0=r.start) for r in rows]
        z = torch.cat([w[0] for w in ws])
        return torch.cat([dp_mix_gather_plain(
            pw[r], gw[r], w, z, i32(1234567), i32(a), scal, plan.amp[r],
            torch.ones(nb, device="cuda"), plan.m_scale[r], plan.listen[r],
            plan.W.idx[r], plan.W.w[r], plan.W.self_w[r], noisy=True,
            counter_width=cw, row0=r.start, **kw)
            for r, w in zip(rows, ws)])

    return stitched, plain_window


def worker_axis_phase(counts: dict, rates: dict, width: int = 4096) -> dict:
    """The worker axis's row windows at the worker-scale path's shape (N =
    2048, d = 855,050, a mesh_sparse round's list at k = 12), S =
    WORKER_SHARDS windows stitched on one card: bitwise the unsharded
    dp_mix_round_sparse, within the sparse round's tolerance of the plain
    twins over three column windows, timed in turns with the unsharded
    round beside the plain twins (2^16-column windows) and the bound
    (sparse_work): the row-window kernels alone (the S preps, then the S
    gathers from a z gathered once) and the stitched round with its
    copies (z's, and the S outputs' into one buffer); its peak memory."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    predict("worker_axis")
    proto, plan, _, W = sparse_round(SPARSE_N)
    gen = torch.Generator(device="cuda").manual_seed(SPARSE_N + PATH_D)
    p = torch.randn((SPARSE_N, PATH_D), generator=gen, device="cuda")
    g = 0.1 * torch.randn((SPARSE_N, PATH_D), generator=gen, device="cuda")
    whole = lambda: ops.dp_mix_round_plan(p, g, 1234567, plan,
                                          gamma=proto.gamma, eta=proto.eta)
    stitched, plain_window = worker_rows_case(proto, plan, p, g,
                                              WORKER_SHARDS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.dp_mix_prep_rows.launches = ops.dp_mix_gather_rows.launches = 0
    got = stitched()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = (ops.dp_mix_prep_rows.launches,
                ops.dp_mix_gather_rows.launches)
    want = whole()
    torch.cuda.synchronize()
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    del want
    max_err, bad, tol = 0.0, 0, 0.0
    for a in (0, (PATH_D // 2) // width * width,
              PATH_D - (PATH_D % width or width)):
        b = min(a + width, PATH_D)
        ref = plain_window(a, b).float()
        k32 = got[:, a:b].float()
        allowed, tol = dp_mix_tolerance(W.k + 1, p[:, a:b], g[:, a:b],
                                        proto.gamma, plan, True, k32, ref,
                                        False)
        err = (k32 - ref).abs()
        max_err = max(max_err, float(err.max()))
        bad += int((err > allowed).sum())
        del ref, k32, err, allowed
    finite = bool(torch.isfinite(got).all())
    del got
    torch.cuda.empty_cache()
    ms = [cuda_ms(f, iters=3, warmup=1)
          for f in (whole, stitched, stitched, whole)]
    nb = SPARSE_N // WORKER_SHARDS
    rows = [slice(s * nb, (s + 1) * nb) for s in range(WORKER_SHARDS)]
    preps = lambda: [ops.dp_mix_prep_rows(
        p[r], g[r], 1234567, plan.amp[r], plan.c, gamma=proto.gamma,
        row0=r.start, n_workers=SPARSE_N) for r in rows]
    ws = preps()
    z = torch.cat([w[0] for w in ws])
    gathers = lambda: [ops.dp_mix_gather_rows(
        p[r], g[r], w, z, 1234567, plan.W[r], plan.amp[r], plan.c,
        plan.sigma_m, gamma=proto.gamma, eta=proto.eta, row0=r.start,
        m_scale=plan.m_scale[r], listen=plan.listen[r])
        for r, w in zip(rows, ws)]
    kernels = [cuda_ms(preps, iters=3, warmup=1),
               cuda_ms(gathers, iters=3, warmup=1)]
    del ws, z
    torch.cuda.empty_cache()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    plain_window(0, 1 << 16)
    torch.cuda.synchronize()
    start.record()
    for a in range(0, PATH_D, 1 << 16):
        plain_window(a, min(a + (1 << 16), PATH_D))
    end.record()
    torch.cuda.synchronize()
    nnz = int(W.valid().sum())
    rec = {"N": SPARSE_N, "d": PATH_D, "k": W.k, "S": WORKER_SHARDS,
           "launches": launches, "differ": differ, "max_abs_err": max_err,
           "tol_f32": tol, "violations": bad, "ms": sum(kernels),
           "prep_gather_ms": kernels, "stitched_ms": [ms[1], ms[2]],
           "whole_ms": [ms[0], ms[3]],
           "plain_ms": start.elapsed_time(end),
           "peak_gib": peak / 2 ** 30, "held_gib": held / 2 ** 30}
    branches = noise_branches(SPARSE_N, PATH_D,
                              ops._roundup(PATH_D, ops.LANES), 1234567)
    rec.update(sparse_work(SPARSE_N, PATH_D, W.k, 4, True, nnz, counts,
                           rates, branches))
    print(f"[shard] worker-axis row windows {json.dumps(rec)}", flush=True)
    if (differ or bad or not finite
            or launches != (WORKER_SHARDS, WORKER_SHARDS)):
        fail(f"the worker axis's row windows: {rec}")
    del p, g
    torch.cuda.empty_cache()
    return rec


def mesh_telemetry_run(kind: str, mesh, on: bool, store, rounds: int
                       ) -> dict:
    """A warm round, then ``rounds`` rounds in one chunk, of the dynamic
    flat trajectory under the CLI's sync guard: kind "model" (iot_dense at
    (10, 855,050), the one-window layout, its window on ``mesh``'s "model"
    axis) or "workers" (mesh_sparse at N = 2048, k 12, its rows on
    ``mesh``'s "workers" axis); ``mesh`` None: the logical mode (the
    unsharded buffer for the worker axis). ``on``: every telemetry column
    and epsilon (``TelemetrySpec()``). Returns the chunk's telemetry rows,
    carry.eps and its seconds on the host's clock."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    from repro_torch.obs import (TelemetrySpec, init_eps_moments,
                                 no_implicit_transfers)
    from repro_torch.shard import ShardLayout, local_rows, local_window
    if kind == "model":
        N, proto = PATH_N, dynamic_proto(PATH_N, flat_buffer=True)
    else:
        N, proto = SPARSE_N, sparse_proto(SPARSE_N, flat_buffer=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    sim = proto.simulator("cuda")
    wp = P.init_worker_params(gen, DWFL_PAPER, N, "cuda")
    spec = (X.make_flat_spec(wp, layout=ShardLayout(X.FlatSpec(wp).d, 1))
            if kind == "model" else X.FlatSpec(wp))
    flat = spec.flatten(wp)
    del wp
    if mesh is not None:
        flat = (local_window(flat, spec, mesh) if kind == "model"
                else local_rows(flat, mesh))
    axes = ({"shard_mesh": mesh} if kind == "model"
            else {"worker_mesh": mesh})
    body = TJ.make_round_body(DWFL_PAPER, proto, store, spec, "cuda",
                              sim=sim, telemetry=TelemetrySpec() if on
                              else None, **axes)
    carry = TJ.TrajCarry(gen, flat, sim.init(gen),
                         init_eps_moments(device="cuda") if on else None)
    del flat
    with no_implicit_transfers(True, "cuda"):          # as the CLI runs it
        carry, _ = TJ.run_chunk(body, carry, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, out = TJ.run_chunk(body, carry, rounds)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    rec = {"rows": out.get("telemetry"), "eps": carry.eps,
           "seconds": seconds}
    del body, carry, out
    torch.cuda.empty_cache()
    return rec


def mesh_telemetry(stores: dict) -> dict:
    """Telemetry over a one-rank process-group mesh (ROADMAP A21): the
    model-axis trajectory at (10, 855,050) and the worker-axis trajectory
    at N = 2048, with every column and epsilon, each on its one-rank
    group against the logical mode (rows and carry.eps bitwise: one rank,
    the same sums); and on the mesh, telemetry on against off in turns
    (on, off, off, on): its cost."""
    import torch
    from repro_torch.launch.mesh import make_shard_mesh, make_worker_mesh
    predict("mesh_telemetry")
    bits = lambda t: t.contiguous().view(torch.int32)
    meshes = {"model": make_shard_mesh(1, device="cuda"),
              "workers": make_worker_mesh(1, device="cuda")}
    rounds = {"model": 10, "workers": 2}
    rec = {}
    for kind, mesh in meshes.items():
        logical = mesh_telemetry_run(kind, None, True, stores[kind],
                                     rounds[kind])
        runs = {"on": [], "off": []}
        for on in (True, False, False, True):
            runs["on" if on else "off"].append(mesh_telemetry_run(
                kind, mesh, on, stores[kind], rounds[kind]))
        got = runs["on"][0]
        on_s = min(r["seconds"] for r in runs["on"]) / rounds[kind]
        off_s = min(r["seconds"] for r in runs["off"]) / rounds[kind]
        rec[kind] = {
            "rounds": rounds[kind],
            "rows_differ": int((bits(got["rows"])
                                != bits(logical["rows"])).sum()),
            "eps_differ": int((bits(got["eps"])
                               != bits(logical["eps"])).sum()),
            "rows_finite_but_snr": bool(torch.isfinite(
                got["rows"][:, [0, 1, 2, 4, 5, 6]]).all()),
            "ms_on_in_turns": [1e3 * r["seconds"] / rounds[kind]
                               for r in runs["on"]],
            "ms_off_in_turns": [1e3 * r["seconds"] / rounds[kind]
                                for r in runs["off"]],
            "telemetry_cost": on_s / off_s - 1.0}
    print(f"[shard] telemetry on one-rank meshes {json.dumps(rec)}",
          flush=True)
    for kind, r in rec.items():
        if r["rows_differ"] or r["eps_differ"] or not r["rows_finite_but_snr"]:
            fail(f"telemetry on the one-rank {kind} mesh: {r}")
    return rec


def mesh_one_rank_phase(store) -> dict:
    """The process-group paths on a one-rank NCCL group (NCCL puts one rank
    on a card): the model-axis mesh step against the logical one at S =
    1, the (1, 1) fleet mesh round against the logical fleet round, and
    the worker-axis trajectory at the worker-scale shape (3 rounds; the
    row windows' counts set to 0 just before and read just after) against
    the unsharded trajectory; then both trajectories with telemetry on
    (``mesh_telemetry``). Returns the worker-axis run's counts."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    from repro_torch.fleet import FleetEngine
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.launch.mesh import (make_shard_mesh, make_worker_mesh)
    from repro_torch.obs import no_implicit_transfers
    from repro_torch.shard import (ShardLayout, local_rows, local_window,
                                   make_sharded_flat_train_step)
    predict("mesh_one_rank")
    bits = lambda t: t.contiguous().view(torch.int32)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    rec = {"ranks": 1, "cards": torch.cuda.device_count()}
    try:
        cfg = DWFL_PAPER
        gen = torch.Generator(device="cuda").manual_seed(1)
        wp = P.init_worker_params(gen, cfg, PATH_N, "cuda")
        batch = store.draw(gen)
        proto = dynamic_proto(PATH_N, flat_buffer=True)
        sproto = dataclasses.replace(proto, channel_model="static")
        spec = X.make_flat_spec(wp, layout=ShardLayout(X.FlatSpec(wp).d, 1))
        mesh = make_shard_mesh(1, device="cuda")
        logical = make_sharded_flat_train_step(cfg, sproto, spec,
                                               device="cuda")
        meshed = make_sharded_flat_train_step(cfg, sproto, spec, mesh=mesh,
                                              device="cuda")
        f_a, m_a = logical(spec.flatten(wp), batch, 5)
        window = local_window(spec.flatten(wp), spec, mesh)
        with no_implicit_transfers(True, "cuda"):     # as the CLI runs it
            f_b, m_b = meshed(window, batch, 5)
        rec["model_axis_differ"] = int((bits(f_a) != bits(f_b)).sum())
        rec["model_axis_loss_equal"] = bool(torch.equal(m_a["loss"],
                                                        m_b["loss"]))
        # the fleet on a (replicas 1, model 1) mesh
        fleet = FleetEngine(dataclasses.replace(proto, replicates=2),
                            device="cuda")
        wpR = fleet.init_worker_params(gen, cfg)
        specR = X.make_flat_spec(wpR, lead_axes=2, n_shards=None,
                                 layout=ShardLayout(spec.d, 1))
        batchR = store.draw_fleet(gen, 2)
        fmesh = make_shard_mesh(1, n_replicas=1, device="cuda")
        outs = []
        for m in (None, fmesh):
            fgen = torch.Generator(device="cuda").manual_seed(2)
            states = fleet.init(fgen)
            flat = specR.flatten(wpR)
            if m is not None:
                flat = local_window(flat, specR, m)
            _, flat, _, _, _ = fleet.make_fleet_round(cfg, spec=specR,
                                                      mesh=m)(
                fgen, states, flat, batchR)
            outs.append(flat)
        rec["fleet_2d_differ"] = int((bits(outs[0]) != bits(outs[1])).sum())
        del wp, wpR, outs, f_a, f_b
        # the worker axis at the worker-scale shape, through the trajectory
        wproto = sparse_proto(SPARSE_N, flat_buffer=True)
        wstore = paper_store(SPARSE_N)
        wmesh = make_worker_mesh(1, device="cuda")
        finals = []
        for m in (wmesh, None):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            wgen = torch.Generator(device="cuda").manual_seed(3)
            sim = wproto.simulator("cuda")
            wp = P.init_worker_params(wgen, cfg, SPARSE_N, "cuda")
            wspec = X.FlatSpec(wp)
            flat = wspec.flatten(wp)
            del wp
            if m is not None:
                flat = local_rows(flat, m)
            body = TJ.make_round_body(cfg, wproto, wstore, wspec, "cuda",
                                      sim=sim, worker_mesh=m)
            ops.dp_mix_prep_rows.launches = 0
            ops.dp_mix_gather_rows.launches = 0
            ops.dp_mix_round_sparse.launches = 0
            carry = TJ.TrajCarry(wgen, flat, sim.init(wgen))
            with no_implicit_transfers(True, "cuda"):  # as the CLI runs it
                carry, out = TJ.run_chunk(body, carry, 3)
            del flat, body
            torch.cuda.synchronize()
            if m is not None:
                rec["worker_launches"] = {
                    "dp_mix_prep_rows": ops.dp_mix_prep_rows.launches,
                    "dp_mix_gather_rows": ops.dp_mix_gather_rows.launches,
                    "dp_mix_round_sparse": ops.dp_mix_round_sparse.launches}
                rec["worker_peak_gib"] = (torch.cuda.max_memory_allocated()
                                          / 2 ** 30)
                rec["worker_losses_finite"] = bool(
                    torch.isfinite(out["metrics"]["loss"]).all())
            finals.append(carry.params)
            del carry, out
        rec["worker_axis_differ"] = int((bits(finals[0])
                                         != bits(finals[1])).sum())
        del finals
        rec["telemetry"] = mesh_telemetry({"model": store,
                                           "workers": wstore})
        rec["graph"] = graph_mesh(mesh, fmesh)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"[shard] process groups {json.dumps(rec)}", flush=True)
    wl = rec["worker_launches"]
    if (rec["model_axis_differ"] or not rec["model_axis_loss_equal"]
            or rec["fleet_2d_differ"] or rec["worker_axis_differ"]
            or wl["dp_mix_prep_rows"] != 3 or wl["dp_mix_gather_rows"] != 3
            or wl["dp_mix_round_sparse"]
            or not rec["worker_losses_finite"]):
        fail(f"a process-group path: {rec}")
    return rec


# 6 rounds in chunks of 2: the eager first chunk, the capture's, a replay
TWO_CARD_STEPS, TWO_CARD_CHUNK = 5, 2
TWO_CARD_TIMEOUT = 300      # seconds a CLI run's rank may take


class _Tee(io.TextIOBase):
    """Standard output written through, its lines kept."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text: str) -> int:
        self.out.write(text)
        self.out.flush()
        self.lines.extend(text.splitlines())
        return len(text)


def _cli_rank(rank: int, port: int, argv: list, out_dir: str) -> None:
    """One rank of two_card_cli as torchrun starts it: torchrun's
    environment (RANK, LOCAL_RANK, WORLD_SIZE, the rendezvous address), then
    ``launch.train.run(argv)``, which picks its card and starts its NCCL
    group from that, under a hang watchdog; its parameters (its window or
    its rows), losses and executor line saved."""
    import os
    _arm_watchdog(TWO_CARD_TIMEOUT)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    sys.path.insert(0, str(SRC))
    import torch
    from repro_torch.launch import train
    say = _Steps(rank, out_dir)
    say(f"train.run {' '.join(argv)}")
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        res = train.run(list(argv))
    say("done")
    run_dir = res["runlog_dir"]
    torch.save({"params": res["params"].cpu(), "losses": res["losses"],
                "telemetry": res["telemetry"],
                "executor": [l for l in tee.lines
                             if l.startswith("[train] executor:")],
                "runlog_dir": None if run_dir is None else str(run_dir)},
               f"{out_dir}/rank{rank}.pt")
    import faulthandler
    faulthandler.cancel_dump_traceback_later()


def two_card_cli() -> dict:
    """The training CLI on two cards, each rank started as torchrun starts
    it: ``--model-shards 2`` (a column window a card) bitwise the logical
    run on this card, buffer and losses; ``--worker-shards 2`` on
    mesh_sparse at N = 2048 (k 12; the rows a card) within rtol 1e-5, atol
    3e-5 of the unsharded sparse CLI, the losses bitwise. Both with
    ``--runlog-dir`` (telemetry on): rank 0 alone writes a run log, and its
    round rows agree with the one-card run's telemetry (``--telemetry
    on``): the model axis bitwise but consensus (rtol 1e-6, a sum of the
    ranks' partial sums), the worker axis's channel columns bitwise, its
    loss bitwise, grad_norm and consensus within rtol 1e-5 (the buffer's
    tolerance)."""
    import torch
    from repro_torch.launch import train
    predict("two_cards")
    base = ["--arch", "dwfl-paper", "--flat-buffer", "--eval-every", "0",
            "--steps", str(TWO_CARD_STEPS), "--chunk-rounds",
            str(TWO_CARD_CHUNK), "--device", "cuda"]
    model = base + ["--workers", str(PATH_N), "--model-shards", "2"]
    sparse = base + ["--workers", str(SPARSE_N), "--channel-model",
                     "dynamic", "--scenario", SPARSE_SCENARIO,
                     "--sparse-neighbors", str(SPARSE_K)]
    rec = {"cards": torch.cuda.device_count(), "steps": TWO_CARD_STEPS}
    ranks = {}
    logs = {}
    for name, argv in (("model", model),
                       ("worker", sparse + ["--worker-shards", "2"])):
        out_dir = ROOT / "build" / f"chip_smoke_two_cards_{name}"
        if out_dir.exists():
            shutil.rmtree(out_dir)
        out_dir.mkdir(parents=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        spawn_ranks(_cli_rank, (_free_port(), argv + [
            "--runlog-dir", str(out_dir / "runs")], str(out_dir)), 2,
                    TWO_CARD_TIMEOUT, f"the CLI on two cards, {name}",
                    out_dir)
        rec[f"{name}_seconds"] = time.perf_counter() - t0
        ranks[name] = [torch.load(out_dir / f"rank{r}.pt",
                                  weights_only=False) for r in range(2)]
        rec[f"{name}_executor"] = [r["executor"] for r in ranks[name]]
        if not all(len(r["executor"]) == 1 and r["executor"][0].startswith(
                "[train] executor: ChunkRunner (one CUDA graph")
                   for r in ranks[name]):
            fail(f"the CLI on two cards, {name}: executor "
                 f"{rec[f'{name}_executor']}, expected ChunkRunner's graph")
        dirs = sorted(str(d) for d in (out_dir / "runs").iterdir())
        rec[f"{name}_run_logs"] = len(dirs)
        if (dirs != [ranks[name][0]["runlog_dir"]]
                or ranks[name][1]["runlog_dir"] is not None):
            fail(f"the CLI on two cards, {name}: run logs {dirs}, ranks' "
                 f"{[r['runlog_dir'] for r in ranks[name]]}")
        events = [json.loads(line) for line in
                  (Path(dirs[0]) / "events.jsonl").read_text().splitlines()]
        logs[name] = [e for e in events if e["type"] == "round"]
    bits = lambda t: t.contiguous().view(torch.int32)
    fields = list(TELEMETRY_FIELDS)

    def log_rows(name, want_rows):
        """rank 0's run-log rows against the one-card run's telemetry:
        (columns bitwise, the largest relative difference of the rest)."""
        got = torch.tensor([[e[f] for f in fields] for e in logs[name]],
                           dtype=torch.float32)
        want_rows = want_rows.float()
        if got.shape != want_rows.shape:
            fail(f"the CLI on two cards, {name}: {tuple(got.shape)} run-log "
                 f"rows for {tuple(want_rows.shape)} telemetry rows")
        # NaN (a round with no listener's SNR) matches NaN
        got = torch.where(got.isnan(), float("nan"), got)
        want_rows = torch.where(want_rows.isnan(), float("nan"), want_rows)
        same = [f for i, f in enumerate(fields)
                if torch.equal(bits(got[:, i]), bits(want_rows[:, i]))]
        rel = {f: float(((got[:, i] - want_rows[:, i]).abs()
                         / want_rows[:, i].abs().clamp_min(1e-30)).max())
               for i, f in enumerate(fields) if f not in same}
        return same, rel

    want = train.run(model + ["--telemetry", "on"])
    same, rel = log_rows("model", want["telemetry"])
    rec["model_log_bitwise"], rec["model_log_rel"] = same, rel
    if set(rel) - {"consensus"} or rel.get("consensus", 0.0) > 1e-6:
        fail(f"the CLI on two cards, model: run-log rows {rel}")
    got = torch.cat([r["params"] for r in ranks["model"]], dim=1)
    rec["model_differ"] = int((bits(got) != bits(want["params"].cpu()))
                              .sum())
    rec["model_losses_equal"] = all(torch.equal(r["losses"], want["losses"])
                                    for r in ranks["model"])
    del want, got
    torch.cuda.empty_cache()
    want = train.run(sparse + ["--telemetry", "on"])
    same, rel = log_rows("worker", want["telemetry"])
    rec["worker_log_bitwise"], rec["worker_log_rel"] = same, rel
    if (set(rel) - {"consensus", "grad_norm"}
            or max(rel.values(), default=0.0) > 1e-5):
        fail(f"the CLI on two cards, worker: run-log rows {rel}")
    got = torch.cat([r["params"] for r in ranks["worker"]])
    ref = want["params"].cpu()
    del want["params"]
    torch.cuda.empty_cache()
    err = (got - ref).abs()
    rec["worker_max_abs_err"] = float(err.max())
    rec["worker_violations"] = int((err > 3e-5 + 1e-5 * ref.abs()).sum())
    rec["worker_losses_equal"] = all(torch.equal(r["losses"], want["losses"])
                                     for r in ranks["worker"])
    rec["finite"] = bool(torch.isfinite(got).all())
    del got, ref, err, ranks
    print(f"[shard] two cards {json.dumps(rec)}", flush=True)
    if (rec["model_differ"] or not rec["model_losses_equal"]
            or rec["worker_violations"] or not rec["worker_losses_equal"]
            or not rec["finite"]):
        fail(f"the CLI on two cards: {rec}")
    return rec


# ---- the graph over several NCCL ranks (A7b) -------------------------------

# the bodies held on a mesh of several ranks, one rank a card: the
# model-axis round (iot_dense at (10, 855,050), a column window a rank),
# the fleet (vehicular, R = FLEET_R) on a (replicas 1, model S) mesh, the
# worker axis (mesh_sparse at (SPARSE_N, 855,050, k SPARSE_K), rows a
# rank); "allreduce" is the smallest capture, one all_reduce replayed
MESH_GRAPH_CASES = ("allreduce", "model", "fleet", "workers")
MESH_GRAPH_K = {"model": 4, "fleet": 4, "workers": 2}
# chunks a timed turn (graph, eager, eager, graph), each after the
# turn's untimed first chunks
MESH_GRAPH_TURN_CHUNKS = {"model": 5, "fleet": 5, "workers": 3}
# seconds a case may take: each rank's hang watchdog, and its parent's
MESH_GRAPH_TIMEOUT = 240


class _Steps:
    """A rank's progress: each step printed with the rank (flushed) and
    written to ``out_dir/rank<r>.step``, where the parent reads the last
    one of a rank that hung or failed."""

    def __init__(self, rank: int, out_dir: str):
        self.rank, self.path = rank, Path(out_dir) / f"rank{rank}.step"

    def __call__(self, step: str) -> None:
        self.path.write_text(step)
        print(f"[rank {self.rank}] {step}", flush=True)


def _arm_watchdog(seconds: float) -> None:
    """A hang watchdog for this process: after ``seconds`` every
    thread's Python stack on stderr, then exit 1 (faulthandler's own
    thread: it needs no GIL, so a thread stuck in a CUDA or NCCL call is
    caught too)."""
    import faulthandler
    faulthandler.dump_traceback_later(seconds, exit=True)


def spawn_ranks(fn, args: tuple, nprocs: int, timeout: float, what: str,
                out_dir: Path) -> None:
    """``fn(rank, *args)`` on ``nprocs`` processes (torch.multiprocessing),
    each with its own hang watchdog (``fn`` arms it); the parent waits at
    most ``timeout`` + 30 s, then kills every rank. A rank that fails,
    hangs or is killed fails the phase, naming each rank's last step."""
    import torch.multiprocessing as mp
    ctx = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.time() + timeout + 30
    try:
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                raise TimeoutError(f"past {timeout + 30:.0f} s")
    except Exception as e:  # noqa: BLE001 (a rank's failure is the phase's)
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        steps = {r: (Path(out_dir) / f"rank{r}.step").read_text()
                 if (Path(out_dir) / f"rank{r}.step").exists() else None
                 for r in range(nprocs)}
        fail(f"{what}: {type(e).__name__}: {e}; each rank's last step: "
             f"{steps}")


# the body cases' sizes for a run on the CPU over gloo ranks (the harness's
# own test; the card takes the full sizes)
MESH_GRAPH_SMALL = dict(N=8, hidden=16, dataset=400, batch=8, k=4)


def _mesh_graph_body(case: str, world: int, device: str,
                     small: bool = False):
    """(body, carry, the B1 kernels a round) of a body case over a mesh of
    ``world`` ranks as the CLI builds it under torchrun, at full width
    (``small``: MESH_GRAPH_SMALL's sizes)."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    from repro_torch.launch.mesh import make_shard_mesh, make_worker_mesh
    from repro_torch.shard import local_rows
    sz = MESH_GRAPH_SMALL if small else {}
    kw = {k: v for k, v in sz.items() if k != "k"}
    if case == "model":
        return (*mesh_graph_path("mesh model",
                                 make_shard_mesh(world, device=device),
                                 device=device, **kw), ("dp_mix_columns",))
    if case == "fleet":
        return (*mesh_graph_path("mesh fleet",
                                 make_shard_mesh(world, n_replicas=1,
                                                 device=device),
                                 device=device, R=2 if small else FLEET_R,
                                 **kw), ("dp_mix_columns",))
    N = sz.get("N", SPARSE_N)
    cfg = (dataclasses.replace(DWFL_PAPER, d_model=sz["hidden"]) if small
           else DWFL_PAPER)
    proto = dynamic_proto(N, SPARSE_SCENARIO, flat_buffer=True,
                          sparse_neighbors=sz.get("k", SPARSE_K))
    if small:
        from repro_torch.data import (ClassificationStore,
                                      classification_dataset,
                                      dirichlet_partition)
        x, y = classification_dataset(sz["dataset"], seed=0)
        store = ClassificationStore.build(
            x, y, dirichlet_partition(y, N, alpha=0.5, seed=0), sz["batch"],
            device)
    else:
        store = paper_store(N)
    mesh = make_worker_mesh(world, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    sim = proto.simulator(device)
    wp = P.init_worker_params(gen, cfg, N, device)
    spec = X.FlatSpec(wp)
    flat = local_rows(spec.flatten(wp), mesh)
    del wp
    body = TJ.make_round_body(cfg, proto, store, spec, device, sim=sim,
                              worker_mesh=mesh)
    return (body, TJ.TrajCarry(gen, flat, sim.init(gen)),
            ("dp_mix_prep", "dp_mix_gather"))


def _agreed_trace(fn):
    """``traced(fn)`` for the repo's kernels and NCCL's, retaken while a
    session recorded no device operation on any rank (every rank takes
    as many sessions: ``fn`` runs collectives), at most TRACE_SESSIONS:
    (the kernels summed over the sessions, the sessions taken)."""
    import torch
    import torch.distributed as dist
    got = {}
    for n in range(1, TRACE_SESSIONS + 1):
        _, kernels, ops = traced(fn, TRAIN_KERNELS + ("nccl",))
        for name, c in kernels.items():
            got[name] = got.get(name, 0) + c
        empty = torch.tensor([0 if ops else 1], device="cuda")
        dist.all_reduce(empty)
        if not int(empty.item()):
            break
    return got, n


def _sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def _mesh_turns(case: str, body, carry, say, device: str) -> tuple:
    """ms a round of the body through ChunkRunner and run_chunk in turns
    (graph, eager, eager, graph; every rank alike), host clock around
    MESH_GRAPH_TURN_CHUNKS[case] chunks of MESH_GRAPH_K[case] rounds
    ending in a synchronize, a graph turn a new runner (its eager chunk
    and its capture untimed); each turn's peak allocated and reserved
    GiB, over the turn and past its first chunk (a graph turn's capture
    and replays without the runner's eager first chunk). Returns (the
    record, the carry)."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.core import trajectory as TJ
    K, chunks = MESH_GRAPH_K[case], MESH_GRAPH_TURN_CHUNKS[case]
    cuda = device == "cuda"
    ms = {"graph": [], "eager": []}
    peak = {"graph": [], "eager": []}
    past = {"graph": [], "eager": []}
    gib = lambda: (torch.cuda.max_memory_allocated() / 2 ** 30,
                   torch.cuda.max_memory_reserved() / 2 ** 30)
    for turn in ("graph", "eager", "eager", "graph"):
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        runner = TJ.ChunkRunner(body) if turn == "graph" else None
        run = (runner.run if runner is not None else
               (lambda c, n: TJ.run_chunk(body, c, n)))
        for n in range(2 if turn == "graph" else 1):
            carry, _ = run(carry, K)
            if n == 0 and cuda:
                torch.cuda.synchronize()
                first = gib()
                torch.cuda.reset_peak_memory_stats()
        _sync(device)
        dist.barrier()
        say(f"turn {turn}")
        t0 = time.perf_counter()
        for _ in range(chunks):
            carry, _ = run(carry, K)
        _sync(device)
        ms[turn].append(1e3 * (time.perf_counter() - t0) / (chunks * K))
        if cuda:
            past[turn].append(gib())
            peak[turn].append(tuple(max(a, b) for a, b
                                    in zip(first, past[turn][-1])))
        if runner is not None:
            runner.close()      # as the CLI does before the group goes
        del run, runner
    return {"rounds_a_chunk": K, "chunks": chunks, "ms_a_round": ms,
            "peak_gib": peak, "peak_past_first_gib": past}, carry


def _mesh_graph_rank(rank: int, world: int, port: int, case: str,
                     out_dir: str, timeout: float, turns: bool,
                     device: str = "cuda", small: bool = False) -> None:
    """One rank of ``mesh_graph_ranks``: its card (NCCL) or the CPU
    (gloo), the process group, then the case, each step said; its record
    to ``out_dir/rank<r>.json``."""
    _arm_watchdog(timeout)
    sys.path.insert(0, str(SRC))
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch import runtime
    from repro_torch.core import trajectory as TJ
    say = _Steps(rank, out_dir)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    say("init_process_group")
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=max(30, timeout / 2)))
    rec = {"case": case, "rank": rank, "world": world, "device": device}
    try:
        if case == "allreduce":
            x = torch.full((1 << 20,), float(rank + 1), device=device)
            say("eager all_reduce")
            dist.all_reduce(x)
            _sync(device)
            total = world * (world + 1) / 2
            if cuda:
                graph, _ = runtime.capture_graph(
                    lambda: dist.all_reduce(x), torch.cuda.Stream(),
                    what="one all_reduce")
                for n in range(2):
                    say(f"replay {n}")
                    graph.replay()
                    torch.cuda.synchronize()
                del graph
                total *= world ** 2
            rec["values"] = sorted(set(x.tolist()))
            rec["want"] = total
            rec["ok"] = rec["values"] == [total]
        else:
            K = MESH_GRAPH_K[case]
            say("build the body")
            body, carry, kernels = _mesh_graph_body(case, world, device,
                                                    small)
            # its graphs freed as the block ends, before the group
            with TJ.ChunkRunner(body) as runner:
                say("eager first chunk")
                carry, _ = runner.run(carry, K)
                _sync(device)
                twin = TJ.copy_carry(carry)
                say("the capture's chunk")
                carry, out1 = runner.run(carry, K)
                _sync(device)
                say("a replay")
                carry, out2 = runner.run(carry, K)
                _sync(device)
                got = chunk_record(carry, (out1, out2))
                del out1, out2
                replay_k, sessions = {}, 0
                if cuda:
                    say("a replay under the profiler")
                    replay_k, sessions = _agreed_trace(
                        lambda: runner.run(carry, K))
                rec["captures"] = {str(k): n for k, n
                                   in runner.trace_counts().items()}
            say("the same chunks through run_chunk")
            c, e1 = TJ.run_chunk(body, twin, K)
            c, e2 = TJ.run_chunk(body, c, K)
            want = chunk_record(c, (e1, e2))
            del c, e1, e2, twin
            differ, spread = bits_spread(got, want)
            del got, want
            nccl = replay_k.get("nccl", 0)
            rec.update(rounds=K, differ=differ, max_abs_diff=spread,
                       kernels_replay=replay_k, trace_sessions=sessions,
                       nccl_replay=nccl, b1_kernels=list(kernels))
            rec["ok"] = not differ and (not cuda or (
                rec["captures"] == {str(K): 1} and nccl > 0
                and all(replay_k.get(k, 0) == K for k in kernels)))
            del runner
            if turns:
                rec["turns"], carry = _mesh_turns(case, body, carry, say,
                                                  device)
            del carry, body
    finally:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))
        _sync(device)
        say("destroy_process_group")
        dist.destroy_process_group()
    say("done")
    import faulthandler
    faulthandler.cancel_dump_traceback_later()


def mesh_graph_ranks(case: str, ranks: int = 2,
                     timeout: float = MESH_GRAPH_TIMEOUT,
                     turns: bool = True, out_dir: Optional[Path] = None,
                     device: str = "cuda", small: bool = False) -> list:
    """One of MESH_GRAPH_CASES on ``ranks`` NCCL ranks (one a card, a
    tcp://localhost rendezvous), each with its hang watchdog
    (``timeout`` s); a body case through ChunkRunner, its first chunk
    eager, then the capture's chunk and a replay (MESH_GRAPH_K[case]
    rounds each), held bitwise against the same chunks through
    run_chunk from a copy of the carry, one capture, a replay's kernels
    from the profiler's trace (NCCL's, and B1's or B1-sparse's once a
    round); then, with ``turns``, ms a round graph against eager
    (``_mesh_turns``). ``device`` "cpu": gloo ranks
    (the runner's eager program; the harness's own test), at
    MESH_GRAPH_SMALL's sizes with ``small``. Returns the ranks'
    records."""
    out_dir = Path(out_dir or ROOT / "build" / f"mesh_graph_{case}")
    if out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    spawn_ranks(_mesh_graph_rank,
                (ranks, _free_port(), case, str(out_dir), timeout, turns,
                 device, small),
                ranks, timeout, f"the graph over {ranks} ranks, {case}",
                out_dir)
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(ranks)]


def mesh_graph_phase() -> dict:
    """The library check on two cards: the smallest capture, then each
    body case (``mesh_graph_ranks``) on two NCCL ranks: the graph
    bitwise run_chunk, one capture a chunk length a rank, NCCL's kernels
    and B1's or B1-sparse's in a replay's trace; ms a round graph against
    eager in turns and each turn's peak memory."""
    predict("mesh_graph")
    recs = {}
    for case in MESH_GRAPH_CASES:
        t0 = time.perf_counter()
        ranks = mesh_graph_ranks(case)
        recs[case] = {"seconds": time.perf_counter() - t0, "ranks": ranks}
        print(f"[mesh-graph] {case} {json.dumps(recs[case])}", flush=True)
        if not all(r["ok"] for r in ranks):
            fail(f"the graph over two NCCL ranks, {case}: {ranks}")
    return recs


def two_cards_main() -> int:
    """``python3 chip_smoke.py --two-cards``: two_card_cli and
    mesh_graph_phase alone, on a machine with two cards or more."""
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        fail("--two-cards needs two cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"[device] {kind} x{count}; nvidia-smi: {smi}", flush=True)
    from repro_torch.kernels import build
    from repro_torch.kernels.dp_mix import ops
    build.build_all([ops.LIBRARY])
    two_card_cli()
    mesh_graph_phase()
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


def fleet_cli() -> dict:
    """The fleet CLI at full width (the README's vehicular line with the
    flat buffer) under the profiler's device trace, the dp_mix count set
    to 0 just before and read just after: one launch a fleet round for
    all R in the trace (``cli_launches``), under the CLI's sync guard (on
    by default); the guard must raise on a .item()."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.launch import train
    from repro_torch.obs import no_implicit_transfers
    predict("fleet_cli")
    probe = torch.ones(1, device="cuda")
    try:
        with no_implicit_transfers(True, "cuda"):
            probe.sum().item()
        fail("sync debug mode 'error' let a .item() through")
    except RuntimeError:
        pass
    ops.dp_mix_round.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res, device, _ = traced(lambda: train.run([
        "--arch", "dwfl-paper", "--flat-buffer", "--channel-model",
        "dynamic", "--scenario", FLEET_SCENARIO, "--replicates",
        str(FLEET_R), "--workers", str(PATH_N), "--steps", str(FLEET_STEPS),
        "--eval-every", str(FLEET_STEPS // 2), "--device", "cuda"]))
    launches = ops.dp_mix_round.launches
    rep, losses, rounds = res["epsilon_report"], res["losses"], res["rounds"]
    rec = {"scenario": FLEET_SCENARIO, "replicates": FLEET_R,
           "rounds": rounds, "launches": launches,
           "device_launches": device, "seconds": res["seconds"],
           "rounds_per_s_traced": rounds / res["seconds"],
           "replicate_rounds_per_s_traced":
               FLEET_R * rounds / res["seconds"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "first_loss": losses[0].tolist(), "last_loss": losses[-1].tolist(),
           "eps_replicates": rep["replicates"], "eps_rounds": rep["rounds"],
           "eps_composed_mean": rep["epsilon_composed_mean"],
           "eps_total_mean": rep["epsilon_total_mean"]}
    print(f"[fleet] cli {json.dumps(rec)}", flush=True)
    cli_launches("fleet cli", launches, device, rounds,
                 {k: rounds for k in ROUTE_KERNELS[
                     dp_mix_route(PATH_N, PATH_D)]})
    if (tuple(losses.shape) != (rounds, FLEET_R)
            or not torch.isfinite(losses).all()
            or not torch.isfinite(res["params"]).all()
            or rep["replicates"] != FLEET_R or rep["rounds"] != rounds
            or not np_finite(rep["epsilon_per_round"])):
        fail("fleet cli: non-finite or misshapen losses, parameters or "
             "epsilons")
    return rec


def fleet_body(store, R: int, flat: bool, use_pallas: bool = False):
    """A fleet round body at full width (vehicular, N = 10) and its carry."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import trajectory as TJ
    from repro_torch.fleet import FleetEngine
    proto = dynamic_proto(PATH_N, FLEET_SCENARIO, use_pallas=use_pallas)
    fleet = FleetEngine(proto, R, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(R)
    wp = fleet.init_worker_params(gen, DWFL_PAPER)
    spec = X.FlatSpec(wp, lead_axes=2) if flat else None
    body = TJ.make_round_body(DWFL_PAPER, proto, store, spec, "cuda",
                              fleet=fleet)
    return body, TJ.TrajCarry(gen, spec.flatten(wp) if flat else wp,
                              fleet.init(gen))


def fleet_tree(store) -> int:
    """The fleet's tree round (R 8, use_pallas) under the sync guard, the
    dp_perturb counts set to 0 just before and read just after: one
    sgd_update_leaves launch a round for all R."""
    import torch
    from repro_torch.core import trajectory as TJ
    from repro_torch.kernels.dp_perturb import ops
    from repro_torch.obs import no_implicit_transfers
    predict("fleet_tree")
    body, carry = fleet_body(store, FLEET_R, flat=False, use_pallas=True)
    carry, _ = TJ.run_chunk(body, carry, 1)
    torch.cuda.synchronize()
    ops.sgd_update_leaves.launches = 0
    ops.sgd_update.launches = ops.dp_perturb.launches = 0
    with no_implicit_transfers(True, "cuda"):
        carry, out = TJ.run_chunk(body, carry, FLEET_TREE_ROUNDS)
    torch.cuda.synchronize()
    launches = ops.sgd_update_leaves.launches
    others = ops.sgd_update.launches + ops.dp_perturb.launches
    losses = out["metrics"]["loss"].cpu()
    print(f"[fleet] tree {json.dumps({'replicates': FLEET_R, 'rounds': FLEET_TREE_ROUNDS, 'launches': launches, 'last_loss': losses[-1].tolist()})}",
          flush=True)
    if launches != FLEET_TREE_ROUNDS or others:
        fail(f"fleet tree: sgd_update_leaves launched {launches} times for "
             f"{FLEET_TREE_ROUNDS} rounds, the per-leaf wrappers {others}")
    if not (torch.isfinite(losses).all() and tree_leaves_finite(carry.params)):
        fail("fleet tree: non-finite losses or parameters")
    return launches


_LAUNCH_KEYS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def fleet_launches(store, n_rounds: int = 10) -> dict:
    """Kernel launches per fleet flat round at R = 2 and R = 8 under
    torch.profiler (the host's launch calls, and the device's kernels),
    which must be equal: the replicates add work to each launch, not
    launches; and the device's busy share. Both traces are taken again,
    at most TRACE_SESSIONS times, while their device operations differ
    and their host launch calls do not (a session once recorded 2 device
    operations fewer or more in 10 rounds than the other, over the same
    launch calls): a real difference shows in every session."""
    predict("fleet_launches")
    for n in range(1, TRACE_SESSIONS + 1):
        rec = fleet_launch_traces(store, n_rounds)
        print(f"[fleet] launches per round {json.dumps(rec)}", flush=True)
        a, b = rec[2], rec[FLEET_R]
        if (a["launch_calls_per_round"] != b["launch_calls_per_round"]
                or a["device_ops_per_round"] == b["device_ops_per_round"]):
            break
        print(f"[trace] fleet launches: session {n} of {TRACE_SESSIONS} "
              f"recorded other device operations at R = 2 and {FLEET_R} "
              f"over the same launch calls", flush=True)
    if (a["launch_calls_per_round"] != b["launch_calls_per_round"]
            or a["device_ops_per_round"] != b["device_ops_per_round"]):
        fail(f"fleet round: launches differ between R = 2 and R = {FLEET_R}:"
             f" {rec}")
    return rec


def fleet_launch_traces(store, n_rounds: int) -> dict:
    """``fleet_launches``'s traces, one session each at R = 2 and R =
    FLEET_R: launch calls and device operations a round, the busy
    share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import trajectory as TJ
    rec = {}
    for R in (2, FLEET_R):
        body, carry = fleet_body(store, R, flat=True)
        carry, _ = TJ.run_chunk(body, carry, 3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            carry, _ = TJ.run_chunk(body, carry, n_rounds)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        stats = prof.key_averages()
        host = sum(e.count for e in stats if e.key in _LAUNCH_KEYS)
        kernels = sum(e.count for e in stats
                      if e.device_type == DeviceType.CUDA)
        busy = device_us(stats)
        rec[R] = {"launch_calls_per_round": host / n_rounds,
                  "device_ops_per_round": kernels / n_rounds,
                  "profiled_round_ms": wall_us / 1e3 / n_rounds,
                  "device_us_per_round": busy / n_rounds,
                  "device_busy_share": (busy / wall_us if busy > 0
                                        else "not measured")}
        del body, carry
        torch.cuda.empty_cache()
    return rec


def fleet_turns(store, n_rounds: int = 20) -> dict:
    """The single dynamic flat round (N = 10, vehicular) and the R 8 fleet
    round, warm, host clock around n_rounds ending in a synchronize, in
    turns (single, fleet, fleet, single): rounds/s and replicate-rounds/s."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    predict("fleet_turns")
    proto = dynamic_proto(PATH_N, FLEET_SCENARIO)
    gen = torch.Generator(device="cuda").manual_seed(0)
    wp = P.init_worker_params(gen, DWFL_PAPER, PATH_N, "cuda")
    spec = X.FlatSpec(wp)
    sim = proto.simulator("cuda")
    single = TJ.make_round_body(DWFL_PAPER, proto, store, spec, "cuda",
                                sim=sim)
    state = {"single": TJ.TrajCarry(gen, spec.flatten(wp), sim.init(gen))}
    fleet, state["fleet"] = fleet_body(store, FLEET_R, flat=True)
    bodies = {"single": single, "fleet": fleet}
    for name in bodies:
        for _ in range(5):
            state[name] = bodies[name](state[name])[0]
    ms = {"single": [], "fleet": []}
    for name in ("single", "fleet", "fleet", "single"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_rounds):
            state[name] = bodies[name](state[name])[0]
        torch.cuda.synchronize()
        ms[name].append(1e3 * (time.perf_counter() - t0) / n_rounds)
    rec = {"rounds": n_rounds, "replicates": FLEET_R, "round_ms": ms,
           "single_rounds_per_s": [1e3 / m for m in ms["single"]],
           "fleet_replicate_rounds_per_s": [FLEET_R * 1e3 / m
                                            for m in ms["fleet"]]}
    # each fleet reading against the single reading beside it in the turns
    rec["speedup"] = [f / s for f, s in zip(
        rec["fleet_replicate_rounds_per_s"], rec["single_rounds_per_s"])]
    print(f"[fleet] in turns {json.dumps(rec)}", flush=True)
    return rec


def fleet_sparse_operands(R: int, N: int, d: int, seed: int = 5):
    """R sparse rounds' operands at [R, N, d] from a fleet round of the
    port's simulator on the card (mesh_sparse, k = SPARSE_K): (proto, the
    stacked plan_dynamic_sparse plan, random p and g, R int32 seeds)."""
    import torch
    from repro_torch.fleet import FleetEngine
    proto = sparse_proto(N)
    fleet = FleetEngine(proto, R, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    st = fleet.init(gen)
    for _ in range(2):
        st, chans, _, Ws = fleet.round(gen, st)
    plan = proto.plan(chans, "cuda", Ws)
    p = torch.randn((R, N, d), generator=gen, device="cuda")
    g = 0.1 * torch.randn((R, N, d), generator=gen, device="cuda")
    seeds = torch.randint(-2 ** 31, 2 ** 31, (R,), dtype=torch.int32,
                          generator=gen, device="cuda")
    return proto, plan, p, g, seeds


def check_sparse_raxis(R: int, N: int, d: int, counts: dict, rates: dict,
                       width: int = 4096) -> dict:
    """The sparse round's replicate axis (one dp_mix_prep and one
    dp_mix_gather launch over [R, N, d], float32, noisy) on a fleet round's
    stacked neighbor lists: bitwise R separate launches of the wrapper on
    each replicate's operands; each replicate within the sparse round's
    tolerance of its plain twin over three column windows (check_sparse's);
    timed in turns with the R separate launches, the plain twin over the
    whole stack in 2^16-column windows, and the bound (sparse_work of each
    replicate at its realized slots, summed)."""
    import torch
    from types import SimpleNamespace
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.kernels.dp_mix.dp_mix import dp_mix_sparse_plain
    from repro_torch.net.sparse import isolated_count
    predict("fleet_sparse_kernel")
    proto, plan, p, g, seeds = fleet_sparse_operands(R, N, d)
    sw = plan.W
    k = sw.k
    kw = dict(gamma=proto.gamma, eta=proto.eta)
    batched = lambda: ops.dp_mix_round_sparse(
        p, g, seeds, sw, plan.amp, plan.c, plan.sigma_m,
        m_scale=plan.m_scale, listen=plan.listen, **kw)
    one = lambda r: ops.dp_mix_round_sparse(
        p[r], g[r], seeds[r], sw[r], plan.amp[r], plan.c[r],
        plan.sigma_m[r], m_scale=plan.m_scale[r], listen=plan.listen[r],
        **kw)
    separate = lambda: [one(r) for r in range(R)]
    before = ops.dp_mix_round_sparse.launches
    out = batched()
    calls = ops.dp_mix_round_sparse.launches - before
    differ = 0
    for r in range(R):
        differ += int((out[r].view(torch.int32)
                       != one(r).view(torch.int32)).sum())
    torch.cuda.synchronize()
    cw = ops._roundup(d, ops.LANES)

    def window(r, a, b):
        vecs = ops._round_vectors(N, p.device, seeds[r], a, plan.amp[r],
                                  plan.c[r], plan.sigma_m[r], None,
                                  plan.m_scale[r], plan.listen[r])
        return dp_mix_sparse_plain(
            p[r, :, a:b].contiguous(), g[r, :, a:b].contiguous(), *vecs,
            sw.idx[r], sw.w[r], sw.self_w[r], noisy=True, counter_width=cw,
            **kw)

    max_err, bad, tol = 0.0, 0, 0.0
    for r in range(R):
        plan_r = SimpleNamespace(amp=plan.amp[r], c=plan.c[r],
                                 m_scale=plan.m_scale[r],
                                 sigma_m=plan.sigma_m[r])
        for a in (0, (d // 2) // width * width, d - (d % width or width)):
            b = min(a + width, d)
            ref = window(r, a, b).float()
            k32 = out[r, :, a:b].float()
            if not torch.isfinite(k32).all():
                fail(f"sparse replicate axis: non-finite output, replicate "
                     f"{r}, columns [{a}, {b})")
            allowed, tol_r = dp_mix_tolerance(k + 1, p[r, :, a:b],
                                              g[r, :, a:b], proto.gamma,
                                              plan_r, True, k32, ref, False)
            err = (k32 - ref).abs()
            max_err = max(max_err, float(err.max()))
            bad += int((err > allowed).sum())
            tol = max(tol, tol_r)
    del out
    torch.cuda.empty_cache()
    nnz = [int(sw[r].valid().sum()) for r in range(R)]
    rec = {"R": R, "N": N, "d": d, "k": k, "calls": calls,
           "realized_slots": nnz,
           "isolated": [int(isolated_count(sw[r])) for r in range(R)],
           "differ_vs_separate": differ, "max_abs_err": max_err,
           "tol_f32": tol, "violations": bad}
    ms = {"batched": [], "separate": []}
    for name in ("batched", "separate", "separate", "batched"):
        fn = batched if name == "batched" else separate
        ms[name].append(cuda_ms(fn, iters=3, warmup=1))
        torch.cuda.empty_cache()
    rec["ms_in_turns"] = ms
    rec["ms"] = min(ms["batched"])
    rec["separate_ms"] = min(ms["separate"])
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    window(0, 0, min(d, 1 << 16))
    torch.cuda.synchronize()
    start.record()
    for r in range(R):
        for a in range(0, d, 1 << 16):
            window(r, a, min(a + (1 << 16), d))
    end.record()
    torch.cuda.synchronize()
    rec["plain_ms"] = start.elapsed_time(end)
    works = [sparse_work(N, d, k, 4, True, nnz[r], counts, rates,
                         noise_branches(N, d, cw, int(seeds[r])))
             for r in range(R)]
    t = {"bytes": sum(w["bytes"] for w in works) / HBM_BYTES_PER_S,
         "instructions": sum(w["lane_instructions"] for w in works)
         / (rates["sms"] * 128 * rates["sm_clock_hz"]),
         "fma": 2 * sum(w["fmas"] for w in works) / F32_FLOP_PER_S}
    bound = max(t.values())
    rec.update({"bytes_ms": 1e3 * t["bytes"],
                "instructions_ms": 1e3 * t["instructions"],
                "fma_ms": 1e3 * t["fma"], "bound_ms": 1e3 * bound,
                "bound_by": "bytes" if t["bytes"] == bound else "operations",
                "workspace_floor_ms": sum(w["workspace_floor_ms"]
                                          for w in works)})
    print(f"[fleet] sparse replicate axis {json.dumps(rec)}", flush=True)
    if differ or bad or calls != 1:
        fail(f"sparse replicate axis R={R} N={N}: {calls} wrapper counts, "
             f"{differ} elements differ from the separate launches, {bad} "
             f"beyond the plain twin's tolerance (max err {max_err:.3g})")
    return rec


def fleet_sparse_body(store, R: int, N: int):
    """A fleet sparse flat round body at full width (mesh_sparse, k =
    SPARSE_K) and its carry."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import trajectory as TJ
    from repro_torch.fleet import FleetEngine
    proto = sparse_proto(N, flat_buffer=True)
    fleet = FleetEngine(proto, R, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(R + N)
    wp = fleet.init_worker_params(gen, DWFL_PAPER)
    spec = X.FlatSpec(wp, lead_axes=2)
    flat = spec.flatten(wp)
    del wp
    body = TJ.make_round_body(DWFL_PAPER, proto, store, spec, "cuda",
                              fleet=fleet)
    return body, TJ.TrajCarry(gen, flat, fleet.init(gen))


def fleet_sparse_cli(store) -> dict:
    """The fleet's sparse CLI at full width (mesh_sparse, --replicates
    FLEET_SPARSE_R, --workers FLEET_SPARSE_N, --sparse-neighbors SPARSE_K,
    FLEET_SPARSE_STEPS steps) under its sync guard, the dp_mix counts set
    to 0 just before and read just after: one dp_mix_round_sparse call a
    round for all R and no dense dp_mix_round; every loss finite, the
    fleet's epsilon report over every round; its replicate-rounds/s and
    peak memory. Then two warm rounds of its round body under
    torch.profiler: one dp_mix_prep and one dp_mix_gather kernel a round,
    no dense route's kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import trajectory as TJ
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.launch import train
    predict("fleet_sparse_cli")
    R, N = FLEET_SPARSE_R, FLEET_SPARSE_N
    torch.cuda.reset_peak_memory_stats()
    ops.dp_mix_round_sparse.launches = ops.dp_mix_round.launches = 0
    res = train.run(["--arch", "dwfl-paper", "--flat-buffer",
                     "--channel-model", "dynamic", "--scenario",
                     SPARSE_SCENARIO, "--replicates", str(R), "--workers",
                     str(N), "--sparse-neighbors", str(SPARSE_K), "--steps",
                     str(FLEET_SPARSE_STEPS), "--device", "cuda"])
    sparse, dense = ops.dp_mix_round_sparse.launches, ops.dp_mix_round.launches
    rep, losses, rounds = res["epsilon_report"], res["losses"], res["rounds"]
    rec = {"scenario": SPARSE_SCENARIO, "replicates": R, "N": N,
           "k": SPARSE_K, "rounds": rounds, "seconds": res["seconds"],
           "rounds_per_s": rounds / res["seconds"],
           "replicate_rounds_per_s": R * rounds / res["seconds"],
           "sparse_launches": sparse, "dense_launches": dense,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "first_loss": losses[0].tolist(), "last_loss": losses[-1].tolist(),
           "eps_replicates": rep["replicates"], "eps_rounds": rep["rounds"],
           "eps_worst": rep["epsilon_worst"],
           "eps_total_mean": rep["epsilon_total_mean"]}
    finite = bool(torch.isfinite(losses).all()
                  and torch.isfinite(res["params"]).all()
                  and np_finite(rep["epsilon_per_round"]))
    del res
    torch.cuda.empty_cache()
    body, carry = fleet_sparse_body(store, R, N)
    carry, _ = TJ.run_chunk(body, carry, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        carry, _ = TJ.run_chunk(body, carry, 2)
        torch.cuda.synchronize()
    kernels = train_kernels(prof)
    rec["kernels_in_2_rounds"] = kernels
    del body, carry
    torch.cuda.empty_cache()
    print(f"[fleet] sparse cli {json.dumps(rec)}", flush=True)
    if (sparse != rounds or dense or rep["rounds"] != rounds
            or rep["replicates"] != R
            or tuple(losses.shape) != (rounds, R)):
        fail(f"fleet sparse cli: {sparse} sparse and {dense} dense dp_mix "
             f"calls, epsilon over {rep['rounds']} rounds of "
             f"{rep['replicates']} replicates, for {rounds} rounds of {R}")
    if kernels != {"dp_mix_prep": 2, "dp_mix_gather": 2}:
        fail(f"fleet sparse round: kernels in 2 rounds {kernels}")
    if not finite:
        fail("fleet sparse cli: non-finite losses, parameters or epsilons")
    return rec


def fleet_sparse_cpu_vs_cuda() -> float:
    """One reduced fleet sparse flat round (hidden 16, R = 2 networks of N
    = 16, mesh_sparse, k = 4) on the card against the same round on the
    CPU from the same replayed channels, lists, buffer, batch and seeds,
    within 1e-4 (1 + max|x|) (the gradients' products differ)."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.fleet import FleetEngine
    predict("fleet_sparse_cpu_vs_cuda")
    cfg = dataclasses.replace(DWFL_PAPER, d_model=16)
    R, N = 2, 16
    proto = dynamic_proto(N, SPARSE_SCENARIO, sparse_neighbors=4,
                          graph_fallback=True)
    fleet = FleetEngine(proto, R, device="cpu")
    gen = torch.Generator().manual_seed(7)
    st = fleet.init(gen)
    for _ in range(3):
        st, chans, _, Ws = fleet.round(gen, st)
    wp = fleet.init_worker_params(gen, cfg)
    spec = X.FlatSpec(wp, lead_axes=2)
    flat = spec.flatten(wp)
    batch = {"x": torch.randn((R, N, 8, 3072), generator=gen),
             "y": torch.randint(0, 10, (R, N, 8), generator=gen)}
    seeds = torch.tensor([99, -5], dtype=torch.int32)
    outs = {}
    for dev in ("cpu", "cuda"):
        step = P.make_fleet_flat_train_step(cfg, proto, spec, dev)
        out, _ = step(flat.to(dev), {k: v.to(dev) for k, v in batch.items()},
                      seeds.to(dev), chans.to(dev), Ws.to(dev))
        outs[dev] = out.cpu()
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    tol = 1e-4 * (1.0 + float(outs["cpu"].abs().max()))
    listening = int((Ws.off_degree() > 0).sum())
    print(f"[fleet] small sparse round cuda vs cpu: max_abs_err={err:.3g} "
          f"(tol {tol:.3g}; {listening} of {R * N} workers listening)",
          flush=True)
    if not math.isfinite(err) or err > tol or not listening:
        fail(f"fleet sparse round: cuda and cpu differ by {err:.3g} (tol "
             f"{tol:.3g}), {listening} workers listening")
    return err


def fleet_sparse_phase(counts: dict, rates: dict) -> dict:
    """The fleet's sparse round (ROADMAP A20): the sparse kernels'
    replicate axis at (R 4, N 512, 855,050), the fleet sparse CLI
    (counted), and a reduced round on the card against the CPU."""
    import torch
    kernel = check_sparse_raxis(FLEET_SPARSE_R, FLEET_SPARSE_N, PATH_D,
                                counts, rates)
    torch.cuda.empty_cache()
    cli = fleet_sparse_cli(paper_store(FLEET_SPARSE_N))
    fleet_sparse_cpu_vs_cuda()
    torch.cuda.empty_cache()
    return {"kernel": kernel, "cli": cli}


def telemetry_cli() -> dict:
    """The static and the iot_dense flat CLI at full width (51 rounds) with
    a run log (telemetry auto on) and an epsilon budget: a round event a
    round with every field, the report reading the directory back; then
    the CLI's rounds/s with telemetry on against off, warm, without evals,
    in turns (off, on, on, off), beside the reference's 5% ceiling."""
    import torch
    from repro_torch.launch import train
    from repro_torch.obs import report
    from repro_torch.obs.telemetry import TelemetrySpec
    predict("telemetry")
    runs = ROOT / "build" / "runs"
    rec = {}
    fields = TelemetrySpec().fields
    for name, extra in (("static", []),
                        ("dynamic", ["--channel-model", "dynamic",
                                     "--scenario", DYN_SCENARIO])):
        res = train.run(["--arch", "dwfl-paper", "--flat-buffer",
                         "--workers", str(PATH_N), "--steps", str(DYN_STEPS),
                         "--eval-every", str(DYN_STEPS // 2), "--runlog-dir",
                         str(runs), "--eps-budget", "20", "--device", "cuda",
                         *extra])
        summary = report.summarize_run(res["runlog_dir"])
        counts = summary["event_counts"]
        rows = res["telemetry"]
        rec[name] = {"rounds": res["rounds"],
                     "rounds_per_s": res["rounds"] / res["seconds"],
                     "event_counts": counts,
                     "telemetry_last": dict(zip(fields, rows[-1].tolist())),
                     "eps_composed": summary["epsilon"].get("eps_composed"),
                     "warnings": len(summary["warnings"])}
        if (counts.get("round") != res["rounds"] or not counts.get("epsilon")
                or set(summary["telemetry"]) != set(fields)
                or tuple(rows.shape) != (res["rounds"], len(fields))):
            fail(f"telemetry cli {name}: the run log holds {counts}, "
                 f"telemetry {tuple(rows.shape)}")
        finite = torch.isfinite(rows[:, [fields.index(f) for f in fields
                                         if f != "snr_db"]]).all()
        if not finite or report.main([str(res["runlog_dir"])]) != 0:
            fail(f"telemetry cli {name}: non-finite telemetry or an "
                 f"unreadable run directory")
    rate = {}
    for name, extra in (("static", []),
                        ("dynamic", ["--channel-model", "dynamic",
                                     "--scenario", DYN_SCENARIO])):
        rate[name] = {"off": [], "on": []}
        for t in ("off", "on", "on", "off"):
            res = train.run(["--arch", "dwfl-paper", "--flat-buffer",
                             "--workers", str(PATH_N), "--steps",
                             str(DYN_STEPS), "--eval-every", "0",
                             "--telemetry", t, "--device", "cuda", *extra])
            rate[name][t].append(res["rounds"] / res["seconds"])
        off, on = (sum(v) / 2 for v in (rate[name]["off"], rate[name]["on"]))
        rate[name]["overhead"] = off / on - 1.0
        rate[name]["within_ceiling"] = off / on - 1.0 <= TELEMETRY_CEILING
    rec["rounds_per_s_in_turns"] = rate
    print(f"[telemetry] {json.dumps(rec)}", flush=True)
    return rec


def sweep_phase() -> dict:
    """``python -m repro_torch.fleet.sweep`` as the README runs it, at 5
    steps a cell: 8 rows with the reference's keys, every number finite."""
    from repro_torch.fleet import sweep
    predict("sweep")
    path = ROOT / "build" / "sweep.json"
    t0 = time.perf_counter()
    out = sweep.main(["--scenarios", "iot_dense,vehicular", "--workers",
                      "8,16", "--epsilon", "0.5,1.0", "--replicates",
                      str(FLEET_R), "--steps", "5", "--json", str(path),
                      "--device", "cuda"])
    rows = json.loads(path.read_text())["rows"]
    rec = {"cells": len(rows), "seconds": time.perf_counter() - t0,
           "us_per_round": [r["us_per_round"] for r in rows],
           "acc_mean": [r["acc_mean"] for r in rows]}
    print(f"[sweep] {json.dumps(rec)}", flush=True)
    numbers = [v for r in rows for k, v in r.items()
               if isinstance(v, float)]
    if (len(rows) != 8 or any(set(r) != SWEEP_KEYS for r in rows)
            or not all(math.isfinite(v) for v in numbers)
            or len(out["rows"]) != 8):
        fail(f"sweep: {len(rows)} rows, keys {sorted(set(rows[0]) ^ SWEEP_KEYS) if rows else None}, "
             f"or non-finite numbers")
    return rec



# ---- the chunk executor: a K-round chunk as one CUDA graph (ChunkRunner) ----

# the paths the runner captures, in the order they are held bitwise: the
# static flat round (the main path; also with telemetry's chunk epilogue
# in the graph), the worker-tree round with use_pallas (B2), the dynamic
# flat and tree rounds (the simulator's round in the graph), the fleet's
# dense flat round at R = FLEET_R (B1's replicate axis) and the sparse
# round at the worker-scale shape (B1-sparse)
GRAPH_PATHS = ("flat", "flat telemetry", "tree", "dynamic flat",
               "dynamic tree", "fleet", "sparse")
# the repo kernels each path launches at least once a round
GRAPH_KERNELS = {"flat": ("dp_mix_columns",),
                 "flat telemetry": ("dp_mix_columns",),
                 "tree": ("dp_perturb_kernel",),
                 "dynamic flat": ("dp_mix_columns",),
                 "dynamic tree": ("dp_perturb_kernel",),
                 "fleet": ("dp_mix_columns",),
                 "sparse": ("dp_mix_prep", "dp_mix_gather"),
                 "lm tree": ("dp_perturb_kernel",),
                 "lm flat": ("dp_mix_columns",),
                 "mesh model": ("dp_mix_columns",),
                 "mesh model telemetry": ("dp_mix_columns",),
                 "mesh fleet": ("dp_mix_columns",)}
# rounds a chunk and chunks a timed turn; the sparse round at N = 2048
# takes GRAPH_SPARSE_K rounds a chunk (88 ms a round)
GRAPH_K, GRAPH_SPARSE_K, GRAPH_TURN_CHUNKS = 4, 2, 5
GRAPH_TURN_K = 10
# the static flat CLI at its defaults (200 steps, an eval every 50 rounds)
GRAPH_CLI_STEPS = 200


def graph_path(path: str, device: str = "cuda", N: int = PATH_N,
               hidden: int = 0, dataset: int = 20000, batch: int = 32,
               R: int = FLEET_R, k: int = SPARSE_K):
    """(body, carry) of one of GRAPH_PATHS as the CLI builds it: dwfl-paper
    (at ``hidden`` if given, else full width) on N workers, the CLI's
    store, a generator seeded 0; the tree rounds with use_pallas,
    the dynamic flat round on iot_dense and the tree round on
    drone_sparse, the fleet on vehicular, the sparse round on mesh_sparse
    with a degree cap of ``k``; with telemetry every field and the
    epsilon moments in the carry."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    from repro_torch.data import (ClassificationStore, classification_dataset,
                                  dirichlet_partition)
    from repro_torch.fleet import FleetEngine
    from repro_torch.obs import telemetry as tele
    if path not in GRAPH_PATHS:
        raise ValueError(f"no graph path {path!r}; have {GRAPH_PATHS}")
    cfg = (dataclasses.replace(DWFL_PAPER, d_model=hidden) if hidden
           else DWFL_PAPER)
    tree = path in ("tree", "dynamic tree")
    if path == "dynamic flat":
        proto = dynamic_proto(N)
    elif path == "dynamic tree":
        proto = dynamic_proto(N, DYN_TREE_SCENARIO, use_pallas=True)
    elif path == "fleet":
        proto = dynamic_proto(N, FLEET_SCENARIO)
    elif path == "sparse":
        proto = dynamic_proto(N, SPARSE_SCENARIO, sparse_neighbors=k)
    else:
        proto = P.ProtocolConfig(n_workers=N, gamma=0.01, eta=0.4,
                                 target_epsilon=1.0, use_pallas=tree)
    x, y = classification_dataset(dataset, seed=0)
    store = ClassificationStore.build(
        x, y, dirichlet_partition(y, N, alpha=0.5, seed=0), batch, device)
    gen = torch.Generator(device=device).manual_seed(0)
    sim = fleet = net = None
    if path == "fleet":
        fleet = FleetEngine(proto, R, device=device)
        wp = fleet.init_worker_params(gen, cfg)
    else:
        wp = P.init_worker_params(gen, cfg, N, device)
        if proto.channel_model == "dynamic":
            sim = proto.simulator(device)
    spec = None if tree else X.FlatSpec(wp, lead_axes=2 if fleet else 1)
    telemetry = tele.TelemetrySpec() if path == "flat telemetry" else None
    body = TJ.make_round_body(cfg, proto, store, spec, device, sim=sim,
                              fleet=fleet, telemetry=telemetry)
    if fleet is not None:
        net = fleet.init(gen)
    elif sim is not None:
        net = sim.init(gen)
    eps = tele.init_eps_moments(device=device) if telemetry else None
    return body, TJ.TrajCarry(gen, wp if tree else spec.flatten(wp), net,
                              eps)


def same_bits(a, b) -> bool:
    """Two tensors of the same shape and dtype with the same bits (NaN,
    -0.0 and all)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.contiguous().view(view[t.element_size()]) for t in (a, b))
    return bool(torch.equal(a, b))


def chunk_record(carry, outs, device=None) -> dict:
    """What the graph and the eager chunks are held on, copied (to
    ``device`` if given): the parameters, the generator's state, the
    network state, the epsilon moments and each chunk's outputs (metrics,
    telemetry, channels, Ws), by name."""
    from repro_torch.core import trajectory as TJ
    copy = ((lambda t: t.clone()) if device is None
            else (lambda t: t.to(device, copy=True)))
    rec = {"generator": carry.generator.get_state()}
    for name, tree in (("params", carry.params), ("net", carry.net),
                       ("eps", carry.eps)):
        for i, t in enumerate(TJ.tree_tensors(tree)):
            rec[f"{name}/{i}"] = copy(t)
    for c, out in enumerate(outs):
        for i, t in enumerate(TJ.tree_tensors(out)):
            rec[f"chunk {c}/{i}"] = copy(t)
    return rec


@contextlib.contextmanager
def eager_chunks():
    """``ChunkRunner.run`` as ``run_chunk`` (its eager program) inside the
    block: the executor the CLI had before the runner, for timing the CLI
    without the graph."""
    from repro_torch.core import trajectory as TJ
    run = TJ.ChunkRunner.run
    TJ.ChunkRunner.run = lambda self, carry, k: self.program(k)(carry)
    try:
        yield
    finally:
        TJ.ChunkRunner.run = run


def graph_turns(path: str, K: int = GRAPH_TURN_K,
                chunks: int = GRAPH_TURN_CHUNKS, build=None, **kw) -> dict:
    """Rounds/s of one of GRAPH_PATHS through the runner and eagerly, in
    turns (graph, eager, eager, graph), host clock around ``chunks``
    chunks of K rounds ending in a synchronize. A graph turn is a new
    runner: its eager chunk and its capture untimed (an eager turn's
    first chunk too). The last turn's runner and its pool are freed
    before the next turn (``reserved_before``: the GiB still reserved
    then); peak device memory (allocated and reserved) of each turn, and
    past its first chunk (``peak_past_first_gib``: a graph turn's
    capture and replays without the runner's eager first chunk).
    ``build``: the path's (body, carry) maker (``graph_path`` if None)."""
    import gc
    import torch
    from repro_torch.core import trajectory as TJ
    body, carry = (build or graph_path)(path, **kw)
    rate = {"graph": [], "eager": []}
    peak = {"graph": [], "eager": []}
    past = {"graph": [], "eager": []}
    before = []
    gib = lambda: (torch.cuda.max_memory_allocated() / 2**30,
                   torch.cuda.max_memory_reserved() / 2**30)
    for turn in ("graph", "eager", "eager", "graph"):
        gc.collect()
        torch.cuda.empty_cache()
        before.append(torch.cuda.memory_reserved() / 2**30)
        run = (TJ.ChunkRunner(body).run if turn == "graph" else
               (lambda c, n: TJ.run_chunk(body, c, n)))
        torch.cuda.reset_peak_memory_stats()
        for n in range(2 if turn == "graph" else 1):
            carry, _ = run(carry, K)
            if n == 0:
                torch.cuda.synchronize()
                first = gib()
                torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(chunks):
            carry, _ = run(carry, K)
        torch.cuda.synchronize()
        rate[turn].append(chunks * K / (time.perf_counter() - t0))
        past[turn].append(gib())
        peak[turn].append(tuple(max(a, b) for a, b in zip(first,
                                                          past[turn][-1])))
        del run
    del carry, body
    torch.cuda.empty_cache()
    return {"path": path, "rounds_a_chunk": K, "chunks": chunks,
            "rounds_per_s": rate, "peak_gib": peak,
            "peak_past_first_gib": past, "reserved_before_gib": before,
            "speedup": [g / e for g, e in zip(rate["graph"],
                                              reversed(rate["eager"]))]}


def graph_cli_turns(steps: int = GRAPH_CLI_STEPS) -> dict:
    """The static flat CLI at its defaults (an eval every 50 rounds:
    chunks of 1, then 50), with the graph and without it (``eager_chunks``),
    in turns; its rounds/s as it measures them, and the runner's captures
    counted from the CLI's run log events."""
    from repro_torch.launch import train
    rate = {"graph": [], "eager": []}
    for turn in ("graph", "eager", "eager", "graph"):
        argv = ["--arch", "dwfl-paper", "--flat-buffer", "--workers",
                str(PATH_N), "--steps", str(steps), "--device", "cuda"]
        if turn == "graph":
            res = train.run(argv)
        else:
            with eager_chunks():
                res = train.run(argv)
        rate[turn].append(res["rounds"] / res["seconds"])
    return {"rounds": steps + 1, "rounds_per_s": rate,
            "speedup": [g / e for g, e in zip(rate["graph"],
                                              reversed(rate["eager"]))]}


def graph_phase() -> dict:
    """Each of GRAPH_PATHS through ChunkRunner bitwise the same chunks
    through run_chunk (parameters, generator state, network state,
    epsilon moments, every output; ``graph_held``, two eager runs also
    held to each other), one capture per length, every kernel launched
    as often a replay as an eager chunk launches it; then
    rounds/s with and without the graph in turns: the static flat CLI,
    the static flat round with and without telemetry, the dynamic flat
    round (iot_dense), the tree round, the fleet at R = FLEET_R and the
    sparse round at N = SPARSE_N with its peak memory; then the LM
    rounds (``graph_lm``)."""
    import torch
    print(f"[graph] torch {torch.__version__}: CUDAGraph."
          f"register_generator_state "
          f"{hasattr(torch.cuda.CUDAGraph, 'register_generator_state')}",
          flush=True)
    recs = {}
    for path in GRAPH_PATHS:
        kw = {"N": SPARSE_N} if path == "sparse" else {}
        rec = graph_held(path, graph_path,
                         GRAPH_SPARSE_K if path == "sparse" else GRAPH_K,
                         eager_runs=1, **kw)
        print(f"[graph] bitwise {json.dumps(rec)}", flush=True)
        check_held(rec, GRAPH_KERNELS[path])
        recs[path] = rec
    turns = {"static flat CLI": graph_cli_turns()}
    print(f"[graph] turns {json.dumps(turns['static flat CLI'])}", flush=True)
    for path, kw in (("flat", {}), ("flat telemetry", {}),
                     ("dynamic flat", {}), ("tree", {}), ("fleet", {}),
                     ("sparse", dict(K=GRAPH_SPARSE_K, chunks=2,
                                     N=SPARSE_N))):
        turns[path] = graph_turns(path, **kw)
        print(f"[graph] turns {json.dumps(turns[path])}", flush=True)
    recs.update(graph_lm(turns))
    return {"bitwise": recs, "turns": turns}


def graph_lm(turns: dict) -> dict:
    """The LM rounds through ChunkRunner (GRAPH_LM_PATHS): each held to
    two chunks through run_chunk (``graph_held``: bitwise, or within the
    eager path's own spread), one capture, B2 (tree) or B1 (flat) once a
    round in a replay's trace and an eager chunk's; then ms a round with
    and without the graph in turns, with each turn's peak memory (into
    ``turns``)."""
    predict("graph_lm")
    recs = {}
    for path in GRAPH_LM_PATHS:
        kw = {"layers": LM_FLAT_LAYERS} if path == "lm flat" else {}
        # at full depth on the host, and once eagerly: two eager runs of
        # its chunks were bitwise each other (PERF 6)
        tree = path == "lm tree"
        rec = graph_held(path, lm_graph_path, GRAPH_LM_K,
                         eager_runs=1 if tree else 2,
                         keep="cpu" if tree else None, **kw)
        print(f"[graph] held {json.dumps(rec)}", flush=True)
        check_held(rec, GRAPH_KERNELS[path])
        recs[path] = rec
        turns[path] = graph_turns(path, GRAPH_LM_K, GRAPH_LM_TURN_CHUNKS,
                                  build=lm_graph_path, **kw)
        print(f"[graph] turns {json.dumps(turns[path])}", flush=True)
    return recs


def graph_mesh(shard_mesh, fleet_mesh) -> dict:
    """The process-group bodies through ChunkRunner on one-rank NCCL
    meshes (GRAPH_MESH_PATHS; the model-axis round on ``shard_mesh``, the
    fleet on ``fleet_mesh``): each held to run_chunk as ``graph_lm``
    holds the LM rounds, B1 once a round (its window's launch, the
    fleet's replicate axis), then ms a round with and without the graph
    in turns."""
    predict("graph_mesh")
    recs, turns = {}, {}
    for path in GRAPH_MESH_PATHS:
        mesh = fleet_mesh if path == "mesh fleet" else shard_mesh
        build = functools.partial(mesh_graph_path, mesh=mesh)
        rec = graph_held(path, build, GRAPH_K)
        print(f"[graph] held {json.dumps(rec)}", flush=True)
        check_held(rec, GRAPH_KERNELS[path])
        recs[path] = rec
        turns[path] = graph_turns(path, build=build)
        print(f"[graph] turns {json.dumps(turns[path])}", flush=True)
    return {"held": recs, "turns": turns}


# ---- the chunk executor on LM and process-group mesh bodies (A7b) ----------

# the LM rounds ChunkRunner captures: olmo-1b's tree round at full depth on
# LM_TREE_N workers with use_pallas (B2) and its flat round at full width
# on LM_FLAT_LAYERS of 16 layers on LM_FLAT_N (B1), the shapes of
# lm_tree_phase and lm_flat_phase; GRAPH_LM_K rounds a chunk,
# GRAPH_LM_TURN_CHUNKS chunks a timed turn
GRAPH_LM_PATHS = ("lm tree", "lm flat")
GRAPH_LM_K, GRAPH_LM_TURN_CHUNKS = 2, 2
# the process-group bodies it captures on a one-rank NCCL group: the
# model-axis round (dwfl-paper on iot_dense at (10, 855,050), one window)
# without and with telemetry (every field and the epsilon moments), and
# the fleet (vehicular, R = FLEET_R) on a (replicas 1, model 1) mesh
GRAPH_MESH_PATHS = ("mesh model", "mesh model telemetry", "mesh fleet")


def lm_graph_path(path: str, device: str = "cuda", arch: str = LM_ARCH,
                  reduced: bool = False, N: int = 0, layers: int = 0,
                  batch: int = LM_BATCH, seq: int = LM_SEQ,
                  remat: bool = False):
    """(body, carry) of an LM round as the CLI builds it: ``arch`` (its
    reduced() config with ``reduced``, ``layers`` of its layers if given),
    the CLI's token data (lm_dataset(N 200,000) in N slices, windows of
    ``seq``, ``batch`` a worker), a generator seeded 0. "lm tree": the
    worker-tree round with use_pallas (B2) on N workers (LM_TREE_N if 0);
    "lm flat": the flat round (B1) on N (LM_FLAT_N if 0); with ``remat``
    the flat round as ``--model-shards 2 --remat`` runs it: two column
    windows logically on one device, the forward recomputed in the
    backward (torch.utils.checkpoint)."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    from repro_torch.data import LMStore, lm_dataset
    if path not in GRAPH_LM_PATHS:
        raise ValueError(f"no LM graph path {path!r}; have {GRAPH_LM_PATHS}")
    tree = path == "lm tree"
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    N = N or (LM_TREE_N if tree else LM_FLAT_N)
    proto = P.ProtocolConfig(scheme="dwfl", n_workers=N, gamma=0.01, eta=0.4,
                             target_epsilon=1.0, use_pallas=tree)
    store = LMStore.build(lm_dataset(N * 200_000, cfg.vocab_size, seed=0), N,
                          batch, seq, device)
    gen = torch.Generator(device=device).manual_seed(0)
    wp = P.init_worker_params(gen, cfg, N, device)
    if tree:
        body = TJ.make_round_body(cfg, proto, store, device=device)
        return body, TJ.TrajCarry(gen, wp)
    spec = X.make_flat_spec(wp, n_shards=2 if remat else None)
    flat = spec.flatten(wp)
    del wp
    body = TJ.make_round_body(cfg, proto, store, spec, device, remat=remat)
    return body, TJ.TrajCarry(gen, flat)


def mesh_graph_path(path: str, mesh, device: str = "cuda", N: int = PATH_N,
                    hidden: int = 0, R: int = FLEET_R, dataset: int = 20000,
                    batch: int = 32):
    """(body, carry) of one of GRAPH_MESH_PATHS over ``mesh`` as the CLI
    builds it under torchrun with ``--flat-buffer --model-shards S``: a
    ("model",) mesh for the model-axis round (iot_dense), a ("replicas",
    "model") one for the fleet (vehicular, R replicates); dwfl-paper at
    ``hidden`` if given, else full width, on N workers, the layout's
    window of this rank, a generator seeded 0; with telemetry every field
    and the epsilon moments in the carry."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    from repro_torch.data import (ClassificationStore, classification_dataset,
                                  dirichlet_partition)
    from repro_torch.fleet import FleetEngine
    from repro_torch.obs import telemetry as tele
    from repro_torch.shard import ShardLayout, local_window
    if path not in GRAPH_MESH_PATHS:
        raise ValueError(f"no mesh graph path {path!r}; have "
                         f"{GRAPH_MESH_PATHS}")
    cfg = (dataclasses.replace(DWFL_PAPER, d_model=hidden) if hidden
           else DWFL_PAPER)
    fleet_path = path == "mesh fleet"
    proto = dynamic_proto(N, FLEET_SCENARIO if fleet_path else DYN_SCENARIO,
                          flat_buffer=True)
    x, y = classification_dataset(dataset, seed=0)
    store = ClassificationStore.build(
        x, y, dirichlet_partition(y, N, alpha=0.5, seed=0), batch, device)
    gen = torch.Generator(device=device).manual_seed(0)
    S = mesh.size(mesh.mesh_dim_names.index("model"))
    sim = fleet = None
    if fleet_path:
        fleet = FleetEngine(proto, R, device=device)
        wp = fleet.init_worker_params(gen, cfg)
    else:
        wp = P.init_worker_params(gen, cfg, N, device)
        sim = proto.simulator(device)
    lead = 2 if fleet_path else 1
    d = X.FlatSpec(wp, lead_axes=lead).d
    spec = X.make_flat_spec(wp, lead_axes=lead, layout=ShardLayout(d, S))
    flat = local_window(spec.flatten(wp), spec, mesh)
    del wp
    if fleet_path:
        flat = flat[fleet.replicate_slice(mesh)]
    telemetry = (tele.TelemetrySpec() if path == "mesh model telemetry"
                 else None)
    body = TJ.make_round_body(cfg, proto, store, spec, device, sim=sim,
                              fleet=fleet, telemetry=telemetry,
                              shard_mesh=mesh)
    net = fleet.init(gen) if fleet_path else sim.init(gen)
    eps = tele.init_eps_moments(device=device) if telemetry else None
    return body, TJ.TrajCarry(gen, flat, net, eps)


def carry_to(carry, device: str):
    """A copy of ``carry`` on ``device``: its tensors copied there; on the
    host its generator kept as a copy of its state (a CUDA generator's
    state has no CPU generator to hold it), on the card a new generator
    in that state."""
    import torch
    from repro_torch.core import trajectory as TJ
    state = carry.generator
    state = (state.clone() if torch.is_tensor(state)
             else state.get_state())
    gen = state
    if device != "cpu":
        gen = torch.Generator(device=device)
        gen.set_state(state)
    return TJ.TrajCarry(gen, *TJ._map(lambda t: t.to(device, copy=True),
                                      TJ._state(carry)))


def bits_spread(got: dict, want: dict) -> tuple:
    """(the leaves of ``want`` whose bits differ in ``got``, the largest
    |got - want| over the floating leaves)."""
    differ = sorted(n for n in want if n not in got or not same_bits(
        got[n], want[n]))
    differ += sorted(n for n in got if n not in want)
    spread = 0.0
    for n in differ:
        if n in got and n in want and want[n].is_floating_point():
            spread = max(spread, float((got[n].double()
                                        - want[n].double()).abs().max()))
    return differ, spread


def graph_held(path: str, build, K: int, eager_runs: int = 2,
               keep=None, **kw) -> dict:
    """One of GRAPH_PATHS, GRAPH_LM_PATHS or GRAPH_MESH_PATHS
    (``build(path, **kw)``: ``graph_path``, ``lm_graph_path``,
    ``mesh_graph_path``) through ``ChunkRunner`` and through
    ``run_chunk``, the copies and records kept on ``keep`` ("cpu": the
    host, for olmo-1b's full-depth trees, which would not fit the card
    twice beside a round; None: the card): the runner's first chunk
    (eager, a real chunk), then two chunks of K rounds (the capture's
    replay, then a replay); the same two chunks eagerly from a copy of
    the carry, ``eager_runs`` times (two: the eager path against itself,
    its spread 0 where it is bitwise). A replay's kernels are read from
    the device trace of a repeatable replay (``traced_seen``: before
    each session the runner's buffers and generator are put back to the
    copy of the carry its replays started from; a runner without
    donation, fed a device copy, would not fit beside olmo-1b's
    full-depth pool), an eager chunk's likewise; the wrappers' launches
    in one eager chunk (counts set to 0 just before, read just after).
    Returns the leaves where the graph's bits differ from the first eager
    run's and by how much, the eager spread, the captures a length, the
    kernels of each trace and the peak memory (allocated, reserved GiB)
    of the graph's chunks and of the eager ones."""
    import torch
    from repro_torch.core import trajectory as TJ
    wrappers = kernel_wrappers()
    body, carry = build(path, **kw)
    round_graph = getattr(body, "round_graph", False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runner = TJ.ChunkRunner(body)
    carry, _ = runner.run(carry, K)
    twin = carry_to(carry, keep or "cuda")
    carry, out1 = runner.run(carry, K)
    carry, out2 = runner.run(carry, K)
    got = chunk_record(carry, (out1, out2), keep)
    del out1, out2

    start = (twin.generator if keep == "cpu"
             else twin.generator.get_state())

    def reset():
        # the runner's buffers (the carry it returned) put back to the
        # copy of the carry its replays started from
        for s, t in zip(TJ.tree_tensors(TJ._state(carry)),
                        TJ.tree_tensors(TJ._state(twin))):
            s.copy_(t)
        carry.generator.set_state(start)

    replay_k, replay_ops, replay_sessions = traced_seen(
        lambda: runner.run(carry, K), reset=reset)
    captures = runner.trace_counts()
    peak = {"graph": (torch.cuda.max_memory_allocated() / 2 ** 30,
                      torch.cuda.max_memory_reserved() / 2 ** 30)}
    del carry, runner
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the eager chunk's trace first, from the copy the first eager run
    # then takes over (no second copy on the card beside its round)
    held = [carry_to(twin, "cuda")]
    state = held[0].generator.get_state()
    eager_k, eager_ops, eager_sessions = traced_seen(
        lambda: TJ.run_chunk(body, held[0], K),
        reset=lambda: held[0].generator.set_state(state))
    eager = []
    for n in range(eager_runs):
        c = held.pop() if held else carry_to(twin, "cuda")
        c.generator.set_state(state)
        c, o1 = TJ.run_chunk(body, c, K)
        if n == 0:
            zero_counts(wrappers)
        c, o2 = TJ.run_chunk(body, c, K)
        if n == 0:
            counted = {w.__name__: w.launches for w in wrappers
                       if w.launches}
        eager.append(chunk_record(c, (o1, o2), keep))
        del c, o1, o2
    peak["eager"] = (torch.cuda.max_memory_allocated() / 2 ** 30,
                     torch.cuda.max_memory_reserved() / 2 ** 30)
    del body, twin
    torch.cuda.empty_cache()
    eager_differ, eager_spread = (bits_spread(eager[1], eager[0])
                                  if eager_runs > 1 else (None, None))
    differ, spread = bits_spread(got, eager[0])
    return {"path": path, "rounds": K, "leaves": len(eager[0]),
            "captured_rounds": 1 if round_graph else K,
            "differ": differ, "max_abs_diff": spread,
            "eager_runs": eager_runs, "eager_differ": eager_differ,
            "eager_spread": eager_spread,
            "captures": captures, "kernels_replay": replay_k,
            "replay_ops": replay_ops, "replay_sessions": replay_sessions,
            "kernels_eager": eager_k, "eager_ops": eager_ops,
            "eager_sessions": eager_sessions, "launches_eager": counted,
            "peak_gib": peak}


# the kernels a wrapper's count stands for, on the paths graph_held runs
# (dp_mix at N <= 50 takes the column route)
WRAPPER_KERNELS = {"dp_mix_round": ("dp_mix_columns",),
                   "dp_mix_round_sparse": ("dp_mix_prep", "dp_mix_gather"),
                   "sgd_update_leaves": ("dp_perturb_kernel",),
                   "dp_mix_prep_rows": ("dp_mix_prep",),
                   "dp_mix_gather_rows": ("dp_mix_gather",)}


def check_held(rec: dict, kernels: tuple) -> None:
    """``graph_held``'s record: the graph bitwise the eager chunks, or,
    where two eager runs differ from each other, within their spread; one
    capture (of the chunk's length, or of one round for a ``round_graph``
    body); the repo kernels in a replay's trace, each of ``kernels`` at
    least once a round, as many as the eager chunk's wrappers launched
    (an eager trace's count is printed beside them: at ~20,000 device
    operations a session, one dropped a kernel once)."""
    path, K = rec["path"], rec["rounds"]
    if rec["eager_differ"]:
        print(f"[graph] {path}: two eager runs differ in "
              f"{len(rec['eager_differ'])} leaves, by up to "
              f"{rec['eager_spread']:.3g}; the graph is held to that "
              f"spread", flush=True)
        if rec["max_abs_diff"] > rec["eager_spread"]:
            fail(f"graph {path}: the graph's chunks differ from the eager "
                 f"chunks' by {rec['max_abs_diff']:.3g}, past the eager "
                 f"spread {rec['eager_spread']:.3g}")
    elif rec["differ"]:
        fail(f"graph {path}: the graph's chunks differ from the eager "
             f"chunks' in {rec['differ']}")
    if rec["captures"] != {rec["captured_rounds"]: 1}:
        fail(f"graph {path}: captures {rec['captures']}, expected one of "
             f"{rec['captured_rounds']} rounds")
    if not rec["replay_ops"]:
        fail(f"graph {path}: the profiler saw no device operation of a "
             f"replay in {rec['replay_sessions']} sessions")
    launched = {}
    for w, n in rec["launches_eager"].items():
        for k in WRAPPER_KERNELS[w]:
            launched[k] = launched.get(k, 0) + n
    if (rec["kernels_replay"] != launched
            or any(launched.get(k, 0) < K for k in kernels)):
        fail(f"graph {path}: kernels in a replay's trace "
             f"{rec['kernels_replay']}, launched by an eager chunk "
             f"{launched}, expected {kernels} at least once a round")
    if rec["kernels_eager"] != rec["kernels_replay"]:
        print(f"[graph] {path}: an eager chunk's trace held "
              f"{rec['kernels_eager']}", flush=True)


# ---- phase 11: the launch tooling and the static checks (A16, A17) ---------

TOOLING_HIDDEN = 256       # dwfl-paper's width for the analysis programs
SERVE_WAVES, SERVE_B, SERVE_S, SERVE_G = 2, 4, 48, 24   # the example's CLI
DRYRUN_PAIRS = 33


def tooling_analysis() -> dict:
    """(a) repro_torch.analysis on the card: every program one card can
    build (the two-rank mesh program needs two ranks), at dwfl-paper's
    width, two chunks of three rounds each under the sync guard; 0 ERROR
    findings, dp_mix (B1) or its sparse round (B1-sparse) launched once a
    round (the wrappers' counts, zeroed before each program), and the
    counter ranges the key check saw. Then the source lint."""
    import torch
    from repro_torch import analysis as A
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.analysis.keys import (collect_draws,
                                          collect_stream_draws,
                                          counter_ranges)
    from repro_torch.kernels.dp_mix import ops
    predict("tooling_analysis")
    recs, errors = {}, []
    for name in A.available_programs():
        ops.dp_mix_round.launches = ops.dp_mix_round_sparse.launches = 0
        t0 = time.perf_counter()
        prog, = A.build_programs([name], hidden=TOOLING_HIDDEN, device="cuda")
        run = A.run_program(prog)
        torch.cuda.synchronize()
        findings = A.analyze_run(run)
        rounds = sum(len(c.round_index) for c in run.chunks)
        kernel = ("dp_mix_round_sparse" if prog.sparse else "dp_mix_round")
        want = {kernel: rounds} if prog.flat else {}
        got = {k: v for k, v in (
            ("dp_mix_round", ops.dp_mix_round.launches),
            ("dp_mix_round_sparse", ops.dp_mix_round_sparse.launches)) if v}
        ranges = counter_ranges(collect_draws(run))
        errs = [str(f) for f in findings if f.severity == A.Severity.ERROR]
        rec = {"seconds": time.perf_counter() - t0, "rounds": rounds,
               "launches": got, "expected": want,
               "errors": len(errs), "findings": len(findings),
               "generator_draws": len(collect_stream_draws(run)),
               "counter_ranges": [(r["seed"], r["first"], r["last"])
                                  for r in ranges]}
        print(f"[tooling] analysis {name}: {json.dumps(rec)}", flush=True)
        if got != want:
            fail(f"analysis {name}: launches {got}, expected {want}")
        errors += errs
        recs[name] = rec
        del run, prog
        torch.cuda.empty_cache()
    if errors:
        fail(f"analysis on the card: {len(errors)} ERROR findings: "
             f"{errors[:4]}")
    if analysis_main(["--source-only", "-q"]) != 0:
        fail("analysis: the source lint found an ERROR")
    return recs


def tooling_dryrun() -> dict:
    """(b) python -m repro_torch.launch.dryrun over every pair the skip
    table leaves, on both meshes, in one process a core but one (at most
    7); every pair OK and its time."""
    import os
    import signal
    predict("tooling_dryrun")
    jobs = max(1, min(7, (os.cpu_count() or 2) - 1))
    out_dir = ROOT / "build" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--both-meshes",
         "--jobs", str(jobs), "--out", str(out_dir)], cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail("dry run: over 900 s")
    seconds = time.perf_counter() - t0
    lines = out.splitlines()
    for line in lines:
        if line.startswith(("OK", "FAIL", "SKIP")) or " ok, " in line:
            print(f"[tooling] dryrun {line}", flush=True)
    ok = [l for l in lines if l.startswith("OK")]
    bad = [l for l in lines if l.startswith("FAIL")]
    rec = {"jobs": jobs, "seconds": seconds, "ok": len(ok),
           "failures": len(bad), "rc": proc.returncode}
    print(f"[tooling] dryrun: {json.dumps(rec)}", flush=True)
    if proc.returncode != 0 or bad or len(ok) != 2 * DRYRUN_PAIRS:
        fail(f"dry run: rc {proc.returncode}, {len(ok)} OK, {len(bad)} "
             f"failures; {err[-2000:]}")
    return rec


def _paper_flat_round(device: str):
    """dwfl-paper's static flat round at N = 10, batch 32 (the main
    path's), on ``device``: (body, carry, None)."""
    import torch
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    from repro_torch.data import (ClassificationStore, classification_dataset,
                                  dirichlet_partition)
    x, y = classification_dataset(20000, seed=0)
    store = ClassificationStore.build(
        x, y, dirichlet_partition(y, PATH_N, alpha=0.5, seed=0), 32, device)
    proto = P.ProtocolConfig(n_workers=PATH_N, gamma=0.01, eta=0.4,
                             target_epsilon=1.0)
    gen = torch.Generator(device="cpu" if device == "meta" else device)
    gen.manual_seed(0)
    wp = P.init_worker_params(gen, DWFL_PAPER, PATH_N, device)
    spec = X.FlatSpec(wp)
    body = TJ.make_round_body(DWFL_PAPER, proto, store, spec, device)
    return body, TJ.TrajCarry(gen, spec.flatten(wp)), None


def _olmo_tree_round(device: str):
    """olmo-1b's tree round at full depth, N = 2, batch 4 x 128 a worker,
    with use_pallas (phase 10's), on ``device``: (body, carry, the bytes
    the card allocated for the worker parameters, or None)."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    from repro_torch.data import LMStore, lm_dataset
    cfg = get_arch(LM_ARCH)
    proto = P.ProtocolConfig(scheme="dwfl", n_workers=LM_TREE_N, gamma=0.01,
                             eta=0.4, target_epsilon=1.0, use_pallas=True)
    store = LMStore.build(lm_dataset(LM_TREE_N * 200_000, cfg.vocab_size,
                                     seed=0), LM_TREE_N, LM_BATCH, LM_SEQ,
                          device)
    gen = torch.Generator(device="cpu" if device == "meta" else device)
    gen.manual_seed(0)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
    wp = P.init_worker_params(gen, cfg, LM_TREE_N, device)
    if cuda:
        torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - base if cuda else None
    body = TJ.make_round_body(cfg, proto, store, device=device)
    return body, TJ.TrajCarry(gen, wp), allocated


def _counted_round(body, carry):
    """One round under a recorder: (carry', Cost, recorder's peak)."""
    from repro_torch.utils.trace import Recorder
    with Recorder(keep_ops=False) as rec:
        rec.track(carry.params)
        carry, _ = body(carry)
    return carry, rec.cost, rec.peak_bytes


def _turns_ms(body, carry, rounds: int, turns: int = 3):
    """ms a round in ``turns`` turns of ``rounds`` rounds each (host clock
    around rounds ending in a synchronize)."""
    import torch
    ms = []
    for _ in range(turns):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            carry, _ = body(carry)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / rounds)
    return carry, ms


def _round_bytes(tree) -> tuple:
    """(bytes, bytes with each tensor rounded up to the caching
    allocator's 512-byte blocks) of a tree's tensors."""
    from repro_torch.core.exchange import tree_flatten
    ts = [t for t in tree_flatten(tree)[0] if hasattr(t, "untyped_storage")]
    raw = sum(t.untyped_storage().nbytes() for t in ts)
    return raw, sum(-(-t.untyped_storage().nbytes() // 512) * 512 for t in ts)


def tooling_rounds() -> dict:
    """(c) and (d): dwfl-paper's static flat round and olmo-1b's tree round
    counted on the meta device and on the card, one warm round each:
    their op_cost equal, FLOPs and bytes exactly; each round's roofline
    bound beside its ms in turns (the first whole-round share of the
    roofline: a reading, not a limit). olmo-1b's argument bytes on meta
    against the card's allocated bytes for them, and the recorders' peaks
    beside torch.cuda.max_memory_allocated."""
    import torch
    from repro_torch.utils import roofline as rl
    predict("tooling_rounds")
    recs = {}
    for name, build, rounds in (("dwfl-paper flat, N = 10", _paper_flat_round,
                                 20),
                                (f"olmo-1b tree, full depth, N = {LM_TREE_N}",
                                 _olmo_tree_round, 2)):
        torch.cuda.empty_cache()
        body, carry, _ = build("meta")
        args_meta = _round_bytes(carry.params)
        carry, _ = body(carry)
        carry, meta_cost, meta_peak = _counted_round(body, carry)
        del body, carry
        body, carry, args_card = build("cuda")
        carry, _ = body(carry)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        carry, card_cost, card_peak = _counted_round(body, carry)
        torch.cuda.synchronize()
        max_alloc = torch.cuda.max_memory_allocated()
        carry, ms = _turns_ms(body, carry, rounds)
        roof = rl.from_cost(name, card_cost, peak="f32")
        same = meta_cost.as_dict() == card_cost.as_dict()
        rec = {"op_cost_meta": meta_cost.as_dict(),
               "op_cost_card": card_cost.as_dict(), "equal": same,
               "bound_ms": 1e3 * roof.step_time_s, "dominant": roof.dominant,
               "compute_ms": 1e3 * roof.compute_s,
               "memory_ms": 1e3 * roof.memory_s, "round_ms_turns": ms,
               "roofline_share": [1e3 * roof.step_time_s / m for m in ms],
               "argument_bytes_meta": args_meta[0],
               "argument_bytes_meta_blocks": args_meta[1],
               "argument_bytes_card_allocated": args_card,
               "peak_recorder_meta": meta_peak,
               "peak_recorder_card": card_peak,
               "max_memory_allocated": max_alloc,
               "max_memory_allocated_gib": max_alloc / 2 ** 30}
        print(f"[tooling] round {name}: {json.dumps(rec)}", flush=True)
        if not same:
            diff = {k: (v, card_cost.as_dict()[k]) for k, v in
                    meta_cost.as_dict().items()
                    if card_cost.as_dict()[k] != v}
            fail(f"{name}: op_cost on meta differs from the card's: {diff}")
        if name.startswith("olmo") and args_meta[1] != args_card:
            fail(f"{name}: argument bytes {args_meta} on meta, "
                 f"{args_card} allocated on the card")
        recs[name] = rec
        del body, carry
        torch.cuda.empty_cache()
    return recs


def tooling_serve_batched(wrappers) -> dict:
    """(e) examples/port_serve_batched.py's loop at gemma-2b's full width:
    two waves of the example CLI's traffic, finite logits, no kernel
    launched (the loop leaves use_pallas off, as the reference's)."""
    import importlib.util
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    predict("tooling_serve")
    path = ROOT / "examples" / "port_serve_batched.py"
    spec = importlib.util.spec_from_file_location("port_serve_batched", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    cfg = get_arch("gemma-2b")
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                           "cuda")
    n = M.count_params(params)
    if n != GEMMA_PARAMS:
        fail(f"gemma-2b has {n} parameters, expected {GEMMA_PARAMS}")
    zero_counts(wrappers)
    waves = []
    t0 = time.perf_counter()
    for res in ex.serve_waves(cfg, params, ex.random_prompts(
            cfg, SERVE_WAVES, SERVE_B, SERVE_S, 1, "cuda"), SERVE_G, "cuda"):
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(res["logits"]).all())
        waves.append({"wave": res["wave"], "seconds":
                      time.perf_counter() - t0, "finite": finite,
                      "tokens": list(res["tokens"].shape),
                      "stops": res["stops"].tolist()})
        if not finite or tuple(res["tokens"].shape) != (SERVE_B, SERVE_G):
            fail(f"serve_batched wave {res['wave']}: finite {finite}, "
                 f"tokens {tuple(res['tokens'].shape)}")
        t0 = time.perf_counter()
    no_launches("serve_batched", wrappers)
    rec = {"params": n, "waves": waves}
    print(f"[tooling] serve_batched gemma-2b: {json.dumps(rec)}", flush=True)
    del params
    torch.cuda.empty_cache()
    return rec


def tooling_phase(wrappers) -> dict:
    """Phase 11: (a) the analysis on the card, (c, d) meta against the card
    and memory, (e) the batched serving example, then (b) the dry run,
    alone on the host with the card idle."""
    return {"analysis": tooling_analysis(), "rounds": tooling_rounds(),
            "serve_batched": tooling_serve_batched(wrappers),
            "dryrun": tooling_dryrun()}


# ---- phase 12: the user-facing entry points (examples, dev scripts) ------

# the quickstart's accuracy at round 300 with the port's own draws: 0.2430 on
# the card, 0.218-0.302 over four seed pairs on the CPU (chance is 0.1);
# tests/test_torch_quickstart.py's 0.25 holds for the reference's draws
QUICKSTART_ACC = 0.20
E2E_SIZE, E2E_STEPS, E2E_PARAMS = "100m", 20, 128_994_048


def load_entry(rel: str):
    """A module of the checkout's ``examples/`` or ``scripts/``."""
    import importlib.util
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_quickstart(wrappers) -> dict:
    """port_quickstart.main at its defaults: dp_mix once a round (counted
    from zero over the run), the last round's output against the plain
    twin on the same buffer, gradient and seed, the final accuracy."""
    import torch
    from repro_torch.core import protocol as P
    from repro_torch.kernels.dp_mix import ops
    predict("examples_quickstart")
    ex = load_entry("examples/port_quickstart.py")
    zero_counts(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ex.main([])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in wrappers if k.launches}
    if launches != {"dp_mix_round": res["rounds"]} or (
            res["launches"] != res["rounds"]):
        fail(f"quickstart: launches {launches} ({res['launches']} counted "
             f"by the example) in {res['rounds']} rounds, expected "
             f"dp_mix_round once a round")
    st = res["state"]
    proto, cfg, spec, last = st["proto"], st["cfg"], st["spec"], st["last"]
    g = P.make_flat_local_pass(cfg, proto, spec)(last["flat"],
                                                 last["batch"])[1]
    plan = proto.plan(proto.channel(), "cuda")
    plain = ops.dp_mix_round_plan(
        last["flat"].cpu(), g.cpu(), last["seed"].cpu(),
        proto.plan(proto.channel(), "cpu"), gamma=proto.gamma,
        eta=proto.eta).cuda()
    k32 = st["flat"].float()
    allowed, tol = dp_mix_tolerance(ex.N, last["flat"], g, proto.gamma, plan,
                                    True, k32, plain, False)
    err = (k32 - plain).abs()
    bad = int((err > allowed).sum())
    acc = res["evals"][-1]["eval_acc"]
    cpu = quickstart_on_cpu(ex, res["rounds"])
    drift = float((st["flat"].cpu() - cpu["flat"]).abs().max())
    flips = max(abs(a["eval_acc"] - b) for a, b in zip(res["evals"],
                                                       cpu["accs"]))
    rec = {"rounds": res["rounds"], "launches": res["launches"],
           "d": spec.width, "seconds": seconds,
           "rounds_per_s": res["rounds"] / seconds,
           "max_abs_err": float(err.max()), "tol_f32": tol,
           "violations": bad,
           "evals": res["evals"], "epsilon": res["epsilon"],
           "cpu_accs": cpu["accs"], "cpu_seconds": cpu["seconds"],
           "card_vs_cpu_drift": drift, "card_vs_cpu_acc": flips}
    print(f"[examples] quickstart: {json.dumps(rec)}", flush=True)
    if bad or not torch.isfinite(k32).all():
        fail(f"quickstart: the last round's dp_mix output differs from the "
             f"plain twin at {bad} elements (max err {rec['max_abs_err']:.3g},"
             f" tol {tol:.3g})")
    if acc < QUICKSTART_ACC or acc <= res["evals"][0]["eval_acc"]:
        fail(f"quickstart: eval accuracy {acc:.4f} at round "
             f"{res['evals'][-1]['round']} (round 0: "
             f"{res['evals'][0]['eval_acc']:.4f}), below {QUICKSTART_ACC}")
    # each round within dp_mix's tolerance, added up over the rounds
    if drift > res["rounds"] * tol or flips > 2 / (ex.N * 128):
        fail(f"quickstart: the card's run against the CPU's on the same "
             f"draws: buffer drift {drift:.3g}, accuracies {res['evals']} "
             f"against {cpu['accs']}")
    return rec


def quickstart_on_cpu(ex, rounds: int) -> dict:
    """The quickstart's run again on the CPU from the card run's draws:
    its init (drawn on the card) and noise seeds (the card generator's
    stream, seed 1, replayed) and the host batcher's batches (the same
    numpy stream), dp_mix's plain version every round."""
    import itertools
    import torch
    from repro_torch.core import protocol as P
    from repro_torch.core.trajectory import HostBatches, round_seed
    flat = ex.setup("cuda")[-1].cpu()
    gen = torch.Generator(device="cuda").manual_seed(1)
    seeds = [round_seed(gen).cpu() for _ in range(rounds)]
    proto, cfg, batcher, spec, _ = ex.setup("cpu")
    source = HostBatches(batcher, "cpu")
    ev = {k: torch.as_tensor(v) for k, v in batcher.full(128).items()}
    t0 = time.perf_counter()
    flat, evals, _ = ex.train(
        P.make_flat_train_step(cfg, proto, spec, "cpu"), P.make_eval_fn(cfg),
        spec, flat, (source.draw(None) for _ in itertools.count()),
        iter(seeds), ev, rounds)
    return {"flat": flat, "accs": [float(a) for _, _, a in evals],
            "seconds": time.perf_counter() - t0}


def examples_guarded(rel: str, label: str, rounds: int, wrappers) -> dict:
    """A network example's main with its round guards on: every round
    guarded, the same operations each, no kernel launched."""
    import torch
    predict(label)
    ex = load_entry(rel)
    zero_counts(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ex.main([])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    no_launches(label, wrappers)
    rec = {k: v for k, v in res.items() if k != "state"}
    rec["seconds"] = seconds
    print(f"[examples] {label}: {json.dumps(rec, default=float)}",
          flush=True)
    if res["guarded_rounds"] != rounds or not res["ops_per_round"]:
        fail(f"{label}: {res['guarded_rounds']} guarded rounds of {rounds}")
    eps = res.get("epsilon_composed", res.get("epsilon_composed_mean"))
    if not math.isfinite(eps):
        fail(f"{label}: composed epsilon {eps}")
    return rec


def examples_compare() -> dict:
    """port_compare_schemes.main at its defaults: eps 0.5 a round for
    every scheme, finite accuracies, us/step on the card's clock."""
    predict("examples_compare")
    ex = load_entry("examples/port_compare_schemes.py")
    res = ex.main([])
    rec = {s: {k: r[k] for k in ("final_acc", "final_loss", "epsilon",
                                 "sigma", "us_per_call")}
           for s, r in res["schemes"].items()}
    rec.update(fig5=res["fig5_reproduced"], fig6=res["fig6_reproduced"])
    print(f"[examples] compare_schemes: {json.dumps(rec)}", flush=True)
    for s, r in res["schemes"].items():
        if abs(r["epsilon"] - 0.5) > 1e-6 or not (
                math.isfinite(r["final_acc"]) and r["us_per_call"] > 0):
            fail(f"compare_schemes {s}: {r}")
    return rec


def examples_e2e(wrappers) -> dict:
    """The LM driver at the production size: finite losses, its rates and
    peak, and its checkpoint restored bitwise."""
    import torch
    from repro_torch.checkpoint import restore
    from repro_torch.core import exchange as X
    predict("examples_e2e")
    ex = load_entry("examples/port_train_dwfl_e2e.py")
    ckpt = ROOT / "build" / "examples_e2e" / "ckpt"
    zero_counts(wrappers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = ex.main(["--size", E2E_SIZE, "--steps", str(E2E_STEPS),
                   "--checkpoint", str(ckpt)])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    no_launches("e2e", wrappers)
    wp = res["state"]["wp"]
    back, manifest = restore(str(ckpt), wp)
    a, b = X.tree_flatten(wp)[0], X.tree_flatten(back)[0]
    bitwise = len(a) == len(b) and all(torch.equal(x, y)
                                       for x, y in zip(a, b))
    del back, b
    shutil.rmtree(ckpt.parent, ignore_errors=True)
    rec = {"size": E2E_SIZE, "params": res["params"],
           "workers": res["workers"], "rounds": res["rounds"],
           "seconds": res["seconds"],
           "rounds_per_s": res["rounds"] / res["seconds"],
           "tokens_per_s": res["rounds"] * res["tokens_per_round"]
           / res["seconds"], "peak_gib": peak / 2 ** 30,
           "losses": res["losses"], "first": res["first"],
           "last": res["last"], "verdict": res["verdict"],
           "checkpoint_bitwise": bitwise, "checkpoint_step":
           manifest["step"]}
    print(f"[examples] e2e: {json.dumps(rec)}", flush=True)
    if res["params"] != E2E_PARAMS:
        fail(f"e2e: {res['params']} parameters a worker, expected "
             f"{E2E_PARAMS}")
    if not all(math.isfinite(v) for v in res["losses"]):
        fail(f"e2e: non-finite losses {res['losses']}")
    if not bitwise:
        fail("e2e: the restored checkpoint differs from the saved tree")
    del wp, res, a
    torch.cuda.empty_cache()
    return rec


def examples_dev_smoke(wrappers) -> list:
    predict("examples_dev_smoke")
    mod = load_entry("scripts/port_dev_smoke.py")
    zero_counts(wrappers)
    recs = mod.main([])
    no_launches("dev_smoke", wrappers)
    bad = [r["arch"] for r in recs
           if not (r["finite"] and r.get("decode_finite", True))]
    if bad:
        fail(f"dev_smoke: non-finite results for {bad}")
    return recs


def examples_phase(wrappers) -> dict:
    """Phase 12: the examples and the dev smoke through their mains."""
    return {"quickstart": examples_quickstart(wrappers),
            "dynamic": examples_guarded("examples/port_dynamic_quickstart.py",
                                        "examples_dynamic", 151, wrappers),
            "fleet": examples_guarded("examples/port_fleet_quickstart.py",
                                      "examples_fleet", 30, wrappers),
            "compare": examples_compare(),
            "e2e": examples_e2e(wrappers),
            "dev_smoke": examples_dev_smoke(wrappers)}


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")

    # 1. device
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"[device] {kind} x{count}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    from repro_torch.kernels import build
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.kernels.dp_perturb import ops as dp_perturb_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    count_lib = noise_count_library()
    libs = [ops.LIBRARY, dp_perturb_ops.LIBRARY, fa_ops.LIBRARY,
            ssd_ops.LIBRARY]
    t0 = time.perf_counter()
    built = build.build_all(libs + [count_lib])
    print(f"[build] {json.dumps(built)} in {time.perf_counter() - t0:.1f}s "
          f"-> {build.BUILD_DIR}", flush=True)
    counts, rates = noise_instructions(count_lib), card_rates()
    print(f"[build] dp_mix normal, instructions from the SASS: "
          f"{json.dumps(counts)}; {json.dumps(rates)}", flush=True)
    for lib in libs:
        for line in lib.log_path.read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma", "Performance")):
                print(f"[build] {lib.name}: {line.strip()}", flush=True)
    hgmma = sass_count(fa_ops.LIBRARY, "HGMMA")
    tf32 = sass_count(fa_ops.LIBRARY, "HMMA", "TF32")
    ssd_tf32 = sass_count(ssd_ops.LIBRARY, "HMMA", "TF32")
    print(f"[build] flash_attention SASS: {hgmma} HGMMA (wgmma, bfloat16) and "
          f"{tf32} HMMA .TF32 (mma.sync, float32) instructions; ssd_scan SASS: "
          f"{ssd_tf32} HMMA .TF32", flush=True)
    if not hgmma:
        fail("the bfloat16 flash kernel's SASS holds no wgmma (HGMMA)")
    if not (tf32 and ssd_tf32):
        fail("the float32 flash kernel's or ssd_scan's SASS holds no TF32 mma (HMMA .TF32)")
    mix_tf32 = sass_count(ops.LIBRARY, "HGMMA", "TF32")
    print(f"[build] dp_mix SASS: {mix_tf32} HGMMA .TF32 (wgmma, the large-N "
          f"route's split-TF32 mix)", flush=True)
    if not mix_tf32:
        fail("the dp_mix library's SASS holds no TF32 wgmma (HGMMA .TF32)")

    # 3. kernels: every lattice normal of noise.cuh bitwise; dp_mix at the
    # flat path's shape (the column route), at N = 64, 65, 128, 256 and,
    # over three windows, 2048 (the large-N route), at the largest N the
    # column route takes on this card and the next (as its C launch
    # reports them), its noise fields bitwise at N = 10 and 128;
    # dp_perturb at the tree path's six leaves, flash_attention and
    # ssd_scan at the serve paths' shapes
    check_lattice_normals(count_lib)
    predict("large_n")
    path_rec = None
    for N in (PATH_N, 64):
        for dtype in (torch.float32, torch.bfloat16):
            for noisy in (True, False):
                timed = N == PATH_N or (dtype == torch.float32 and noisy)
                rec = check_dp_mix(N, PATH_D, dtype, noisy, timed, counts,
                                   rates)
                if N == PATH_N and dtype == torch.float32 and noisy:
                    path_rec = rec
                torch.cuda.empty_cache()
    last = max(N for N in range(1, 257) if dp_mix_route(N, PATH_D) == "columns")
    # kernels/work.py declares dp_mix's work on the route an H100 takes
    differ = [N for N in range(1, 257) if work_columns_route(N) != (
        dp_mix_route(N, PATH_D) == "columns")]
    print(f"[kernels] dp_mix column route up to N = {last} on this card; "
          f"kernels/work.py's H100 predicate differs at {differ}", flush=True)
    if differ:
        fail(f"kernels/work.py's dp_mix route differs from the C launch's "
             f"at N = {differ}")
    for N, noisy in ((last, True), (last, False), (last + 1, True), (65, True),
                     (128, True), (256, True)):
        check_dp_mix(N, PATH_D, torch.float32, noisy,
                     noisy and N not in (last + 1, 65), counts, rates)
        torch.cuda.empty_cache()
    large_rec = check_dp_mix_windows(2048, PATH_D, counts, rates,
                                     plain_window=1 << 16, matmul=True)
    torch.cuda.empty_cache()
    for plan in ("ring", "complete"):
        check_dp_mix_precision(2048, 8192, plan)
    torch.cuda.empty_cache()
    for N in (PATH_N, 128):
        check_noise_fields(N, PATH_D)
        torch.cuda.empty_cache()
    dp_mix_plans_phase()
    sparse_rec = sparse_kernel_phase(counts, rates)
    perturb_rec = dp_perturb_phase()
    flash_rec, flash16_rec = flash_phase()
    ssd_rec = ssd_phase()

    # 4. the flat path, counted: the main path at N = 10, then N = 128;
    # then on the dynamic network (iot_dense, then vehicular under a total
    # budget)
    flat_rec = flat_cli(PATH_N, 50)
    large_rec_cli = flat_cli(128, 4)
    train_step_cpu_vs_cuda()
    dyn_launches = dynamic_cli()
    dynamic_round_cpu_vs_cuda()
    sparse_launches = sparse_cli()["sparse_launches"]
    torch.cuda.empty_cache()

    # 5. the worker-tree path, counted per scheme; then on the dynamic
    # network
    store = paper_store()
    perturb_launches = train_tree_schemes(store)
    tree_cli()
    tree_round_cpu_vs_cuda()
    dyn_perturb_launches = dynamic_tree(store)
    dynamic_round_sync_free(store)
    sparse_round_sync_free()
    sparse_tree(SPARSE_TREE_N)
    sparse_turns_rec = sparse_turns()
    torch.cuda.empty_cache()

    # the fleet and telemetry: dp_mix's replicate axis, the fleet CLI
    # (counted), its tree round, its launches, it in turns against the
    # single round; the telemetry CLI and its cost; the sweep
    raxis_rec = raxis_phase(counts, rates)
    fleet_rec = fleet_cli()
    fleet_tree(store)
    fleet_launches(store)
    fleet_turns(store)
    telemetry_cli()
    sweep_phase()
    torch.cuda.empty_cache()
    # the fleet's sparse round: the sparse kernels' replicate axis, the
    # fleet sparse CLI (counted), a reduced round card against CPU
    fleet_sparse = fleet_sparse_phase(counts, rates)

    # the chunk executor: each path's K-round chunk as one CUDA graph
    # (ChunkRunner) bitwise the eager chunk, its launches a replay, and
    # rounds/s with and without the graph in turns
    predict("graphs")
    graphs = graph_phase()
    torch.cuda.empty_cache()

    # sharding and checkpoints: the model axis's windows (logical) and the
    # sharded steps; the sharded CLI (counted) with its checkpoint and the
    # resume; the worker axis's row windows at the worker-scale shape; the
    # process-group paths on a one-rank NCCL group (the worker axis's
    # trajectory counted)
    window_rec = shard_logical_phase(store, counts, rates)
    shard_cli_rec = shard_cli_checkpoint()
    rows_rec = worker_axis_phase(counts, rates)
    group_rec = mesh_one_rank_phase(store)
    torch.cuda.empty_cache()
    if torch.cuda.device_count() >= 2:
        two_card_cli()
        mesh_graph_phase()
    else:
        print("[shard] two cards: not run (one card)", flush=True)
    predict("turns")
    round_turns(store, "after the training phases")
    predict("cli_turns")
    cli_turns()

    # 6. serve: gemma-2b at full width, the CLI and the kernel path, counted
    serve_cli("gemma-2b")
    cfg, params, batch = full_model("gemma-2b", GEMMA_PARAMS)
    flash_launches = serve_kernel_path(cfg, params, batch,
                                       fa_ops.flash_attention)
    # the same parameters in bfloat16: the tensor-core flash kernel
    from repro_torch.core import exchange as X
    from repro_torch.models import model as M
    cfg16 = dataclasses.replace(cfg, **BF16)
    params16 = X.tree_map(lambda t: t.to(torch.bfloat16), params)
    flash16_launches = serve_kernel_path(cfg16, params16, batch,
                                         fa_ops.flash_attention,
                                         rel_tol=BF16_SERVE_TOL)
    serve_cpu_vs_cuda("gemma-2b")

    # 7. profiles
    profile_rounds(store, flat=True)
    profile_rounds(store, flat=False)
    predict("profile")
    profile_rounds(store, flat=True, dynamic=True)
    profile_simulator()
    predict("turns_late")
    round_turns(store, "after serving gemma-2b and the profiles")
    profile_serve(cfg, params, batch)
    profile_serve(cfg16, params16, batch)
    # the decode step as one CUDA graph (DecodeRunner) against the eager
    # step: gemma-2b in float32 and bfloat16, then its sliding-window
    # config (the same weights) decoding past its window
    predict("decode_graph")
    decode_recs = [decode_graph_phase("gemma-2b", cfg, params, batch),
                   decode_graph_phase("gemma-2b bf16", cfg16, params16,
                                      batch)]
    serve_graph_entry(cfg, params, batch)
    del params16, batch
    torch.cuda.empty_cache()
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    cfg_sw = get_arch("gemma-2b", "long_500k")
    batch = serve.build_prompt_batch(
        cfg_sw, SERVE_BATCH, cfg_sw.sliding_window,
        torch.Generator(device="cuda").manual_seed(1), "cuda")
    decode_recs.append(decode_graph_phase("gemma-2b-sw4096", cfg_sw, params,
                                          batch, ring_start))
    del params, batch
    torch.cuda.empty_cache()

    # 8. serve: zamba2-7b at full width and depth, the CLI and the kernel
    # path (ssd_scan once per Mamba2 layer; the shared attention block is
    # called without use_pallas, so flash_attention never), counted
    serve_cli("zamba2-7b")
    cfg, params, batch = full_model("zamba2-7b", ZAMBA_PARAMS)
    ssd_launches = serve_kernel_path(cfg, params, batch,
                                     ssd_ops.ssd_intra_chunk,
                                     others=(fa_ops.flash_attention,))
    serve_cpu_vs_cuda("zamba2-7b")
    profile_serve(cfg, params, batch)
    decode_recs.append(decode_graph_phase("zamba2-7b", cfg, params, batch))
    del params, batch
    torch.cuda.empty_cache()

    # 9. the zoo: the MoE, xLSTM and encoder-decoder families at full width
    # (no kernel on their paths: each run counted at zero launches), and
    # each at reduced() on the card against the CPU; each one's decode
    # graph
    decode_recs += zoo_phase()["decode"]
    print("[decode] summary " + json.dumps([{
        "label": r["label"], "graph_ms": r["step_ms"]["graph"],
        "eager_ms": r["step_ms"]["eager"], "floor_ms": r["floor_ms"],
        "peak_gib": r["peak_gib"]} for r in decode_recs]), flush=True)

    # 10. LM training: olmo-1b's tree round at full depth (one dp_perturb
    # launch a round) and flat round on 4 of 16 layers (one dp_mix launch a
    # round), both kernels at these shapes, the LM CLI and C2's refusal
    lm = lm_train_phase(counts, rates)
    lm_shape = lambda r: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "max_abs_err")}
    torch.cuda.empty_cache()

    # 11. the launch tooling and the static checks: the analysis on the
    # card, op_cost on meta against the card, memory, the batched serving
    # example, the dry run
    tooling_phase(kernel_wrappers())

    # 12. the user-facing entry points: the quickstart (dp_mix counted),
    # the guarded network examples, the scheme comparison, the LM driver
    # at 100M with its checkpoint, the dev smoke
    examples = examples_phase(kernel_wrappers())

    print(json.dumps({"kernels": [{
        "name": "dp_mix", "route": "cuda",
        "source": "src/repro_torch/kernels/dp_mix/csrc/dp_mix.cu",
        "replaces": "src/repro/kernels/dp_mix/dp_mix.py:178",
        "launches": dyn_launches[DYN_SCENARIO][0],
        "launches_by_path": {"flat": flat_rec["launches"],
                             "flat dynamic " + DYN_SCENARIO:
                                 dyn_launches[DYN_SCENARIO][0],
                             "flat dynamic vehicular, total budget":
                                 dyn_launches["vehicular"][0],
                             "flat olmo-1b, 4 of 16 layers, N = 4":
                                 lm["flat"]["launches"]["dp_mix_round"],
                             "examples/port_quickstart":
                                 examples["quickstart"]["launches"]},
        "device_launches_by_path": {
            "flat": flat_rec["device_launches"],
            "flat dynamic " + DYN_SCENARIO: dyn_launches[DYN_SCENARIO][1],
            "flat dynamic vehicular, total budget":
                dyn_launches["vehicular"][1],
            f"ChunkRunner, a replay of {GRAPH_K} static flat rounds":
                graphs["bitwise"]["flat"]["kernels_replay"]},
        "lm_shape": dict(lm_shape(lm["dp_mix"]), N=LM_FLAT_N, d=LM_FLAT_D),
        "max_abs_err": path_rec["max_abs_err"],
        "ms": path_rec["ms"], "plain_ms": path_rec["plain_ms"],
        "bound_ms": path_rec["bound_ms"], "bound_by": path_rec["bound_by"],
        "library_ms": None}, {
        "name": "dp_mix large-N route (dp_mix_prep + dp_mix_tiled, split "
                "TF32), N 2048",
        "route": "cuda",
        "source": "src/repro_torch/kernels/dp_mix/csrc/dp_mix.cu",
        "replaces": "src/repro/kernels/dp_mix/dp_mix.py:178",
        "launches": large_rec_cli["launches"],
        "launches_by_path": {"flat, N = 128": large_rec_cli["launches"]},
        "device_launches_by_path": {
            "flat, N = 128": large_rec_cli["device_launches"]},
        "max_abs_err": large_rec["max_abs_err"],
        "ms": large_rec["ms"], "plain_ms": large_rec["plain_ms"],
        "bound_ms": large_rec["bound_ms"],
        "bound_by": large_rec["bound_by"],
        "matmul_ms": large_rec["matmul_ms"],
        "matmul_note": large_rec["matmul_note"],
        "library_ms": None}, {
        "name": "dp_mix sparse round (dp_mix_prep + dp_mix_gather)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/dp_mix/csrc/dp_mix.cu",
        "replaces": "src/repro/kernels/dp_mix/dp_mix.py:153",
        "launches": sparse_launches,
        "launches_by_path": {"worker scale, N 2048": sparse_launches,
                             "fleet sparse, R 4 x N 512":
                                 fleet_sparse["cli"]["sparse_launches"]},
        "device_launches_by_path": {
            f"ChunkRunner, a replay of {GRAPH_SPARSE_K} rounds at N 2048":
                graphs["bitwise"]["sparse"]["kernels_replay"]},
        "max_abs_err": sparse_rec["max_abs_err"],
        "ms": sparse_rec["ms"], "plain_ms": sparse_rec["plain_ms"],
        "bound_ms": sparse_rec["bound_ms"],
        "bound_by": sparse_rec["bound_by"],
        "prep_ms": min(sparse_turns_rec["prep_ms"]),
        "gather_ms": min(sparse_turns_rec["gather_ms"]),
        "sparse_mm_ms": sparse_turns_rec["sparse_mm_ms"],
        "sparse_mm_note": sparse_turns_rec["sparse_mm_note"],
        "library_ms": None}, {
        "name": "dp_mix sparse round, replicate axis", "route": "cuda",
        "source": "src/repro_torch/kernels/dp_mix/csrc/dp_mix.cu",
        "replaces": "src/repro/kernels/dp_mix/dp_mix.py:153",
        "launches": fleet_sparse["cli"]["sparse_launches"],
        "max_abs_err": fleet_sparse["kernel"]["max_abs_err"],
        "ms": fleet_sparse["kernel"]["ms"],
        "separate_ms": fleet_sparse["kernel"]["separate_ms"],
        "plain_ms": fleet_sparse["kernel"]["plain_ms"],
        "bound_ms": fleet_sparse["kernel"]["bound_ms"],
        "bound_by": fleet_sparse["kernel"]["bound_by"],
        "library_ms": None}, {
        "name": "dp_mix replicate axis", "route": "cuda",
        "source": "src/repro_torch/kernels/dp_mix/csrc/dp_mix.cu",
        "replaces": "src/repro/kernels/dp_mix/dp_mix.py:178",
        "launches": fleet_rec["launches"],
        "device_launches_by_path": {
            "fleet CLI": fleet_rec["device_launches"],
            f"ChunkRunner, a replay of {GRAPH_K} fleet rounds":
                graphs["bitwise"]["fleet"]["kernels_replay"]},
        "max_abs_err": raxis_rec["max_abs_err"],
        "ms": raxis_rec["ms"], "plain_ms": raxis_rec["plain_ms"],
        "bound_ms": raxis_rec["bound_ms"], "bound_by": raxis_rec["bound_by"],
        "separate_ms": raxis_rec["separate_ms"], "library_ms": None}, {
        "name": "dp_mix column windows (model axis, S = 2; logical: the "
                "padded buffer in one launch)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/dp_mix/csrc/dp_mix.cu",
        "replaces": "src/repro/kernels/dp_mix/dp_mix.py:178",
        "launches": shard_cli_rec["launches"],
        "max_abs_err": window_rec["max_abs_err"],
        "ms": window_rec["ms"], "plain_ms": window_rec["plain_ms"],
        "bound_ms": window_rec["bound_ms"],
        "bound_by": window_rec["bound_by"],
        "unsharded_ms": window_rec["whole_ms"], "library_ms": None}, {
        "name": "dp_mix row windows (worker axis, S = 2: dp_mix_prep_rows "
                "+ dp_mix_gather_rows)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/dp_mix/csrc/dp_mix.cu",
        "replaces": "src/repro/kernels/dp_mix/dp_mix.py:153",
        "launches": group_rec["worker_launches"]["dp_mix_prep_rows"],
        "launches_by_kernel": group_rec["worker_launches"],
        "max_abs_err": rows_rec["max_abs_err"],
        "ms": rows_rec["ms"], "plain_ms": rows_rec["plain_ms"],
        "bound_ms": rows_rec["bound_ms"], "bound_by": rows_rec["bound_by"],
        "unsharded_ms": rows_rec["whole_ms"], "library_ms": None}, {
        "name": "dp_perturb", "route": "cuda",
        "source": "src/repro_torch/kernels/dp_perturb/csrc/dp_perturb.cu",
        "replaces": "src/repro/kernels/dp_perturb/dp_perturb.py:42",
        "launches": dyn_perturb_launches,
        "launches_by_path": {"tree, four schemes": perturb_launches,
                             "tree dynamic " + DYN_TREE_SCENARIO:
                                 dyn_perturb_launches,
                             "tree olmo-1b, full depth, N = 2":
                                 lm["tree"]["launches"]["sgd_update_leaves"]},
        "device_launches_by_path": {
            f"ChunkRunner, a replay of {GRAPH_K} tree rounds":
                graphs["bitwise"]["tree"]["kernels_replay"]},
        "lm_shape": dict(lm_shape(lm["sgd_update_leaves"]),
                         leaves=lm["sgd_update_leaves"]["leaves"],
                         elements=lm["sgd_update_leaves"]["elements"],
                         library_ms=lm["sgd_update_leaves"]["library_ms"]),
        "max_abs_err": perturb_rec["max_abs_err"],
        "ms": perturb_rec["ms"], "plain_ms": perturb_rec["plain_ms"],
        "bound_ms": perturb_rec["bound_ms"],
        "bound_by": perturb_rec["bound_by"],
        "library_ms": perturb_rec["library_ms"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:27",
        "launches": flash_launches,
        "max_abs_err": flash_rec["max_abs_err"],
        "ms": flash_rec["ms"], "plain_ms": flash_rec["plain_ms"],
        "bound_ms": flash_rec["bound_ms"], "bound_by": flash_rec["bound_by"],
        "library_ms": flash_rec["library_ms"]}, {
        "name": "flash_attention (bfloat16)", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:27",
        "launches": flash16_launches,
        "max_abs_err": flash16_rec["max_abs_err"],
        "ms": flash16_rec["ms"], "plain_ms": flash16_rec["plain_ms"],
        "bound_ms": flash16_rec["bound_ms"],
        "bound_by": flash16_rec["bound_by"],
        "library_ms": flash16_rec["library_ms"]}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:26",
        "launches": ssd_launches,
        "max_abs_err": ssd_rec["max_abs_err"],
        "ms": ssd_rec["ms"], "plain_ms": ssd_rec["plain_ms"],
        "bound_ms": ssd_rec["bound_ms"], "bound_by": ssd_rec["bound_by"],
        "library_ms": None}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(two_cards_main() if sys.argv[1:] == ["--two-cards"]
                     else main())
