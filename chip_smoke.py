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
             float32; ssd_scan: HMMA .TF32); the instructions of one
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
             (timed), all at the path's d, its two noise fields bitwise the
             plain version's at N = 10 and 128, and its bound the longest
             of its bytes, its instructions and its mix's fused
             multiply-adds; dp_mix under the dynamic network's plans: a
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
             batch 32, d = 855,050), 51 rounds; every loss finite and
             dp_mix launched once per round; the same CLI at N = 128 (the
             large-N route), 5 rounds, launched once a round; one small
             flat round on the card against the same round on the CPU;
             the flat CLI on the dynamic network (``--channel-model
             dynamic --scenario iot_dense``, N = 10, 51 rounds): dp_mix
             once a round, every loss finite, the per-round epsilon
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
             its rows with the reference's keys;
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
             bfloat16;
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
             the profile of one prefill and one decode step.

Each phase of the dynamic network and of the fleet is preceded by a
``[predict]`` line, what it was expected to show (PREDICTIONS). The last three lines of standard
output are the kernels' JSON record, the nvidia-smi line, and {"ok": true,
"device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet; at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12                # float32 on the CUDA cores
TF32_TC_FLOP_PER_S = 495e12           # dense TF32 on the tensor cores
BF16_TC_FLOP_PER_S = 989e12           # dense bfloat16 on the tensor cores
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


# float operations per element of csrc/dp_perturb.cu: the local step's FMA
# (2); noisy, also the two uniforms (4), -2 log, sqrt, 2 pi u2, r cos, the
# noise scale and the final FMA (7), and libdevice's logf and cosf at
# about 20 and 25 operations (hash excluded)
PERTURB_FLOPS, PERTURB_NOISY_FLOPS = 2, 58

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
# What each phase of the dynamic network is expected to show, written
# before the card ran it; each is printed on a line before its phase.
PREDICTIONS = {
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
    "sparse_kernel": "the sparse round (dp_mix_prep + dp_mix_gather) within "
                     "its tolerance of the plain twin at (2048, 855,050, k "
                     "12) in float32 and bfloat16, noisy and gossip; float32 "
                     "noisy 30-40 ms (PR 21's probe: 35.2) against a bound "
                     "of ~7 ms (operations) and a workspace floor of 18.8; "
                     "with zero weights bitwise the dense kernel's round at "
                     "N = 64 and 2048; the graph against SparseW.dense() "
                     "at N = 64 within 1e-5",
    "sparse_cli": "5 dp_mix_round_sparse calls in 5 rounds and no dense "
                  "dp_mix_round, every loss finite, epsilon over 5 rounds; "
                  "6-9 rounds/s over the 5 rounds, the first eval and "
                  "first calls included (PR 21's probe: 7.51); peak 38-44 "
                  "GiB (the probe: 40.6: the buffer, its clipped gradient, "
                  "the output and the [2, N, d] workspace, 6.5 GiB each "
                  "but the workspace's 13)",
    "sparse_sync": "no synchronizing call in sim.round's neighbor-list "
                   "build, plan_dynamic_sparse and the sparse dp_mix call at "
                   "N = 2048; the whole round body at N = 64 also free of one",
    "sparse_turns": "in turns at N = 2048: the sparse round 30-40 ms, the "
                    "dense large-N route 250-280 ms (PR 19: 266.6), so "
                    "7-9x (PR 21's probe: 34.8 against 265.7); the "
                    "simulator's sparse round 1.5-2.5 ms against its dense "
                    "one's 0.9-1.3 (the probe: 1.84 against 1.06: the block "
                    "sort and the gathers are more launches than the [N, N] "
                    "graph); the whole sparse flat round 60-100 ms (the mix "
                    "35, the gradient pass, its clip and the metrics over "
                    "the 7 GB buffer 20-50, the simulator 2)",
    "sparse_tree": "one dp_perturb launch (sgd_update_leaves) a sparse "
                   "dynamic tree round at N = 64, 11 in 11, W a SparseW, "
                   "every loss finite",
    "raxis": "dp_mix's replicate axis bitwise R separate launches (0 "
             "elements differ) at (R 8, N 10, 855,050) in float32 and "
             "bfloat16 (column route) and at (R 4, N 64) (large-N route), "
             "within dp_mix_tolerance of the plain twin replicate by "
             "replicate; R 8 float32 0.50-0.56 ms (PR 22's call 1: 0.517) "
             "against R separate launches' 0.56-0.62 (0.577-0.597) and a "
             "bound of ~0.262 ms (8 x 0.0328, operations)",
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
    lanes x the SM clock; the mix's N^2 d fused multiply-adds at 67
    TFLOP/s."""
    nbytes = 3 * N * d * elem + (N * N + 4 * N + 4) * 4
    instr = N * d * dp_mix_element_ops(N, noisy)
    if noisy:
        instr += (branches["small"] * counts["small"]
                  + branches["large"] * counts["large"]
                  + branches["tail"] * counts["tail_extra"])
    t = {"bytes": nbytes / HBM_BYTES_PER_S,
         "instructions": instr / (rates["sms"] * 128 * rates["sm_clock_hz"]),
         "fma": 2 * N * N * d / F32_FLOP_PER_S}
    bound = max(t.values())
    return {"bytes": nbytes, "lane_instructions": instr, "fmas": N * N * d,
            "bytes_ms": 1e3 * t["bytes"],
            "instructions_ms": 1e3 * t["instructions"],
            "fma_ms": 1e3 * t["fma"], "bound_ms": 1e3 * bound,
            "bound_by": "bytes" if t["bytes"] == bound else "operations"}


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
    x = p.float() - gamma * g.float()
    scale = float(x.abs().max())
    if noisy:
        scale += 5.42 * float((plan.amp / plan.c.reshape(())).abs().max()
                              + (plan.m_scale * plan.sigma_m).abs().max())
    tol = (N + 8) * 2.0 ** -23 * scale
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
                         width: int = 4096) -> dict:
    """A round too large for the plain version at full width (N = 2048 at
    the path's d: p, g and out 21 GB, the workspace 14 GB): the kernel
    once, held against the plain version over three column windows (the
    first, one in the middle, the ragged last), each with its col0 and the
    full counter_width, so the window draws the same noise; then timed."""
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
    del out
    rec = {"N": N, "d": d, "dtype": "float32", "noisy": True,
           "route": dp_mix_route(N, d), "windows": 3, "window": width,
           "max_abs_err": max_err, "tol_f32": tol, "violations": bad,
           "ms": cuda_ms(kernel, iters=2, warmup=1)}
    branches = noise_branches(N, d, kw["counter_width"], 1234567)
    rec.update(dp_mix_work(N, d, 4, True, counts, rates, branches))
    rec["branches"] = branches
    print(f"[kernels] dp_mix {json.dumps(rec)}", flush=True)
    if bad:
        fail(f"dp_mix N={N} windows: {bad} elements beyond tolerance "
             f"(max err {max_err:.3g})")
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
    """The flat CLI at ``workers``, dp_mix's count set to 0 just before
    and read just after: one launch a round, every loss finite."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.launch import train
    ops.dp_mix_round.launches = 0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    res = train.run(["--arch", "dwfl-paper", "--flat-buffer",
                     "--workers", str(workers), "--batch-size", "32",
                     "--steps", str(steps), "--eval-every", str(steps // 2),
                     "--device", "cuda"])
    launches = ops.dp_mix_round.launches
    peak = torch.cuda.max_memory_allocated()
    losses, rounds = res["losses"], res["rounds"]
    print(f"[train] N = {workers}: {rounds} rounds in {res['seconds']:.3f}s "
          f"= {rounds / res['seconds']:.2f} rounds/s; peak device memory "
          f"{peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB held before the "
          f"run); dp_mix launches {launches} "
          f"({dp_mix_route(workers, PATH_D)} "
          f"route); first/last loss {float(losses[0]):.4f}/"
          f"{float(losses[-1]):.4f}", flush=True)
    if losses.numel() != rounds or not torch.isfinite(losses).all():
        fail(f"train N={workers}: expected {rounds} finite losses, got "
             f"{losses.tolist()}")
    if launches != rounds:
        fail(f"train N={workers}: dp_mix launched {launches} times for "
             f"{rounds} rounds")
    if not torch.isfinite(res["params"]).all():
        fail(f"train N={workers}: non-finite parameters")
    return {"launches": launches, "rounds": rounds}


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
    """The dynamic flat CLI at full width (iot_dense, N = 10, 51 rounds),
    dp_mix's count set to 0 just before and read just after: one launch a
    round, every loss finite, the epsilon trajectory over every round;
    then vehicular under a total budget (--total-epsilon 8 --accountant
    rdp), 5 rounds."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.launch import train
    predict("dynamic_cli")
    counts = {}
    for scenario, steps, extra in (
            (DYN_SCENARIO, DYN_STEPS, []),
            ("vehicular", 4, ["--total-epsilon", "8", "--accountant", "rdp"])):
        ops.dp_mix_round.launches = 0
        res = train.run(["--arch", "dwfl-paper", "--flat-buffer",
                         "--channel-model", "dynamic", "--scenario", scenario,
                         "--workers", str(PATH_N), "--batch-size", "32",
                         "--steps", str(steps), "--eval-every",
                         str(max(steps // 2, 1)), "--device", "cuda", *extra])
        launches = ops.dp_mix_round.launches
        rep, losses, rounds = res["epsilon_report"], res["losses"], res["rounds"]
        rec = {"scenario": scenario, "rounds": rounds,
               "seconds": res["seconds"],
               "rounds_per_s": rounds / res["seconds"], "launches": launches,
               "first_loss": float(losses[0]), "last_loss": float(losses[-1]),
               "eps_rounds": rep["rounds"], "eps_worst": rep["epsilon_worst"],
               "eps_total": rep["epsilon_total"],
               "eps_rdp": rep["epsilon_rdp"]}
        print(f"[dynamic] cli {json.dumps(rec)}", flush=True)
        if launches != rounds or rep["rounds"] != rounds:
            fail(f"dynamic cli {scenario}: dp_mix launched {launches} times, "
                 f"epsilon over {rep['rounds']} rounds, for {rounds} rounds")
        if not (torch.isfinite(losses).all()
                and torch.isfinite(res["params"]).all()
                and np_finite(rep["epsilon_per_round"])):
            fail(f"dynamic cli {scenario}: non-finite losses, parameters or "
                 f"epsilons")
        if extra and rep["epsilon_rdp"] > 8.0 * (1 + 1e-6):
            fail(f"dynamic cli {scenario}: rdp total {rep['epsilon_rdp']} "
                 f"over its budget of 8")
        counts[scenario] = launches
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
    nbytes = 3 * N * d * elem + N * k * 8 + 6 * N * 4 + 16
    instr = N * d * sparse_element_ops(nnz / N, noisy)
    if noisy:
        instr += (branches["small"] * counts["small"]
                  + branches["large"] * counts["large"]
                  + branches["tail"] * counts["tail_extra"])
    t = {"bytes": nbytes / HBM_BYTES_PER_S,
         "instructions": instr / (rates["sms"] * 128 * rates["sm_clock_hz"]),
         "fma": 2 * (nnz + N) * d / F32_FLOP_PER_S}
    bound = max(t.values())
    ws = (2 * elem + (8 if noisy else 4)) + (2 * elem + (8 if noisy else 4)
                                             + elem)
    return {"bytes": nbytes, "lane_instructions": instr,
            "fmas": (nnz + N) * d, "bytes_ms": 1e3 * t["bytes"],
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
    mix in place of N. Timed: the kernel, the plain twin over the whole
    round in windows of 2^16 columns, and the bound (sparse_work)."""
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
    kernel = lambda: ops._launch_sparse(*args, **kw)
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
    2048, --sparse-neighbors 12, 5 rounds), the dp_mix counts set to 0
    just before and read just after: one dp_mix_round_sparse call a round
    and no dense dp_mix_round; every loss finite, the epsilon trajectory
    over every round; its rounds/s, peak device memory and the active
    workers the CLI found isolated in its first graph draw (it prints a
    warning when there are any)."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.launch import train
    predict("sparse_cli")
    torch.cuda.reset_peak_memory_stats()
    ops.dp_mix_round_sparse.launches = ops.dp_mix_round.launches = 0
    res = train.run(["--arch", "dwfl-paper", "--flat-buffer",
                     "--channel-model", "dynamic", "--scenario",
                     SPARSE_SCENARIO, "--sparse-neighbors", str(SPARSE_K),
                     "--workers", str(SPARSE_N), "--steps",
                     str(SPARSE_STEPS), "--device", "cuda"])
    sparse, dense = ops.dp_mix_round_sparse.launches, ops.dp_mix_round.launches
    rep, losses, rounds = res["epsilon_report"], res["losses"], res["rounds"]
    rec = {"scenario": SPARSE_SCENARIO, "N": SPARSE_N, "k": SPARSE_K,
           "rounds": rounds, "seconds": res["seconds"],
           "rounds_per_s": rounds / res["seconds"],
           "sparse_launches": sparse, "dense_launches": dense,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "isolated_workers": res["isolated_workers"],
           "first_loss": float(losses[0]), "last_loss": float(losses[-1]),
           "eps_rounds": rep["rounds"], "eps_worst": rep["epsilon_worst"],
           "eps_total": rep["epsilon_total"]}
    print(f"[sparse] cli {json.dumps(rec)}", flush=True)
    if sparse != rounds or dense or rep["rounds"] != rounds:
        fail(f"sparse cli: {sparse} sparse and {dense} dense dp_mix calls, "
             f"epsilon over {rep['rounds']} rounds, for {rounds} rounds")
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


def sparse_turns() -> dict:
    """At N = 2048 and the path's d, in turns (sparse, dense, dense,
    sparse), each timed by CUDA events: the sparse round's kernels against
    the dense large-N route given the same round's SparseW.dense(); then
    the simulator's mesh_sparse round with the neighbor list against the
    same scenario's dense round (Metropolis weights of the [N, N]
    unit-disk graph), host clock around 10 rounds ending in a
    synchronize, in turns; then the whole sparse flat round
    (sparse_flat_round_ms)."""
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
    dense_W = W.dense().contiguous()
    runs = {"sparse": lambda: ops._launch_sparse(*args, **kw),
            "dense": lambda: ops._launch(*args[:9], dense_W, **kw)}
    ms = {"sparse": [], "dense": []}
    for name in ("sparse", "dense", "dense", "sparse"):
        ms[name].append(cuda_ms(runs[name], iters=2, warmup=1))
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
    del p, g, args, runs
    torch.cuda.empty_cache()
    rec = {"N": SPARSE_N, "d": PATH_D, "k": SPARSE_K, "round_ms": ms,
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
        numel = p.numel()
        nbytes = (4 if noisy else 3) * numel * p.element_size()
        flops = numel * (PERTURB_NOISY_FLOPS if noisy else PERTURB_FLOPS)
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


def check_leaves(dtype, timed: bool) -> dict:
    """sgd_update_leaves, the tree path's local step, over its six leaves
    in one launch: each leaf bitwise the per-leaf kernel (a table of one
    entry) and within 1 ULP of the plain version (a bfloat16 output one
    bfloat16 step further). Timed, per round: the one launch, beside the
    per-leaf kernel's six launches, the plain version, six ``torch.add``
    calls and one ``torch._foreach_add`` over the six leaves (library_ms;
    the port calls neither); the bound: p and g read and x written once
    over 3.35 TB/s, one FMA per element over 67 TFLOP/s. The one launch
    and ``_foreach_add`` are also timed inside a CUDA graph (device_ms,
    library_device_ms): the device's time without the host's."""
    import torch
    from repro_torch.kernels.dp_perturb import ops
    gen = torch.Generator(device="cuda").manual_seed(11)
    ps = [torch.randn(s, generator=gen, device="cuda").to(dtype)
          for s in MLP_LEAVES]
    gs = [(0.1 * torch.randn(s, generator=gen, device="cuda")).to(dtype)
          for s in MLP_LEAVES]
    gamma = 0.01
    kernel = lambda: ops.sgd_update_leaves(ps, gs, gamma)
    per_leaf = lambda: [ops.sgd_update(p, g, gamma) for p, g in zip(ps, gs)]
    plain = lambda: ops.sgd_update_leaves_plain(ps, gs, gamma)
    xs, ones, refs = kernel(), per_leaf(), plain()
    torch.cuda.synchronize()
    bad, err = 0, 0.0
    for x, one, r in zip(xs, ones, refs):
        bad += int((x != one).sum())
        k32, r32 = x.float(), r.float()
        if not torch.isfinite(k32).all():
            fail(f"sgd_update_leaves {dtype}: non-finite x")
        step = (2.0 ** -7 * torch.maximum(k32.abs(), r32.abs())
                if dtype == torch.bfloat16 else 0.0)
        ok = (ulp_dist(k32, r32) <= 1) | ((k32 - r32).abs() <= step)
        bad += int((~ok).sum())
        err = max(err, float((k32 - r32).abs().max()))
    rec = {"leaves": len(MLP_LEAVES), "dtype": str(dtype).split(".")[-1],
           "max_abs_err": err, "violations": bad}
    if timed:
        numel = sum(p.numel() for p in ps)
        nbytes = 3 * numel * ps[0].element_size()
        flops = numel * PERTURB_FLOPS
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
        rec["ms"] = cuda_ms(kernel, iters=50)
        rec["per_leaf_ms"] = cuda_ms(per_leaf, iters=50)
        rec["plain_ms"] = cuda_ms(plain, iters=5, warmup=1)
        rec["torch_add_ms"] = cuda_ms(lambda: [
            torch.add(p, g, alpha=-gamma) for p, g in zip(ps, gs)], iters=50)
        rec["library_ms"] = cuda_ms(
            lambda: torch._foreach_add(ps, gs, alpha=-gamma), iters=50)
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


class Work(NamedTuple):
    """What one call of a tensor-core kernel needs and does: ``flops``, the
    function's operations; ``nbytes``, its inputs read once and its outputs
    written once; ``rate``, the peak of the kernel's route; ``kernel_flops``,
    the route's own products (3 TF32 products for each float32 one; in
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


def kept_pairs(S: int, window: Optional[int] = None) -> int:
    """(query, key) pairs of one causal [S, S] score tile that the mask
    keeps: key <= query, and query - key < window where there is one."""
    w = S if window is None else min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def flash_work(B: int, S: int, H: int, Hkv: int, hd: int, elem: int,
               window: Optional[int] = None) -> Work:
    """Work of one causal flash_attention call at (B, S, H, Hkv, hd) with
    elements of ``elem`` bytes (4: float32 on split TF32; 2: bfloat16 on
    wgmma): 2 products of 2 hd operations per (query, key) pair the mask
    keeps; q, k, v read once and o written once."""
    flops = 4 * hd * kept_pairs(S, window) * B * H
    nbytes = (2 * B * S * H * hd + 2 * B * S * Hkv * hd) * elem
    if elem == 2:
        return Work(flops, nbytes, BF16_TC_FLOP_PER_S, flops * 3 // 2)
    return Work(flops, nbytes, TF32_TC_FLOP_PER_S, 3 * flops)


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


def ssd_work(shape, elem: int) -> Work:
    """Work of the SSD intra-chunk step at ``shape`` with x, Bm, Cm of
    ``elem`` bytes, as the scan launches it (with cs). Bytes: x, Bm, Cm,
    dt, dA read once; y, states, cdecay and cs written once. Operations,
    over the q (q + 1) / 2 causal pairs (i, j <= i) of each chunk: the
    scores C_i . B_j once per chunk, as Bm and Cm are one group shared by
    all heads (2N); per head the decay (subtract, exp, multiply: 3) and G @
    (x dt) (2P); per row and head x dt (P), B exp(cs_last - cs) dt (N + 3)
    and the states' product (2PN); per chunk and head exp(cs_last). The
    route is split TF32 on the tensor cores: its own work is three TF32
    products for each of the products (the scores, G @ (x dt), the
    states)."""
    B, S, H, P, N, q = shape
    nc = S // q
    pairs = q * (q + 1) // 2
    products = B * nc * (pairs * 2 * N + H * (pairs * 2 * P + q * 2 * P * N))
    flops = B * nc * (pairs * 2 * N
                      + H * (pairs * (3 + 2 * P) + q * (P + N + 3 + 2 * P * N) + 1))
    nbytes = (elem * (2 * B * S * H * P + 2 * B * S * N)
              + 4 * (3 * B * S * H + B * nc * H * P * N + B * nc * H))
    return Work(flops, nbytes, TF32_TC_FLOP_PER_S, 3 * products)


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


def full_model(arch: str, n_params: int):
    """An arch at its published width, random parameters from seed 0 on
    the card, and a batch of 4 prompts of 1024 tokens."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = get_arch(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(gen, cfg, "cuda")
    n = M.count_params(params)
    if n != n_params:
        fail(f"{arch} has {n} parameters, expected {n_params}")
    print(f"[serve] {arch}: {n} parameters", flush=True)
    batch = serve.build_prompt_batch(cfg, SERVE_BATCH, SERVE_PROMPT, gen, "cuda")
    return cfg, params, batch


def serve_cli(arch: str, kernel) -> None:
    """The reference's serve run at full width: --arch ARCH --full with its
    defaults (batch 4, prompt 64, gen 32); the CLI leaves use_pallas off,
    so ``kernel`` (the arch's kernel wrapper) launches no time."""
    import torch
    from repro_torch.launch import serve
    kernel.launches = 0
    res = serve.run(["--arch", arch, "--full", "--device", "cuda"])
    launches = kernel.launches
    print(f"[serve] cli {arch} --full: prefill {res['prefill_s'] * 1e3:.1f} ms, "
          f"decode 31 steps {res['decode_s'] * 1e3:.1f} ms; {kernel.__name__} "
          f"launches {launches}", flush=True)
    if launches or not torch.isfinite(res["logits"]).all():
        fail(f"serve cli {arch}: {launches} {kernel.__name__} launches, finite "
             f"logits {bool(torch.isfinite(res['logits']).all())}")
    del res
    torch.cuda.empty_cache()


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
    B, S = SERVE_BATCH, SERVE_PROMPT
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
    bound (the R rounds' bytes, instructions and FMAs summed)."""
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
        t = {"bytes": sum(w["bytes"] for w in works) / HBM_BYTES_PER_S,
             "instructions": sum(w["lane_instructions"] for w in works)
             / (rates["sms"] * 128 * rates["sm_clock_hz"]),
             "fma": 2 * sum(w["fmas"] for w in works) / F32_FLOP_PER_S}
        bound = max(t.values())
        rec.update({"bytes_ms": 1e3 * t["bytes"],
                    "instructions_ms": 1e3 * t["instructions"],
                    "fma_ms": 1e3 * t["fma"], "bound_ms": 1e3 * bound,
                    "bound_by": ("bytes" if t["bytes"] == bound
                                 else "operations")})
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


def fleet_cli() -> dict:
    """The fleet CLI at full width (the README's vehicular line with the
    flat buffer), the dp_mix count set to 0 just before and read just
    after: one launch a fleet round for all R, under the CLI's sync guard
    (on by default); the guard must raise on a .item()."""
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
    res = train.run(["--arch", "dwfl-paper", "--flat-buffer",
                     "--channel-model", "dynamic", "--scenario",
                     FLEET_SCENARIO, "--replicates", str(FLEET_R),
                     "--workers", str(PATH_N), "--steps", str(FLEET_STEPS),
                     "--eval-every", str(FLEET_STEPS // 2),
                     "--device", "cuda"])
    launches = ops.dp_mix_round.launches
    rep, losses, rounds = res["epsilon_report"], res["losses"], res["rounds"]
    rec = {"scenario": FLEET_SCENARIO, "replicates": FLEET_R,
           "rounds": rounds, "launches": launches, "seconds": res["seconds"],
           "rounds_per_s": rounds / res["seconds"],
           "replicate_rounds_per_s": FLEET_R * rounds / res["seconds"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "first_loss": losses[0].tolist(), "last_loss": losses[-1].tolist(),
           "eps_replicates": rep["replicates"], "eps_rounds": rep["rounds"],
           "eps_composed_mean": rep["epsilon_composed_mean"],
           "eps_total_mean": rep["epsilon_total_mean"]}
    print(f"[fleet] cli {json.dumps(rec)}", flush=True)
    if launches != rounds:
        fail(f"fleet cli: dp_mix launched {launches} times for {rounds} "
             f"rounds of {FLEET_R} replicates")
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
    launches; and the device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import trajectory as TJ
    predict("fleet_launches")
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
    print(f"[fleet] launches per round {json.dumps(rec)}", flush=True)
    a, b = rec[2], rec[FLEET_R]
    if (a["launch_calls_per_round"] != b["launch_calls_per_round"]
            or a["device_ops_per_round"] != b["device_ops_per_round"]):
        fail(f"fleet round: launches differ between R = 2 and R = {FLEET_R}:"
             f" {rec}")
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

    # 3. kernels: every lattice normal of noise.cuh bitwise; dp_mix at the
    # flat path's shape (the column route), at N = 64, 65, 128, 256 and,
    # over three windows, 2048 (the large-N route), at the largest N the
    # column route takes on this card and the next (as its C launch
    # reports them), its noise fields bitwise at N = 10 and 128;
    # dp_perturb at the tree path's six leaves, flash_attention and
    # ssd_scan at the serve paths' shapes
    check_lattice_normals(count_lib)
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
    for N, noisy in ((last, True), (last, False), (last + 1, True), (65, True),
                     (128, True), (256, True)):
        check_dp_mix(N, PATH_D, torch.float32, noisy,
                     noisy and N not in (last + 1, 65), counts, rates)
        torch.cuda.empty_cache()
    check_dp_mix_windows(2048, PATH_D, counts, rates)
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
    launches = flat_cli(PATH_N, 50)["launches"]
    flat_cli(128, 4)
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
    sparse_turns()
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
    predict("turns")
    round_turns(store, "after the training phases")
    predict("cli_turns")
    cli_turns()

    # 6. serve: gemma-2b at full width, the CLI and the kernel path, counted
    serve_cli("gemma-2b", fa_ops.flash_attention)
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
    del params, params16, batch
    torch.cuda.empty_cache()

    # 8. serve: zamba2-7b at full width and depth, the CLI and the kernel
    # path (ssd_scan once per Mamba2 layer; the shared attention block is
    # called without use_pallas, so flash_attention never), counted
    serve_cli("zamba2-7b", ssd_ops.ssd_intra_chunk)
    cfg, params, batch = full_model("zamba2-7b", ZAMBA_PARAMS)
    ssd_launches = serve_kernel_path(cfg, params, batch,
                                     ssd_ops.ssd_intra_chunk,
                                     others=(fa_ops.flash_attention,))
    serve_cpu_vs_cuda("zamba2-7b")
    profile_serve(cfg, params, batch)
    del params, batch
    torch.cuda.empty_cache()

    print(json.dumps({"kernels": [{
        "name": "dp_mix", "route": "cuda",
        "source": "src/repro_torch/kernels/dp_mix/csrc/dp_mix.cu",
        "replaces": "src/repro/kernels/dp_mix/dp_mix.py:178",
        "launches": dyn_launches[DYN_SCENARIO],
        "launches_by_path": {"flat": launches,
                             "flat dynamic " + DYN_SCENARIO:
                                 dyn_launches[DYN_SCENARIO],
                             "flat dynamic vehicular, total budget":
                                 dyn_launches["vehicular"]},
        "max_abs_err": path_rec["max_abs_err"],
        "ms": path_rec["ms"], "plain_ms": path_rec["plain_ms"],
        "bound_ms": path_rec["bound_ms"], "bound_by": path_rec["bound_by"],
        "library_ms": None}, {
        "name": "dp_mix sparse round (dp_mix_prep + dp_mix_gather)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/dp_mix/csrc/dp_mix.cu",
        "replaces": "src/repro/kernels/dp_mix/dp_mix.py:153",
        "launches": sparse_launches,
        "max_abs_err": sparse_rec["max_abs_err"],
        "ms": sparse_rec["ms"], "plain_ms": sparse_rec["plain_ms"],
        "bound_ms": sparse_rec["bound_ms"],
        "bound_by": sparse_rec["bound_by"], "library_ms": None}, {
        "name": "dp_mix replicate axis", "route": "cuda",
        "source": "src/repro_torch/kernels/dp_mix/csrc/dp_mix.cu",
        "replaces": "src/repro/kernels/dp_mix/dp_mix.py:178",
        "launches": fleet_rec["launches"],
        "max_abs_err": raxis_rec["max_abs_err"],
        "ms": raxis_rec["ms"], "plain_ms": raxis_rec["plain_ms"],
        "bound_ms": raxis_rec["bound_ms"], "bound_by": raxis_rec["bound_by"],
        "separate_ms": raxis_rec["separate_ms"], "library_ms": None}, {
        "name": "dp_perturb", "route": "cuda",
        "source": "src/repro_torch/kernels/dp_perturb/csrc/dp_perturb.cu",
        "replaces": "src/repro/kernels/dp_perturb/dp_perturb.py:42",
        "launches": dyn_perturb_launches,
        "launches_by_path": {"tree, four schemes": perturb_launches,
                             "tree dynamic " + DYN_TREE_SCENARIO:
                                 dyn_perturb_launches},
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
    raise SystemExit(main())
