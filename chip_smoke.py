#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. device  — the card's name, count, and nvidia-smi's name and power limit;
2. build   — every CUDA kernel of the main path built from this checkout's
             sources with nvcc for sm_90a (all nvcc processes at once);
3. kernels — each kernel held against its plain PyTorch version on the
             card at the main path's shapes, with the tolerance stated
             below, then timed with CUDA events beside the plain version
             and the least time the card could take (bound_ms);
4. train   — the main path, ``python -m repro_torch.launch.train --arch
             dwfl-paper --flat-buffer`` at full width (N = 10 workers,
             batch 32, d = 855,050), 51 rounds; every loss finite and the
             kernel launched once per round; then one small round on the
             card against the same round on the CPU;
5. profile — the steady-state time of a full-width round, and under
             torch.profiler the device's busy share and the operators that
             take the device's and the host's time.

The last three lines of standard output are the kernels' JSON record,
the nvidia-smi line, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet; at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# float operations of one counter-hash normal in csrc/noise.cuh (both
# log1p branches and the polynomial, counting an FMA as 2), and of the
# rest of the round per element (x, n/c, z, self-correction, AWGN, out)
NORMAL_FLOPS = 84
ELEMENT_FLOPS = 11

PATH_N, PATH_D = 10, 855_050          # dwfl-paper, hidden 256


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


def check_dp_mix(N: int, d: int, dtype, noisy: bool, timed: bool) -> dict:
    """Kernel vs plain on the card. Tolerance: both sum N products in
    float32 in different orders, each within N * 2^-24 * sum_k |W_ik z_k|
    <= N * 2^-24 * max|z| of the exact sum (W is stochastic); with the few
    roundings around the sum, |kernel - plain| <= (N + 8) * 2^-23 * scale,
    scale = max|x| + max|n/c| + max|m_scale sigma_m Gm| (|G| <= 5.42 on
    the 24-bit lattice). The noise itself is the same operation sequence
    in both. A bfloat16 output may further land one bfloat16 step apart,
    2^-7 of its magnitude."""
    import torch
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.kernels.dp_mix.dp_mix import dp_mix_plain
    proto, plan, p, g = dp_mix_case(N, d, dtype, noisy, seed=N)
    seed, col0 = (torch.tensor([s], dtype=torch.int32, device="cuda")
                  for s in (1234567, 0))
    cw = ops._roundup(d, ops.LANES)
    c = plan.c.reshape(())
    scal = torch.stack([c, plan.sigma_m.reshape(())])
    ones = torch.ones(N, device="cuda")
    args = (p, g, seed, col0, scal, plan.amp, ones, plan.m_scale, ones,
            plan.W.contiguous())
    kw = dict(gamma=proto.gamma, eta=proto.eta, noisy=noisy,
              counter_width=cw)
    kernel = lambda: ops._launch(*args, **kw)
    plain = lambda: dp_mix_plain(*args, **kw)
    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    k32, r32 = out.float(), ref.float()
    if not torch.isfinite(k32).all():
        fail(f"dp_mix N={N} {dtype} noisy={noisy}: non-finite output")
    x = p.float() - proto.gamma * g.float()
    scale = float(x.abs().max())
    if noisy:
        scale += 5.42 * float((plan.amp / c).abs().max()
                              + (plan.m_scale * plan.sigma_m).abs().max())
    tol = (N + 8) * 2.0 ** -23 * scale
    err = (k32 - r32).abs()
    allowed = tol + (2.0 ** -7 * torch.maximum(k32.abs(), r32.abs())
                     if dtype == torch.bfloat16 else 0.0)
    max_err = float(err.max())
    bad = int((err > allowed).sum())
    rec = {"N": N, "d": d, "dtype": str(dtype).split(".")[-1],
           "noisy": noisy, "max_abs_err": max_err, "tol_f32": tol,
           "violations": bad}
    if timed:
        rec["ms"] = cuda_ms(kernel, iters=20)
        rec["plain_ms"] = cuda_ms(plain, iters=3, warmup=1)
        elem = p.element_size()
        nbytes = 3 * N * d * elem + (N * N + 4 * N + 4) * 4
        flops = 2 * N * N * d + N * d * (
            ELEMENT_FLOPS + (2 * NORMAL_FLOPS if noisy else 0))
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
        rec["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        rec["bytes"], rec["flops"] = nbytes, flops
    print(f"[kernels] dp_mix {json.dumps(rec)}", flush=True)
    if bad:
        fail(f"dp_mix N={N} {rec['dtype']} noisy={noisy}: {bad} elements "
             f"beyond tolerance (max err {max_err:.3g}, tol {tol:.3g})")
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


def profile_rounds(n_rounds: int = 20) -> dict:
    """Where a full-width round's time goes: the main path's round body
    (what ``launch.train`` runs per round, eval excluded) after a warm-up,
    timed by the host clock around ``n_rounds`` rounds ending in a
    synchronize, then the same number of rounds under torch.profiler for
    the device's busy share and the top operators by device and host
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    from repro_torch.data import (ClassificationStore, classification_dataset,
                                  dirichlet_partition)
    x, y = classification_dataset(20000, seed=0)
    store = ClassificationStore.build(
        x, y, dirichlet_partition(y, PATH_N, alpha=0.5, seed=0), 32, "cuda")
    proto = P.ProtocolConfig(n_workers=PATH_N, gamma=0.01, eta=0.4,
                             target_epsilon=1.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    wp = P.init_worker_params(gen, DWFL_PAPER, PATH_N, "cuda")
    spec = X.FlatSpec(wp)
    body = TJ.make_round_body(DWFL_PAPER, proto, store, spec, "cuda")
    carry = TJ.TrajCarry(gen, spec.flatten(wp))
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
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    device_us = sum(dev(e) for e in stats)
    rec = {"round_ms": round_ms, "rounds": n_rounds,
           "profiled_round_ms": wall_us / 1e3 / n_rounds,
           "device_busy_share": (device_us / wall_us if device_us > 0
                                 else "not measured"),
           "top_device_us_per_round": [
               (e.key, dev(e) / n_rounds) for e in
               sorted(stats, key=dev, reverse=True)[:8] if dev(e) > 0],
           "top_host_us_per_round": [
               (e.key, e.self_cpu_time_total / n_rounds) for e in
               sorted(stats, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:8]]}
    print(f"[profile] {json.dumps(rec)}", flush=True)
    if not torch.isfinite(carry.params).all():
        fail("profile: non-finite parameters")
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
    libs = [ops.LIBRARY]
    t0 = time.perf_counter()
    built = build.build_all(libs)
    print(f"[build] {json.dumps(built)} in {time.perf_counter() - t0:.1f}s "
          f"-> {build.BUILD_DIR}", flush=True)
    for lib in libs:
        for line in lib.log_path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib.name}: {line.strip()}", flush=True)

    # 3. kernels at the main path's shape, and at N = 64
    path_rec = None
    for N in (PATH_N, 64):
        for dtype in (torch.float32, torch.bfloat16):
            for noisy in (True, False):
                timed = N == PATH_N and dtype == torch.float32
                rec = check_dp_mix(N, PATH_D, dtype, noisy, timed)
                if timed and noisy:
                    path_rec = rec
                torch.cuda.empty_cache()

    # 4. the main path, counted
    from repro_torch.launch import train
    ops.dp_mix_round.launches = 0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    res = train.run(["--arch", "dwfl-paper", "--flat-buffer",
                     "--workers", str(PATH_N), "--batch-size", "32",
                     "--steps", "50", "--eval-every", "25",
                     "--device", "cuda"])
    launches = ops.dp_mix_round.launches
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    rounds = res["rounds"]
    print(f"[train] {rounds} rounds in {res['seconds']:.3f}s = "
          f"{rounds / res['seconds']:.2f} rounds/s; peak device memory "
          f"{peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB held before the "
          f"run); dp_mix launches {launches}; first/last "
          f"loss {float(losses[0]):.4f}/{float(losses[-1]):.4f}", flush=True)
    if losses.numel() != rounds or not torch.isfinite(losses).all():
        fail(f"train: expected {rounds} finite losses, got {losses.tolist()}")
    if launches != rounds:
        fail(f"train: dp_mix launched {launches} times for {rounds} rounds")
    if not torch.isfinite(res["params"]).all():
        fail("train: non-finite parameters")
    train_step_cpu_vs_cuda()
    profile_rounds()

    print(json.dumps({"kernels": [{
        "name": "dp_mix", "route": "cuda",
        "source": "src/repro_torch/kernels/dp_mix/csrc/dp_mix.cu",
        "replaces": "src/repro/kernels/dp_mix/dp_mix.py:178",
        "launches": launches,
        "max_abs_err": path_rec["max_abs_err"],
        "max_err": path_rec["max_abs_err"],
        "ms": path_rec["ms"], "kernel_ms": path_rec["ms"],
        "plain_ms": path_rec["plain_ms"],
        "bound_ms": path_rec["bound_ms"], "bound_by": path_rec["bound_by"],
        "library_ms": None}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
