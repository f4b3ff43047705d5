"""Dry run: every (architecture x input shape) on the production mesh, on
the meta device (the reference's ``repro.launch.dryrun``, which lowers
and compiles each case for a TPU pod).

    python -m repro_torch.launch.dryrun                  # all pairs, one pod
    python -m repro_torch.launch.dryrun --multi-pod      # the two-pod mesh
    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    python -m repro_torch.launch.dryrun --both-meshes --jobs 4

Each case's step (``launch.specs.build_case``) runs once on the meta
device inside a ``utils.trace.Recorder``: every aten op and kernel call
is counted (``utils.op_cost``) and nothing is computed or allocated. Per
pair it writes one JSON record: the cost, its roofline over the mesh's
chips (``utils.roofline``; per chip = the whole step's count over the
chips, as an even SPMD split would give it), the memory — the arguments'
bytes on one device under the sharding rules (``launch.shardings``), the
recorder's peak of live bytes (the whole step on one device) and
``arguments_fit_h100_80gb``: whether the per-device arguments alone fit
80 GB. That is not the reference's ``fits_*``, which adds the outputs
and the temporaries a device holds: no per-device peak is measured here
(the recorder's is the unsharded step's, and a fitted pair has none) —
and ``ok``, or the error. No collective is issued on meta, so ``collective_s`` is null with
the reason. The exit code and the OK / SKIP / FAIL lines are the
reference's. ``--jobs`` runs the pairs in that many processes.

A pointwise op on meta tensors costs ~200 us through PyTorch's Python
reference implementations; the recorder infers the commonest ones itself
(``utils.trace``), which gives the same outputs. Even so an op costs
~50-100 us on meta, and some steps issue tens of millions: a train round
runs its W workers' passes one after another (W = 16 or 32), and
xlstm-1.3b's sLSTM is a Python loop over the sequence. So the cost of
those steps is counted the way the reference's ``hlo_cost`` counts a
``while`` loop, once a body and scaled, here exactly: a train round's
count is a polynomial in W, c0 + c1 W + c2 W^2 (the workers' passes are
W identical passes, the exchange's mix is W x W), and with a per-step
recurrence also + c3 W S + c4 W S^2 (its passes' ops are affine in S;
the backward of a step's ``x[:, t]`` writes a zero gradient of the whole
[B, S, ...] input, so its bytes grow as S^2); a recurrent prefill's is
c0 + c1 S. The step runs at the points of ``FIT`` (the
mesh's batch a worker, every other shape the case's), the coefficients
are solved in exact rational arithmetic, and the record gives the count
at the case's W and S with ``counted`` saying how; its peak of live
bytes is then not measured. Every other case runs once, whole.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from fractions import Fraction

from repro_torch.configs.registry import ASSIGNED, SHAPE_SKIPS, SHAPES

H100_BYTES = 80 * 10 ** 9


# the fits' points: train (W, S=None: the case's) and with a per-step
# recurrence (W, S); a recurrent prefill's S. A recurrence's S points hold
# two chunks or more (one chunk takes a shorter path)
FIT = {"train": [(2, None), (3, None), (4, None)],
       "train-loop": [(2, 256), (3, 256), (4, 256), (2, 384), (2, 512)],
       "prefill-loop": [(None, 256), (None, 384)]}


def fit_kind(case) -> str:
    """"direct", or the FIT entry a case is counted by."""
    loop = bool(case.cfg.slstm_every)
    if case.kind == "train":
        return "train-loop" if loop else "train"
    return "prefill-loop" if case.kind == "prefill" and loop else "direct"


def _basis(kind: str, W: int, S: int):
    if kind == "train":
        return [1, W, W * W]
    if kind == "train-loop":
        return [1, W, W * W, W * S, W * S * S]
    return [1, S]


def _solve(rows, rhs):
    """x with rows x = rhs, in exact rational arithmetic."""
    n = len(rows)
    a = [[Fraction(v) for v in r] + [Fraction(b)] for r, b in zip(rows, rhs)]
    for c in range(n):
        piv = next(r for r in range(c, n) if a[r][c] != 0)
        a[c], a[piv] = a[piv], a[c]
        for r in range(n):
            if r != c and a[r][c] != 0:
                f = a[r][c] / a[c][c]
                a[r] = [x - f * y for x, y in zip(a[r], a[c])]
    return [a[i][n] / a[i][i] for i in range(n)]


def _fields(cost) -> dict:
    """A Cost's numeric fields, flattened: {name: number}."""
    out = {}
    for k, v in cost.as_dict().items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in v.items()})
        elif k != "flops":
            out[k] = v
    return out


def _cost_of(fields: dict):
    from repro_torch.utils.op_cost import Cost
    out = Cost()
    for k, v in fields.items():
        if "/" in k:
            name, sub = k.split("/", 1)
            getattr(out, name)[sub] = v
        else:
            setattr(out, k, v)
    return out


def _extrapolate(fields, rows, target) -> dict:
    """The fields at ``target`` (a basis row) from those at ``rows``."""
    out = {}
    for k in sorted(set().union(*fields)):
        coef = _solve(rows, [f.get(k, 0) for f in fields])
        v = sum(c * t for c, t in zip(coef, target))
        out[k] = int(v) if v.denominator == 1 else float(v)
    return out


def tasks(case):
    """The steps to count for ``case``: [(workers, seq_len)], (None,
    None) for the case itself; and its fit kind."""
    kind = fit_kind(case)
    return ([(None, None)] if kind == "direct" else FIT[kind]), kind


def count_task(arch: str, shape: str, multi_pod: bool, device: str,
               workers=None, seq_len=None, overrides=None,
               mesh=None) -> dict:
    """One step counted (on ``mesh``, default the production mesh):
    {"fields": the Cost's fields, "peak": live bytes' peak, "seconds"}."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.specs import build_case
    t0 = time.time()
    if mesh is None:
        mesh = mesh_lib.production_mesh_shape(multi_pod)
    case = build_case(arch, shape, mesh, device, multi_pod=multi_pod,
                      overrides=overrides, workers=workers, seq_len=seq_len)
    return dict(_count_built(case), seconds=time.time() - t0)


def assemble(case, kind: str, points, counted: list):
    """(Cost, peak or None, how) of ``case`` from its tasks' counts."""
    if kind == "direct":
        return (_cost_of(counted[0]["fields"]), counted[0]["peak"],
                {"how": "direct"})
    W = (len(next(iter(case.args[1].values())))
         if case.kind == "train" else 1)
    S = case.seq_len
    rows = [_basis(kind, w or W, s or S) for w, s in points]
    fields = _extrapolate([c["fields"] for c in counted], rows,
                          _basis(kind, W, S))
    return (_cost_of(fields), None,
            {"how": "fit", "basis": kind, "points": points,
             "at": {"W": W, "S": S}})


def count_case(case, arch: str, shape: str, multi_pod: bool, device: str,
               overrides=None):
    """(Cost, peak live bytes or None, how it was counted) of a case
    (built with ``overrides``, as ``specs.build_case`` takes them), its
    tasks run here one after another."""
    points, kind = tasks(case)
    if kind == "direct":
        counted = [_count_built(case)]
    else:
        counted = [count_task(arch, shape, multi_pod, device, w, s,
                              overrides, case.mesh)
                   for w, s in points]
    return assemble(case, kind, points, counted)


def _count_built(case) -> dict:
    """A built case's step run once under a recorder: {"fields", "peak"}."""
    from repro_torch.utils.trace import Recorder
    with Recorder(keep_ops=False) as r:
        r.track(case.args)
        case.fn(*case.args)
    return {"fields": _fields(r.cost), "peak": r.peak_bytes}


def record(arch: str, shape: str, multi_pod: bool, device: str, case,
           kind: str, points, counted, seconds: float, out_dir: str) -> dict:
    """One pair's JSON record (written to ``out_dir``)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.utils import roofline as rl
    chips = mesh_lib.n_chips(case.mesh)
    rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
           "n_chips": chips, "device": device}
    cost, peak, how = assemble(case, kind, points, counted)
    roof = rl.from_cost(case.name, cost, model_flops=case.model_flops,
                        n_chips=chips, peak="bf16",
                        collectives=device != "meta")
    per_dev = case.per_device_argument_bytes()
    rec.update({
        "ok": True, "kind": case.kind, "n_params": case.n_params,
        "tokens": case.tokens, "run_s": round(seconds, 2), "counted": how,
        "task_s": [round(c.get("seconds", 0.0), 2) for c in counted],
        "memory": {
            "argument_bytes": case.argument_bytes(),
            "argument_bytes_per_device": per_dev,
            "peak_live_bytes": peak,
            "peak_note": "" if peak is not None else
            "not measured: counted by a fit over smaller steps",
            "per_device_gb": round(per_dev / 1e9, 3),
            "arguments_fit_h100_80gb": bool(per_dev <= H100_BYTES),
        },
        "op_cost": cost.as_dict(),
        "roofline": roof.as_dict(),
    })
    return _write(rec, out_dir)


def _write(rec: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    pod = "multipod" if rec["multi_pod"] else "singlepod"
    with open(os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__"
                                    f"{pod}.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def _failure(arch, shape, multi_pod, device, e) -> dict:
    return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
            "device": device, "ok": False,
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:]}


def _line(rec: dict) -> str:
    a, s = rec["arch"], rec["shape"]
    pod = "2pod" if rec.get("multi_pod") else "1pod"
    if not rec.get("ok"):
        return f"FAIL  {a:22s} {s:12s} {pod} {rec['error']}"
    r, m = rec["roofline"], rec["memory"]
    return (f"OK    {a:22s} {s:12s} {pod} run={rec['run_s']:7.1f}s "
            f"mem={m['per_device_gb']:7.2f}GB "
            f"comp={r['compute_s']:.3e}s memT={r['memory_s']:.3e}s "
            f"coll=null dom={r['dominant']} wall={rec['wall_s']:.1f}s")


def _task(job):
    arch, shape, multi_pod, w, s = job
    try:
        return job, count_task(arch, shape, multi_pod, "meta", w, s)
    except Exception as e:  # noqa: BLE001
        return job, _failure(arch, shape, multi_pod, "meta", e)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="every pair on the single-pod and the two-pod mesh")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--include-skips", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="steps counted in this many processes at once")
    args = ap.parse_args(argv)
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.specs import build_case

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    t0 = time.time()
    results, pairs, jobs = [], [], []
    for mp_ in meshes:
        for a in archs:
            for s in shapes:
                if (a, s) in SHAPE_SKIPS and not args.include_skips:
                    print(f"SKIP  {a:22s} {s:12s} ({SHAPE_SKIPS[(a, s)]})",
                          flush=True)
                    results.append({"arch": a, "shape": s, "multi_pod": mp_,
                                    "skip": SHAPE_SKIPS[(a, s)]})
                    continue
                try:
                    case = build_case(a, s, mesh_lib.production_mesh_shape(
                        mp_), "meta", multi_pod=mp_)
                except Exception as e:  # noqa: BLE001
                    rec = _write(_failure(a, s, mp_, "meta", e), args.out)
                    print(_line(rec), flush=True)
                    results.append(rec)
                    continue
                points, kind = tasks(case)
                pairs.append((a, s, mp_, case, kind, points))
                jobs += [(a, s, mp_, w, q) for w, q in points]
    # the longest steps first, so the pool's last tasks are short ones
    order = sorted(jobs, key=lambda j: (j[3] or 0) * (j[4] or 1), reverse=True)
    done = {}
    if args.jobs > 1:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(args.jobs) as pool:
            for job, res in pool.imap_unordered(_task, order):
                done[job] = res
    else:
        for job in order:
            done[job] = _task(job)[1]
    for a, s, mp_, case, kind, points in pairs:
        counted = [done[(a, s, mp_, w, q)] for w, q in points]
        bad = next((c for c in counted if c.get("ok") is False), None)
        if bad is not None:
            rec = _write(bad, args.out)
        else:
            rec = record(a, s, mp_, "meta", case, kind, points, counted,
                         sum(c["seconds"] for c in counted), args.out)
        rec["wall_s"] = rec.get("run_s", 0.0)
        print(_line(rec), flush=True)
        results.append(rec)
    n_ok = sum(1 for r in results if r.get("ok"))
    n_skip = sum(1 for r in results if "skip" in r)
    n_fail = len(results) - n_ok - n_skip
    print(f"\n{n_ok} ok, {n_skip} designed skips, {n_fail} failures "
          f"({time.time() - t0:.1f}s)")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
