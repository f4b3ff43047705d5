"""Hill-climb helper on the PyTorch port: count one (arch, shape) pair's
step on the meta device (``launch.dryrun``), print its three roofline
terms (``utils.roofline`` over ``utils.op_cost``) and its top collectives
(``utils.trace.Recorder``), and store the record as JSON (the
reference's ``scripts/perf_iter.py``).

    PYTHONPATH=src python scripts/port_perf_iter.py qwen2-72b train_4k iter1 [--top]

The step is counted as the dry run counts it (a train round by its exact
fit over W, a recurrent prefill by its fit over S), on the production
mesh's chips at the H100's peaks. The meta device issues no collective:
the collective term is null and ``--top``'s collectives list the
recorder's (none on meta); ``--top`` also lists the step's largest ops by
bytes, from one recorded run of the case (of its fit's first point when
it is counted by a fit). The record goes to ``--out`` (default
bench_out/perf/<arch>__<shape>__<tag>.json).
"""
import argparse
import json
import os
import time

from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.specs import build_case
from repro_torch.utils import roofline as rl
from repro_torch.utils.trace import Recorder


def top_rows(arch, shape, case, n: int = 12) -> dict:
    """The largest ops by bytes and the collectives of one recorded run:
    the case itself, or its fit's first point."""
    points, kind = D.tasks(case)
    w, s = points[0]
    run = case if kind == "direct" else build_case(
        arch, shape, case.mesh, "meta", workers=w, seq_len=s)
    with Recorder(keep_ops=True) as rec:
        run.fn(*run.args)
    ops = sorted(rec.ops, key=lambda o: o.nbytes, reverse=True)[:n]
    colls = sorted(rec.collectives, key=lambda c: c.raw_bytes,
                   reverse=True)[:n]
    return {"run": "direct" if kind == "direct" else
            {"workers": w, "seq_len": s},
            "ops": [{"bytes": o.nbytes, "op": o.name,
                     "out_shapes": [list(t) for t in o.out_shapes]}
                    for o in ops],
            "collectives": [{"bytes": c.raw_bytes, "op": c.op,
                             "group_size": c.group_size} for c in colls]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("tag")
    ap.add_argument("--top", action="store_true")
    ap.add_argument("--out", default="bench_out/perf")
    args = ap.parse_args(argv)

    t0 = time.time()
    mesh = mesh_lib.production_mesh_shape()
    case = build_case(args.arch, args.shape, mesh, "meta")
    cost, peak, how = D.count_case(case, args.arch, args.shape, False, "meta")
    chips = mesh_lib.n_chips(mesh)
    roof = rl.from_cost(case.name, cost, model_flops=case.model_flops,
                        n_chips=chips, peak="bf16", collectives=False)
    per_dev = case.per_device_argument_bytes()
    rec = {"arch": args.arch, "shape": args.shape, "tag": args.tag,
           "n_chips": chips, "counted": how,
           "argument_gb_per_device": per_dev / 1e9,
           "peak_live_bytes": peak, "op_cost": cost.as_dict(),
           "roofline": roof.as_dict(),
           "collectives": {"counts": cost.collective_counts,
                           "raw_bytes": cost.collective_raw,
                           "link_bytes": cost.link_bytes}}
    if args.top:
        rec["top"] = top_rows(args.arch, args.shape, case)
    rec["seconds"] = time.time() - t0
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.arch}__{args.shape}__{args.tag}"
                                  f".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)

    r = roof
    coll = "null (no collective on meta)" if r.collective_s is None \
        else f"{r.collective_s:.3e}s"
    print(f"{args.arch} {args.shape} [{args.tag}]  "
          f"args={per_dev / 1e9:.1f}GB/device  counted={how['how']}")
    print(f"  compute={r.compute_s:.3e}s memory={r.memory_s:.3e}s "
          f"collective={coll} dom={r.dominant} "
          f"mfu_bound={100 * (r.mfu_bound or 0):.2f}%")
    print(f"  colls: { {k: f'{v / 1e9:.0f}GB' for k, v in cost.collective_raw.items()} }")
    if args.top:
        top = rec["top"]
        for c in top["collectives"]:
            print(f"  {c['bytes'] / 1e9:8.1f}GB {c['op']:22s} "
                  f"group {c['group_size']}")
        if not top["collectives"]:
            print("  no collective recorded (the meta device issues none)")
        for o in top["ops"]:
            print(f"  {o['bytes'] / 1e9:8.3f}GB {o['op'][:40]:40s} "
                  f"{str(o['out_shapes'])[:60]}")
    print(f"  -> {path}")
    return rec


if __name__ == "__main__":
    main()
