"""Render the dry run's and the roofline's tables from the PyTorch port's
dry-run records (the reference's ``scripts/roofline_report.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes --jobs 4
    PYTHONPATH=src python scripts/port_roofline_report.py [singlepod|multipod] [--dir build/dryrun]

One markdown row a record that ``launch/dryrun.py`` wrote
(<arch>__<shape>__<pod>.json): its kind, parameters, the seconds its
count took on the meta device, the arguments a device holds under the
sharding rules and whether they fit an H100's 80 GB, the three roofline
terms over the mesh's chips at the H100's peaks (the collective term is
not measured on meta: "-"), the dominant term, the useful-FLOP ratio,
the MFU bound and a one-line next step. A failed pair's row says FAIL
with its error.
"""
import argparse
import glob
import json
import os

ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(out_dir: str = "build/dryrun", pod: str = "singlepod") -> dict:
    recs = {}
    for f in glob.glob(os.path.join(out_dir, f"*__{pod}.json")):
        with open(f) as fh:
            r = json.load(fh)
        recs[(r["arch"], r["shape"])] = r
    return recs


def fixnote(rec: dict) -> str:
    dom = rec["roofline"]["dominant"]
    if dom == "collective":
        return "sequence parallelism / overlap to cut the all-reduces"
    if dom == "memory":
        if rec["shape"] in ("decode_32k", "long_500k"):
            return "KV/state layout + fused decode kernels"
        return "fuse elementwise chains; cut fp32 upcasts"
    return "larger per-card tiles / batch for the tensor cores"


def _s(v) -> str:
    return "-" if v is None else f"{v:.2e}"


def render(recs: dict) -> list:
    """The table's lines, archs sorted, shapes in ORDER."""
    lines = ["| arch | shape | kind | params | count s | args GB/device | "
             "fits 80G | compute s | memory s | collective s | dominant | "
             "useful-FLOP ratio | MFU bound | one-line fix |",
             "|" + "---|" * 14]
    for a in sorted({a for a, _ in recs}):
        for s in ORDER:
            rec = recs.get((a, s))
            if rec is None:
                continue
            if not rec.get("ok"):
                lines.append(f"| {a} | {s} | - | - | - | - | - | - | - | - | "
                             f"FAIL | - | - | {rec.get('error', '')[:60]} |")
                continue
            r, m = rec["roofline"], rec["memory"]
            ufr = r["useful_flop_ratio"] or 0.0
            mfu = r["mfu_bound"] or 0.0
            lines.append(
                f"| {a} | {s} | {rec['kind']} | {rec['n_params'] / 1e9:.2f}B "
                f"| {rec['run_s']:.0f} | {m['per_device_gb']:.1f} | "
                f"{'Y' if m['arguments_fit_h100_80gb'] else 'N'} | "
                f"{_s(r['compute_s'])} | {_s(r['memory_s'])} | "
                f"{_s(r['collective_s'])} | **{r['dominant']}** | "
                f"{ufr:.2f} | {mfu * 100:.1f}% | {fixnote(rec)} |")
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("pod", nargs="?", default="singlepod",
                    choices=["singlepod", "multipod"])
    ap.add_argument("--dir", default="build/dryrun")
    args = ap.parse_args(argv)
    lines = render(load(args.dir, args.pod))
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
