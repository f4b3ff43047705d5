"""Time dp_mix's round on the card in turns across source trees.

    python3 scripts/port_dp_mix_turns.py [--shapes 1x64,1x2048,4x64]
        [--sparse 2048] [--out FILE] TREE [TREE ...]

Each TREE is a checkout of the repo (``.``, or a ``git archive`` of a
commit unpacked into a directory): its own ``src/repro_torch`` and
``chip_smoke.py``. Every tree's dp_mix library is built first, all nvcc
processes at once. Then two turns run the trees one after another, the
second in reverse order (A B, B A), each in a process of its
own that times its own ``ops._launch`` by its own ``chip_smoke.cuda_ms``
on its own chip_smoke's operands: ``dp_mix_args`` (float32, noisy, at
the flat path's d, a realized channel's plan) for R = 1, and
``fleet_operands`` for a replicate axis of R rounds, where the tree has
it (else that shape is left out for that tree). So a tree's reading is
what its own harness would read, and the trees' readings are taken on
one card in one call.

``--sparse N`` (0: none) adds the sparse round at N workers and the
flat path's d, float32, noisy, on each tree's own seeded
``chip_smoke.sparse_round`` list (mesh_sparse, k = SPARSE_K) and
operands, in the same turns: the round (``ops._launch_sparse``; in a
tree whose wrapper has ``locality_order``, with the list's key's order
and again in index order), the prep alone and the gather alone, each by
its own ``cuda_ms``, and a digest of the round's output bits, so that
two builds are shown to give the same output bitwise.

Printed: one JSON line a tree and shape with its times in turns and the
least of them, then the card's name and power limit as nvidia-smi gives
them; ``--out`` also writes the records as one JSON file. Needs a card.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# run in each tree's own directory, its src first on the path
_CHILD = r"""
import json, sys
import torch
import chip_smoke as c
from repro_torch.kernels.dp_mix import ops
for R, N in json.loads(sys.argv[1]):
    if R == 1:
        _, _, args, kw = c.dp_mix_args(N, c.PATH_D, torch.float32, True)
    elif hasattr(c, "fleet_operands"):
        _, args, kw = c.fleet_operands(R, N, c.PATH_D, torch.float32)
    else:
        continue
    run = lambda: ops._launch(*args, **kw)
    iters = 20 if R * N <= 64 else (5 if R * N <= 256 else 2)
    ms = c.cuda_ms(run, iters=iters, warmup=1)
    print("[turn] " + json.dumps({"R": R, "N": N, "d": c.PATH_D, "ms": ms}),
          flush=True)
    del args, run
    torch.cuda.empty_cache()
"""

# the sparse round at N = argv[1], in its tree's own harness
_SPARSE_CHILD = r"""
import json, sys
import torch
import chip_smoke as c
from repro_torch.kernels.dp_mix import ops


def digest(t):
    bits, h = t.contiguous().view(-1).view(torch.int32), 0
    for part in bits.split(1 << 26):
        x = part.long()
        w = torch.arange(x.numel(), device=x.device) % 65521 + 1
        h = (h * 1000003 + int((x * w).sum())) % (1 << 61)
    return format(h, "016x")


N = int(sys.argv[1])
proto, plan, _, W = c.sparse_round(N)
gen = torch.Generator(device="cuda").manual_seed(5)
p = torch.randn((N, c.PATH_D), generator=gen, device="cuda")
g = 0.1 * torch.randn((N, c.PATH_D), generator=gen, device="cuda")
args = c.sparse_args(plan, p, g)
kw = dict(gamma=proto.gamma, eta=proto.eta, noisy=True,
          counter_width=ops._roundup(c.PATH_D, ops.LANES))
keyed = ({"order": ops.locality_order(W, N, "cuda")}
         if hasattr(ops, "locality_order") and W.key is not None else {})
rec = {"N": N, "d": c.PATH_D, "k": W.k, "keyed": bool(keyed)}
out = ops._launch_sparse(*args, **kw, **keyed)
rec["digest"] = digest(out)
if keyed:
    rec["index_digest"] = digest(ops._launch_sparse(*args, **kw))
del out
torch.cuda.empty_cache()
rec["round_ms"] = c.cuda_ms(lambda: ops._launch_sparse(*args, **kw, **keyed),
                            iters=3, warmup=1)
if keyed:
    rec["index_round_ms"] = c.cuda_ms(lambda: ops._launch_sparse(*args, **kw),
                                      iters=3, warmup=1)
prep = lambda: ops._launch_prep(p, g, *args[2:6], gamma=proto.gamma,
                                noisy=True, counter_width=kw["counter_width"],
                                row0=0)
rec["prep_ms"] = c.cuda_ms(prep, iters=3, warmup=1)
ws = prep()
rec["gather_ms"] = c.cuda_ms(lambda: ops._launch_gather(
    p, g, ws, ws[0], *args[2:], row0=0, **kw, **keyed), iters=3, warmup=1)
print("[sparse] " + json.dumps(rec), flush=True)
"""

_BUILD = ("from repro_torch.kernels import build; "
          "from repro_torch.kernels.dp_mix import ops; "
          "build.build_all([ops.LIBRARY])")


def _env(tree: Path) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(tree / "src"), str(tree)] + ([env["PYTHONPATH"]]
                                          if env.get("PYTHONPATH") else []))
    return env


def build_all(trees) -> None:
    """Every tree's dp_mix library, all builds at once (no card needed)."""
    procs = [(t, subprocess.Popen([sys.executable, "-c", _BUILD], cwd=t,
                                  env=_env(t), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for t in trees]
    for tree, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{tree}: dp_mix did not build:\n{out}")


def time_tree(tree: Path, shapes) -> dict:
    """{(R, N): its record} from one process in ``tree``."""
    res = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(shapes)],
                         cwd=tree, env=_env(tree), capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise SystemExit(f"{tree}: timing failed:\n{res.stdout}{res.stderr}")
    recs = [json.loads(line[len("[turn] "):])
            for line in res.stdout.splitlines() if line.startswith("[turn] ")]
    return {(r["R"], r["N"]): r for r in recs}


def time_sparse(tree: Path, N: int) -> dict:
    """The sparse round's record at N workers from one process in
    ``tree`` (its times, its output's digest)."""
    res = subprocess.run([sys.executable, "-c", _SPARSE_CHILD, str(N)],
                         cwd=tree, env=_env(tree), capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise SystemExit(f"{tree}: sparse timing failed:\n{res.stdout}"
                         f"{res.stderr}")
    line = [x for x in res.stdout.splitlines() if x.startswith("[sparse] ")]
    return json.loads(line[-1][len("[sparse] "):])


def sparse_turns(trees, N: int, n_turns: int = 2) -> list:
    """The sparse round of each tree ``n_turns`` times, the order reversed
    every other turn: one record a tree, each time in turns and the least
    of them, the output's digest of every turn."""
    recs = {str(t): [] for t in trees}
    for k in range(n_turns):
        for tree in (trees if k % 2 == 0 else trees[::-1]):
            recs[str(tree)].append(time_sparse(tree, N))
    out = []
    for tree, rs in recs.items():
        rec = {"tree": tree, "sparse": True, "N": N, "d": rs[0]["d"],
               "k": rs[0]["k"], "keyed": rs[0]["keyed"],
               "digests": sorted({r["digest"] for r in rs}
                                 | {r["index_digest"] for r in rs
                                    if "index_digest" in r})}
        for m in ("round_ms", "index_round_ms", "prep_ms", "gather_ms"):
            v = [r[m] for r in rs if m in r]
            if v:
                rec[m + "_in_turns"], rec[m] = v, min(v)
        out.append(rec)
    return out


def turns(trees, shapes, n_turns: int = 2) -> list:
    """Each tree timed ``n_turns`` times, the order reversed every other
    turn; one record a tree and shape."""
    ms = {(str(t), tuple(s)): [] for t in trees for s in shapes}
    d = {}
    for k in range(n_turns):
        for tree in (trees if k % 2 == 0 else trees[::-1]):
            for key, rec in time_tree(tree, shapes).items():
                ms[(str(tree), key)].append(rec["ms"])
                d[key] = rec["d"]
    return [{"tree": tree, "R": R, "N": N, "d": d[(R, N)],
             "ms_in_turns": v, "ms": min(v)}
            for (tree, (R, N)), v in ms.items() if v]


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return res.stdout.strip() or f"nvidia-smi failed: {res.stderr.strip()}"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--shapes", default="1x64,1x128,1x256,1x2048,4x64",
                    help="RxN, comma-separated")
    ap.add_argument("--sparse", type=int, default=0,
                    help="the sparse round at this N too (0: none)")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    trees = [t.resolve() for t in args.trees]
    for t in trees:
        if not (t / "chip_smoke.py").is_file() or not (
                t / "src" / "repro_torch" / "kernels" / "dp_mix").is_dir():
            raise SystemExit(f"{t}: not a checkout with chip_smoke.py and "
                             f"src/repro_torch/kernels/dp_mix")
    shapes = [[int(v) for v in s.split("x")]
              for s in args.shapes.split(",") if s]
    build_all(trees)
    recs = turns(trees, shapes)
    if args.sparse:
        recs += sparse_turns(trees, args.sparse)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    card = nvidia_smi()
    print(card, flush=True)
    result = {"card": card, "records": recs}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
