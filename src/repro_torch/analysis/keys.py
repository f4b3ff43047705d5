"""Key discipline — the DP-critical check (the reference's
``repro.analysis.keys``, on counters instead of jaxpr keys).

Theorem 4.1's (epsilon, delta) guarantee prices ONE Gaussian draw per
worker per round. The port draws its noise from a counter hash: a
normal is ``hash(counter, seed)``, so two draws that hash one counter
under one seed are the same normal, and the accountant's independence
assumption is silently void. This check proves, on a recorded run, that
no counter is hashed twice under one seed.

The draws are every kernel call's (``utils.trace.Draw``: dp_mix's dense
and sparse rounds, their row-window halves, dp_perturb) and every plain
draw of ``kernels.noise`` outside a kernel. A dp_mix draw over rows
[row0, row0 + rows) and columns [col0, col0 + cols) of a buffer with row
stride ``counter_width`` hashes the counters

    2 ((row0 + r) counter_width + col0 + c) + field

(field 0 the DP noise, 1 the channel's AWGN); a dp_perturb draw of n
elements hashes e + 32768 (e >> 15) + seed 0x9E3779B9 and that plus
32768 (mod 2^32). The seeds are read after the run, never inside it.
Every draw of a run (the rounds of each chunk, the fleet's replicates,
both chunks) is held against every other under the same seed: an
overlap is an ERROR, so the S column windows and the row windows of a
round must tile without overlap, and two rounds, or two replicates, may
not draw under one seed (each starts its counters at 0). Columns of a
window past the counter stride are the sharded buffer's padding, which
the round sets to zero (``shard.round.shard_window_round``): their
counters, the next row's, are left out and reported as INFO.

The worker-tree exchange draws its noise from the carry's
``torch.Generator`` instead (``core.exchange.draw_normals``); the
recorder keeps each such draw's seed and the generator's state before
it (``utils.trace.StreamDraw``). Two draws that start from one state
draw the same numbers: a generator re-seeded or restored inside the run
is an ERROR. A program that draws no noise at all is a WARNING: the
check then has nothing to hold.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from repro_torch.analysis.findings import Finding, Severity

CHECKER = "key-discipline"

_MASK = (1 << 32) - 1
_GOLDEN = 0x9E3779B9
_TILE = 32768


def _int(v, index=None) -> int:
    if isinstance(v, torch.Tensor):
        flat = v.detach().reshape(-1).cpu()
        return int(flat[0 if index is None else index])
    return int(v)


def _u32(v) -> int:
    return int(v) & _MASK


def _split(lo: int, hi: int, parity) -> List[Tuple[int, int, object]]:
    """[lo, hi) mod 2^32 as at most two intervals."""
    length = hi - lo
    lo &= _MASK
    if lo + length <= (1 << 32):
        return [(lo, lo + length, parity)]
    return [(lo, 1 << 32, parity), (0, lo + length - (1 << 32), parity)]


def draw_intervals(draw) -> List[Tuple[int, int, object]]:
    """The hash inputs of one draw: [(lo, hi, parity)], half-open; parity
    0 or 1 for a dp_mix field (its counters step by 2), None for a
    contiguous range."""
    if draw.kind == "perturb":
        base = (_u32(_int(draw.seed)) * _GOLDEN) & _MASK
        full, rest = divmod(int(draw.numel), _TILE)
        out = []
        if full:
            out += _split(base, base + 2 * _TILE * full, None)
        if rest:
            t0 = base + 2 * _TILE * full
            out += _split(t0, t0 + rest, None)
            out += _split(t0 + _TILE, t0 + _TILE + rest, None)
        return out
    cw, col0 = int(draw.counter_width), _int(draw.col0)
    cols = max(0, min(col0 + int(draw.cols), cw) - col0)
    out = []
    for r in range(int(draw.rows)):
        start = (int(draw.row0) + r) * cw + col0
        for f in draw.fields:
            out += _split(2 * start + f, 2 * (start + cols) + f, f)
    return out


def _overlaps(a, b) -> bool:
    """Do two draws' interval lists share a hash input? Compared one
    parity at a time, where each list's intervals are disjoint."""
    for p in (0, 1):
        A = sorted(iv[:2] for iv in a if iv[2] in (p, None))
        B = sorted(iv[:2] for iv in b if iv[2] in (p, None))
        i = j = 0
        while i < len(A) and j < len(B):
            if A[i][0] < B[j][1] and B[j][0] < A[i][1]:
                return True
            if A[i][1] <= B[j][1]:
                i += 1
            else:
                j += 1
    return False


def _where(call: Dict) -> str:
    return (f"chunk {call['chunk']}, round {call['round']}, "
            f"{call['name']}" + (f" replicate {call['replicate']}"
                                 if call["replicate"] is not None else ""))


def collect_draws(run) -> List[Dict]:
    """Every draw of a ``registry.ProgramRun`` with its seed read and its
    place (chunk, round, kernel call)."""
    out = []
    for ci, chunk in enumerate(run.chunks):
        starts = chunk.round_index
        for rec in chunk.recorder.kernels:
            rnd = sum(1 for s in starts if s <= rec.index) - 1
            for d in rec.draws:
                out.append({"chunk": ci, "round": rnd, "name": rec.name,
                            "replicate": d.replicate, "draw": d,
                            "seed": _u32(_int(d.seed, d.replicate))})
    return out


def collect_stream_draws(run) -> List[Dict]:
    """Every generator draw of a ``registry.ProgramRun`` with its place."""
    out = []
    for ci, chunk in enumerate(run.chunks):
        starts = chunk.round_index
        for s in chunk.recorder.streams:
            rnd = sum(1 for i in starts if i <= s.index) - 1
            out.append({"chunk": ci, "round": rnd, "name": s.op,
                        "replicate": None, "stream": s})
    return out


def _check_streams(streams: List[Dict], program: str) -> List[Finding]:
    by_state: Dict[Tuple[int, bytes], List[Dict]] = defaultdict(list)
    for d in streams:
        by_state[(d["stream"].seed, d["stream"].state)].append(d)
    findings = []
    for (seed, _), group in by_state.items():
        for b in group[1:]:
            a = group[0]
            findings.append(Finding(
                CHECKER, Severity.ERROR, program,
                f"two generator draws start from the same state under seed "
                f"{seed}: the same normals twice, which voids the "
                f"independent-noise assumption of Thm 4.1",
                where=f"{_where(a)} / {_where(b)}",
                detail={"seed": seed, "first": _where(a),
                        "second": _where(b)}))
    return findings


def check_key_discipline(run, program: str = "") -> List[Finding]:
    program = program or run.name
    findings: List[Finding] = []
    draws = collect_draws(run)
    streams = collect_stream_draws(run)
    findings += _check_streams(streams, program)
    by_seed: Dict[int, List[Dict]] = defaultdict(list)
    for d in draws:
        dr = d["draw"]
        if dr.kind == "mix" and _int(dr.col0) + int(dr.cols) > int(
                dr.counter_width):
            findings.append(Finding(
                CHECKER, Severity.INFO, program,
                f"column window [{_int(dr.col0)}, {_int(dr.col0) + dr.cols})"
                f" passes the counter stride {dr.counter_width}: the "
                f"columns past it are the sharded buffer's padding, set to "
                f"zero after the round, and their counters are left out",
                where=_where(d)))
        d["intervals"] = draw_intervals(dr)
        by_seed[d["seed"]].append(d)
    for seed, group in by_seed.items():
        for i in range(len(group)):
            for j in range(i + 1, len(group)):
                a, b = group[i], group[j]
                if not _overlaps(a["intervals"], b["intervals"]):
                    continue
                findings.append(Finding(
                    CHECKER, Severity.ERROR, program,
                    f"two noise draws hash the same counters under seed "
                    f"{seed}: the same normals twice, which voids the "
                    f"independent-noise assumption of Thm 4.1",
                    where=f"{_where(a)} / {_where(b)}",
                    detail={"seed": seed, "first": _where(a),
                            "second": _where(b)}))
    n_calls = sum(len(c.recorder.kernels) for c in run.chunks)
    if not draws and not streams:
        findings.append(Finding(
            CHECKER, Severity.WARNING, program,
            "no noise draw recorded: neither a counter-hash draw nor a "
            "generator draw, so the check holds nothing"))
    findings.append(Finding(
        CHECKER, Severity.INFO, program,
        f"{len(draws)} counter-hash draws in {n_calls} kernel calls under "
        f"{len(by_seed)} distinct seeds; {len(streams)} generator draws",
        detail={"draws": len(draws), "seeds": len(by_seed),
                "generator_draws": len(streams),
                "ranges": counter_ranges(draws)}))
    return findings


def counter_ranges(draws: List[Dict]) -> List[Dict]:
    """Each draw's seed and the first and last counter it hashes (a
    field's interval [lo, hi) steps by 2, so its last counter is hi - 2)."""
    out = []
    for d in draws:
        iv = d.get("intervals") or draw_intervals(d["draw"])
        out.append({"where": _where(d), "seed": d["seed"],
                    "first": min(v[0] for v in iv) if iv else None,
                    "last": max(v[1] - (1 if v[2] is None else 2)
                                for v in iv) if iv else None})
    return out
