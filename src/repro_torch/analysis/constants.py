"""Weak closure — a dynamic program feeds each round its own channel
(the reference's ``repro.analysis.constants``, on the mixing operands
each round hands over).

The MixPlan contract says the channel and mixing quantities of the
dynamic paths are operands of the round: one round body serves every
realization. A refactor that closes over a realized ``chan`` or ``W``
(a snapshot captured when the body was built) still runs and gives
plausible numbers, but replays one realization forever. The check reads
what each round handed to dp_mix (its W, dense or the neighbor list's
weights, and the per-worker noise amplitudes; on the worker-tree path,
the round's own ``W`` and channel outputs) over the run's rounds, after the run. On a dynamic program,
operands that never change across the run's rounds (two chunks, longer
than a coherence block) are a frozen realization: an ERROR. On a static
program they are the channel's one realization by design: INFO.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.analysis.findings import Finding, Severity

CHECKER = "weak-closure"


def _operands(run) -> List[torch.Tensor]:
    """One tensor a round: the W and amplitudes each dp_mix call was
    handed, else the round's W and channel outputs, flattened and
    concatenated."""
    per_round = []
    for chunk in run.chunks:
        calls = [k for k in chunk.recorder.kernels if "operands" in k.args]
        if calls:
            per_round += [torch.cat([t.detach().float().reshape(-1)
                                     for t in k.args["operands"]])
                          for k in calls]
            continue
        out = chunk.out
        if "W" not in out:
            continue
        from repro_torch.net.sparse import SparseW
        W = out["W"]
        ws = W.w if isinstance(W, SparseW) else W
        chan = out["chan"]
        h = getattr(chan, "h", None)
        for r in range(ws.shape[0]):
            parts = [ws[r].reshape(-1)]
            if h is not None:
                parts.append(h[r].reshape(-1).float())
            per_round.append(torch.cat(parts))
    return per_round


def check_weak_closure(run, program: str = "", *,
                       dynamic: bool) -> List[Finding]:
    program = program or run.name
    ops = [o.detach().float().cpu().reshape(-1) for o in _operands(run)]
    if len(ops) < 2:
        return [Finding(CHECKER, Severity.INFO, program,
                        "no mixing operand recorded; nothing to compare")]
    frozen = all(torch.equal(ops[0], o) for o in ops[1:])
    detail = {"rounds": len(ops), "distinct": len({o.numpy().tobytes()
                                                   for o in ops})}
    if not frozen:
        return [Finding(CHECKER, Severity.INFO, program,
                        f"mixing operands change across the run "
                        f"({detail['distinct']} distinct in {len(ops)} "
                        f"rounds)", detail=detail)]
    if dynamic:
        return [Finding(
            CHECKER, Severity.ERROR, program,
            f"the mixing operands are the same in all {len(ops)} rounds of "
            f"a DYNAMIC program: a frozen channel realization (the round "
            f"should take each round's chan and W as operands)",
            detail=detail)]
    return [Finding(CHECKER, Severity.INFO, program,
                    "mixing operands are the static channel's one "
                    "realization — expected on the static path",
                    detail=detail)]
