"""Donation — the carry's buffer is not kept twice (the reference's
``repro.analysis.donation``, on live storages instead of the compiled
executable's alias table).

The reference donates the trajectory's carry so XLA updates the
persistent [W, d] buffer in place; a dead donation keeps a silent second
copy. The port's rounds are eager and out of place: dp_mix writes its
output beside its input, and the input's buffer is freed when the round
hands back the new carry. The contract that survives is the memory one:
at the start of every round exactly as many storages of the carry's
largest size are alive as the carry has leaves of that size. A second
buffer that outlives its round (a reference kept to the old carry, a
copy of it) doubles the program's memory and is an ERROR. The data
pointers the carry's buffer took over the run are reported (INFO): the
caching allocator hands a round's output a freed block, so they cycle
through a few blocks rather than stay fixed.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.findings import Finding, Severity

CHECKER = "donation"


def check_donation(run, program: str = "") -> List[Finding]:
    program = program or run.name
    findings: List[Finding] = []
    want = run.buffer_leaves
    for ci, chunk in enumerate(run.chunks):
        for r, live in enumerate(chunk.live_buffers):
            if live > want:
                findings.append(Finding(
                    CHECKER, Severity.ERROR, program,
                    f"{live} buffers of the carry's size "
                    f"({run.buffer_bytes} bytes) alive at a round's start, "
                    f"{want} in the carry: a second copy of the carry "
                    f"survives its round", where=f"chunk {ci}, round {r}",
                    detail={"live": live, "carry_leaves": want,
                            "bytes": run.buffer_bytes}))
    ptrs = [p for c in run.chunks for p in c.carry_ptrs]
    findings.append(Finding(
        CHECKER, Severity.INFO, program,
        f"carry buffer of {run.buffer_bytes} bytes: {len(set(ptrs))} "
        f"distinct blocks over {len(ptrs)} rounds",
        detail={"blocks": len(set(ptrs)), "rounds": len(ptrs)}))
    return findings
