"""Gather-free: no full-width all-gather in model-sharded programs (the
reference's ``repro.analysis.gather``, on recorded collectives).

The sharded round's memory contract (``shard.round``) is that no rank
ever holds the full [W, padded_width] buffer: a rank keeps its
``shard_width`` columns, and the gradient pass obtains full rows for its
block of workers only, through ``all_to_all_single``. The construct that
breaks the contract is an all-gather along the columns that widens a
``shard_width`` operand back to the padded width. Every recorded
all-gather whose output's last axis is the padded width while its
input's is narrower is an ERROR, and so is one that gathers
``shard_width`` column windows from enough ranks to make the padded
width (torch's all-gathers stack the ranks' tensors on the leading
axis, and a permute lays them side by side); the gathers of per-worker metric
vectors and the all-to-all pair never match. Unsharded programs have no
contract to hold (INFO).
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.findings import Finding, Severity

CHECKER = "gather-free"


def check_gather_free(run, program: str = "", *, sharded: bool,
                      flat_width: int, shard_width: int) -> List[Finding]:
    program = program or run.name
    if not sharded or flat_width <= 0:
        return [Finding(CHECKER, Severity.INFO, program,
                        "program is not model-sharded; gather-free "
                        "contract not applicable")]
    findings: List[Finding] = []
    n = 0
    for ci, chunk in enumerate(run.chunks):
        for c in chunk.recorder.collectives:
            if c.op != "all-gather":
                continue
            n += 1
            d_in = max((s[-1] for s in c.in_shapes if s), default=0)
            d_out = max((s[-1] for s in c.out_shapes if s), default=0)
            # a column window gathered along the rows: torch's all-gathers
            # stack the ranks' windows on the leading axis, which a
            # permute then lays side by side, the full width
            window = (d_in == shard_width and d_out == shard_width
                      and c.group_size * shard_width >= flat_width)
            if window or (d_out == flat_width and d_in < d_out):
                findings.append(Finding(
                    CHECKER, Severity.ERROR, program,
                    f"full-width all-gather: widens the last axis {d_in} -> "
                    f"{d_out} (= the padded buffer width), a [*, {d_out}] "
                    f"replica on every rank", where=f"chunk {ci}, "
                    f"collective {c.index}",
                    detail={"in_last_dim": d_in, "out_last_dim": d_out,
                            "flat_width": flat_width,
                            "shard_width": shard_width}))
    if not findings:
        findings.append(Finding(
            CHECKER, Severity.INFO, program,
            f"no full-width all-gather ({n} benign all-gathers)",
            detail={"all_gathers": n, "flat_width": flat_width}))
    return findings
