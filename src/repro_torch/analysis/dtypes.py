"""Dtype discipline — no float64 (or complex128) inside a round (the
reference's ``repro.analysis.dtypes``, on recorded aten ops).

The numeric contract is float32 end to end (the flat buffer, dp_mix's
noise, the cross-path bitwise tests). An accidental float64 — a numpy
float64 turned into a tensor inside the round, a Python float promoted
through a float64 tensor — doubles buffer traffic and changes realized
noise bits. Every recorded aten op's outputs are checked; a kernel's own
arithmetic (its plain twin's float64 fused multiply-adds on the CPU) is
the kernel's and is not recorded.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.analysis.findings import Finding, Severity

CHECKER = "dtype-discipline"

_WIDE = (torch.float64, torch.complex128)


def check_dtype_discipline(run, program: str = "") -> List[Finding]:
    program = program or run.name
    findings: List[Finding] = []
    hits = 0
    for ci, chunk in enumerate(run.chunks):
        for op in chunk.recorder.ops:
            wide = [d for d in op.out_dtypes if d in _WIDE]
            if not wide:
                continue
            hits += 1
            if hits > 16:      # one root cause fans out
                continue
            findings.append(Finding(
                CHECKER, Severity.ERROR, program,
                f"{op.name} produces {wide[0]} — a 64-bit op inside a round "
                f"(doubles buffer traffic and changes realized noise bits)",
                where=f"chunk {ci}, op {op.index}",
                detail={"op": op.name, "out_shapes": op.out_shapes}))
    if hits > 16:
        findings.append(Finding(
            CHECKER, Severity.ERROR, program,
            f"... and {hits - 16} more 64-bit ops (truncated)",
            detail={"total": hits}))
    return findings
