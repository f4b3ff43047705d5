"""Host sync — no host read inside a round (the reference's
``repro.analysis.hostsync``, on recorded aten ops).

A chunk of K rounds must run without waiting for the host: a Python
scalar read of a device tensor (``.item()``, ``float()``, ``bool()``, a
branch on a tensor) or a copy to the CPU inside the round stalls the
launch queue every round. On every device these show as aten ops:
``_local_scalar_dense`` (``item``), ``is_nonzero`` (``bool``), ``equal``,
and a ``_to_copy``/``copy_`` from a device tensor to a CPU one. On the
card the registry also runs each chunk under ``obs.no_implicit_transfers``
(sync-debug mode "error"), which fails at the synchronization itself.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.findings import Finding, Severity

CHECKER = "host-sync"

_READS = ("aten._local_scalar_dense", "aten.item", "aten.is_nonzero",
          "aten.equal")
_COPIES = ("aten._to_copy", "aten.copy_", "aten.to")


def _is_read(op) -> bool:
    if op.name.split(".default")[0] in _READS or any(
            op.name.startswith(r + ".") for r in _READS):
        return True
    if any(op.name.startswith(c + ".") for c in _COPIES):
        src = [d for d in op.in_devices if d not in ("cpu", "meta")]
        return bool(src) and "cpu" in op.out_devices
    return False


def check_host_sync(run, program: str = "") -> List[Finding]:
    program = program or run.name
    findings: List[Finding] = []
    for ci, chunk in enumerate(run.chunks):
        for op in chunk.recorder.ops:
            if _is_read(op):
                findings.append(Finding(
                    CHECKER, Severity.ERROR, program,
                    f"{op.name} inside a round: a host read that stalls "
                    f"the chunk every round", where=f"chunk {ci}, op "
                    f"{op.index}", detail={"op": op.name}))
    return findings
