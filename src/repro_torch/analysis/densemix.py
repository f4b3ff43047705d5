"""Dense mixing: no [N, N]-shaped contraction in sparse programs (the
reference's ``repro.analysis.densemix``, on recorded aten ops).

The sparse neighbor-list round (``net.sparse``, dp_mix's
``dp_mix_round_sparse``) makes every per-round cost O(N k d); its
contract is that nothing in the round scales as N^2. The construct that
breaks it is a matrix product that contracts a worker-count-sized axis
against a worker x worker operand: what reappears if the plan falls back
to the dense kernel's mix, if a telemetry or epsilon helper densifies
the SparseW, or if a product mixes through an adjacency. Every recorded
``mm``, ``bmm``, ``addmm`` and ``baddbmm`` whose contracted size is N
(or its padded or 3-stacked variants) and one of whose operands has two
such trailing dims is an ERROR. The gradient pass's products never
match. A kernel call's own products are not recorded as ops, so every
kernel call whose mixing matrix (``args["operands"][0]``: dp_mix's W,
the sparse round's [N, k] weights) is such an [N, N] tensor is an ERROR
too: the dense ``dp_mix_round`` in place of
the neighbor-list round. Dense programs have no contract to hold (INFO).
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.findings import Finding, Severity

CHECKER = "dense-mixing"

_SUBLANES = 8      # the sparse round's worker-axis pad multiple
_PRODUCTS = ("aten.mm.", "aten.bmm.", "aten.addmm.", "aten.baddbmm.")


def _worker_sizes(n_workers: int) -> frozenset:
    np_ = -(-n_workers // _SUBLANES) * _SUBLANES
    return frozenset({n_workers, np_, 3 * n_workers, 3 * np_})


def _operands(op):
    """The two multiplied operands' shapes (addmm/baddbmm add a first)."""
    shapes = op.in_shapes
    return shapes[1:3] if op.name.startswith(("aten.addmm.",
                                              "aten.baddbmm.")) else shapes[:2]


def check_dense_mixing(run, program: str = "", *, sparse: bool,
                       n_workers: int) -> List[Finding]:
    program = program or run.name
    if not sparse or n_workers <= 1:
        return [Finding(CHECKER, Severity.INFO, program,
                        "program does not use sparse neighbor-list mixing; "
                        "dense-mixing contract not applicable")]
    sizes = _worker_sizes(n_workers)
    findings: List[Finding] = []
    n = 0
    for ci, chunk in enumerate(run.chunks):
        for op in chunk.recorder.ops:
            if not op.name.startswith(_PRODUCTS):
                continue
            n += 1
            ops = _operands(op)
            if len(ops) < 2 or len(ops[0]) < 2:
                continue
            contracted = ops[0][-1]
            if contracted not in sizes:
                continue
            for shape in ops:
                if len(shape) >= 2 and shape[-1] in sizes \
                        and shape[-2] in sizes:
                    findings.append(Finding(
                        CHECKER, Severity.ERROR, program,
                        f"[N, N]-shaped contraction: {op.name} contracts a "
                        f"worker-count-sized axis of a {list(shape)} operand "
                        f"(N={n_workers}) — the dense O(N^2 d) mixing the "
                        f"sparse round exists to eliminate",
                        where=f"chunk {ci}, op {op.index}",
                        detail={"operand_shape": list(shape),
                                "n_workers": n_workers}))
                    break
        for k in chunk.recorder.kernels:
            if not k.args.get("operands"):
                continue
            shape = tuple(k.args["operands"][0].shape)
            if len(shape) >= 2 and shape[-1] in sizes and shape[-2] in sizes:
                findings.append(Finding(
                    CHECKER, Severity.ERROR, program,
                    f"[N, N]-shaped mixing matrix: kernel call {k.name} "
                    f"mixes through a {list(shape)} operand "
                    f"(N={n_workers}) — the dense O(N^2 d) mixing the "
                    f"sparse round exists to eliminate",
                    where=f"chunk {ci}, call {k.index}",
                    detail={"operand_shape": list(shape),
                            "n_workers": n_workers}))
    if not findings:
        findings.append(Finding(
            CHECKER, Severity.INFO, program,
            f"no [N, N]-shaped contraction ({n} benign products — the "
            f"gradient pass's)", detail={"products": n,
                                         "n_workers": n_workers}))
    return findings
