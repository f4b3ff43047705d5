"""repro_torch.analysis — checks of the shipped DWFL round programs (the
reference's ``repro.analysis``, on recorded eager runs instead of
jaxprs and HLO).

Seven invariant families, each a pure function ``program run ->
list[Finding]`` over what ``utils.trace.Recorder`` saw while the
registry's programs (registry.py) ran two chunks:

* key-discipline   (keys.py)      — no noise counter hashed twice under
                                    one seed: the DP-critical check
* donation         (donation.py)  — no second copy of the carry's
                                    buffer survives a round
* weak-closure     (constants.py) — a dynamic program's mixing operands
                                    change between rounds
* dtype-discipline (dtypes.py)    — no float64/complex128 op in a round
* host-sync        (hostsync.py)  — no host read inside a round
* gather-free      (gather.py)    — no full-width all-gather in a
                                    model-sharded program
* dense-mixing     (densemix.py)  — no [N, N]-shaped contraction in a
                                    sparse neighbor-list program

plus the AST source lint (sourcelint.py). ``python -m
repro_torch.analysis`` runs everything and fails on ERROR findings.
"""
from repro_torch.analysis.constants import check_weak_closure
from repro_torch.analysis.densemix import check_dense_mixing
from repro_torch.analysis.donation import check_donation
from repro_torch.analysis.dtypes import check_dtype_discipline
from repro_torch.analysis.findings import (Finding, Severity, report_json,
                                           summarize)
from repro_torch.analysis.gather import check_gather_free
from repro_torch.analysis.hostsync import check_host_sync
from repro_torch.analysis.keys import check_key_discipline
from repro_torch.analysis.registry import (PROGRAMS, BuiltProgram,
                                           ProgramRun, available_programs,
                                           build_programs, run_program)
from repro_torch.analysis.sourcelint import lint_source


def analyze_run(run: ProgramRun):
    """All seven checker families over one program's run."""
    prog = run.program
    findings = []
    findings += check_key_discipline(run)
    findings += check_donation(run)
    findings += check_weak_closure(run, dynamic=prog.dynamic)
    findings += check_dtype_discipline(run)
    findings += check_host_sync(run)
    findings += check_gather_free(run, sharded=prog.sharded,
                                  flat_width=prog.flat_width,
                                  shard_width=prog.shard_width)
    findings += check_dense_mixing(run, sparse=prog.sparse,
                                   n_workers=prog.n_workers)
    return findings


def kernel_launches(run: ProgramRun) -> dict:
    """{kernel call name: calls} over the run, and the rounds it ran."""
    calls: dict = {}
    for chunk in run.chunks:
        for k in chunk.recorder.kernels:
            calls[k.name] = calls.get(k.name, 0) + 1
    return {"calls": calls,
            "rounds": sum(len(c.round_index) for c in run.chunks)}


__all__ = [
    "Finding", "Severity", "summarize", "report_json",
    "check_key_discipline", "check_donation", "check_weak_closure",
    "check_dtype_discipline", "check_host_sync", "check_gather_free",
    "check_dense_mixing", "lint_source", "PROGRAMS", "BuiltProgram",
    "ProgramRun", "available_programs", "build_programs", "run_program",
    "analyze_run", "kernel_launches",
]
