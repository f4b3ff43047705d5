"""repro_torch.analysis: the seven checker families on the registry's
programs, at a narrow width (hidden 16: at 8 the MLP's 8 x 8 layer would
look like the padded [8, 8] mixing matrix of N = 6), on the CPU.

* The eight single-rank programs and, on a two-rank gloo group
  (``tests/_torch_dist.py``), the mesh program give no ERROR.
* Each family flags its seeded defect as an ERROR in a reduced program:
  a reused noise seed across rounds, an overlapping column window under
  one seed, and the tree exchange's generator re-seeded each round (key
  discipline); a second copy of the carry kept
  alive (donation); a frozen channel realization on a dynamic program
  (weak closure); a float64 op (dtypes); an ``.item()`` in the round
  (host sync); a dense [N, N] product, and the dense dp_mix kernel in
  place of the neighbor-list round, in a sparse program (dense mixing);
  a full-width all-gather on the two-rank mesh (gather-free).
* The findings schema (``report_json``) and the AST lint
  (``lint_source``) on a fixture tree equal the reference's, where
  ``repro.analysis`` imports (the message of the lint names the port's
  obs package; every other field is compared).
"""
from __future__ import annotations

import json

import pytest
import torch

import _torch_dist as D
from repro_torch.analysis import (PROGRAMS, Finding, Severity, analyze_run,
                                  available_programs, build_programs,
                                  check_dense_mixing, check_donation,
                                  check_dtype_discipline, check_host_sync,
                                  check_key_discipline, check_weak_closure,
                                  kernel_launches, lint_source, report_json,
                                  run_program, summarize)
from repro_torch.analysis.keys import (collect_draws, collect_stream_draws,
                                      counter_ranges)
from repro_torch.kernels.dp_mix import ops as mix_ops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HIDDEN = 16


def _errors(findings, checker=None):
    return [f for f in findings if f.severity == Severity.ERROR
            and (checker is None or f.checker == checker)]


def _program(name: str, wrap=None):
    prog, = build_programs([name], hidden=HIDDEN, device="cpu")
    if wrap is not None:
        body = prog.body
        new = wrap(body)
        post = getattr(body, "chunk_epilogue", None)
        if post is not None:
            new.chunk_epilogue = post
        prog.body = new
    return run_program(prog)


@pytest.mark.parametrize("name", [n for n in PROGRAMS
                                  if n != "shard-flat-s2-mesh"])
def test_single_rank_programs_have_no_error(name):
    assert name in available_programs()
    run = _program(name)
    findings = analyze_run(run)
    assert not _errors(findings), [str(f) for f in _errors(findings)]
    calls = kernel_launches(run)
    mixes = {k: v for k, v in calls["calls"].items() if k.startswith("dp_")}
    # the flat programs launch dp_mix (dense or sparse) once a round
    if run.program.flat:
        kernel = ("dp_mix_round_sparse" if run.program.sparse
                  else "dp_mix_round")
        assert mixes == {kernel: calls["rounds"]}
        draws = collect_draws(run)
        assert len(draws) == calls["rounds"] * (run.program.replicates or 1)
        assert all(r["first"] is not None for r in counter_ranges(draws))
    else:
        assert mixes == {}
    # every program draws noise the key check holds: the tree programs
    # from the carry's generator, each draw from a state of its own
    keys = [f for f in findings if f.checker == "key-discipline"]
    assert all(f.severity != Severity.WARNING for f in keys)
    if not run.program.flat:
        assert collect_stream_draws(run)


def test_mesh_program_has_no_error_and_the_gather_defect_is_found(tmp_path):
    clean, _ = D.run_ranks(D.analysis_mesh, 2, tmp_path, HIDDEN, False)
    assert not [c for c in clean if c[1] == "error"], clean
    assert ("gather-free", "info") in clean
    bad, _ = D.run_ranks(D.analysis_mesh, 2, tmp_path / "bad", HIDDEN, True)
    assert ("gather-free", "error") in bad


def test_reused_seed_is_a_key_error(monkeypatch):
    from repro_torch.core import trajectory as TJ
    fixed = lambda gen, n=1: torch.full((n,), 12345, dtype=torch.int32)
    monkeypatch.setattr(TJ, "round_seed", fixed)
    run = _program("static-flat")
    assert _errors(check_key_discipline(run))


def test_reseeded_generator_is_a_key_error():
    def wrap(body):
        def reseeding(carry):
            carry.generator.manual_seed(0)     # the same normals each round
            return body(carry)
        return reseeding

    run = _program("static-tree", wrap)
    assert _errors(check_key_discipline(run))
    clean = _program("static-tree")
    assert not _errors(check_key_discipline(clean))


def test_no_draw_is_a_key_warning():
    run = _kernel_run(lambda: None)
    keys = check_key_discipline(run)
    assert [f.severity for f in keys] == [Severity.WARNING, Severity.INFO]


def _kernel_run(calls):
    """A ProgramRun of one chunk holding ``calls()``'s kernel calls."""
    from repro_torch.analysis import registry as R
    from repro_torch.utils.trace import Recorder
    with Recorder() as rec:
        calls()
    prog = R.BuiltProgram("windows", False, 4, None, None,
                          torch.device("cpu"))
    return R.ProgramRun(prog, [R.ChunkRun(rec, {}, [0], [1], [0])], 0, 1)


def _window(col0: int, seed: int = 7):
    p = torch.randn(4, 64)
    W = torch.full((4, 4), 0.25)
    return mix_ops.dp_mix_round(p, torch.zeros_like(p), seed, W,
                                torch.ones(4), 1.0, 0.1, gamma=0.0, eta=0.5,
                                col0=col0, counter_width=128)


def test_overlapping_windows_are_a_key_error_and_a_tiling_is_not():
    tiling = _kernel_run(lambda: (_window(0), _window(64)))
    assert not _errors(check_key_discipline(tiling))
    overlap = _kernel_run(lambda: (_window(0), _window(32)))
    assert _errors(check_key_discipline(overlap))
    other_seed = _kernel_run(lambda: (_window(0), _window(32, seed=8)))
    assert not _errors(check_key_discipline(other_seed))


def test_second_carry_buffer_is_a_donation_error():
    kept = []

    def wrap(body):
        def keeping(carry):
            kept.append(carry.params)       # the old buffer outlives it
            return body(carry)
        return keeping

    run = _program("static-flat", wrap)
    assert _errors(check_donation(run))
    kept.clear()


def test_frozen_realization_is_a_weak_closure_error(monkeypatch):
    from repro_torch.net.simulator import NetworkSimulator
    orig, first = NetworkSimulator.round, {}

    def frozen(self, gen, net):
        out = orig(self, gen, net)
        first.setdefault("v", out)
        return (out[0],) + tuple(first["v"][1:])

    monkeypatch.setattr(NetworkSimulator, "round", frozen)
    run = _program("dynamic-flat-tele")
    assert _errors(check_weak_closure(run, dynamic=True))
    # the same frozen operands on a static program are expected (INFO)
    assert not _errors(check_weak_closure(run, dynamic=False))


def _wrap_out(fn):
    def wrap(body):
        def changed(carry):
            new, out = body(carry)
            fn(new, out)
            return new, out
        return changed
    return wrap


def test_float64_is_a_dtype_error():
    run = _program("static-tree", _wrap_out(
        lambda c, o: o["metrics"]["loss"].double()))
    assert _errors(check_dtype_discipline(run))


def test_item_is_a_host_sync_error():
    run = _program("static-tree", _wrap_out(
        lambda c, o: o["metrics"]["loss"].item()))
    assert _errors(check_host_sync(run))


def test_dense_mix_is_an_error_in_a_sparse_program():
    def dense(carry, out):
        N = carry.params.shape[0]
        torch.full((N, N), 1.0 / N) @ carry.params
    run = _program("dynamic-sparse-flat", _wrap_out(dense))
    assert _errors(check_dense_mixing(run, sparse=True, n_workers=6))
    assert not _errors(check_dense_mixing(run, sparse=False, n_workers=6))


def test_dense_kernel_mix_is_an_error_in_a_sparse_program(monkeypatch):
    def dense_round(p, g, seed, sw, *args, **kwargs):
        kwargs.pop("row0", None)
        out = kwargs.pop("out", None)
        new = mix_ops.dp_mix_round(p, g, seed, sw.dense(), *args, **kwargs)
        return new if out is None else out.copy_(new)

    monkeypatch.setattr(mix_ops, "dp_mix_round_sparse", dense_round)
    run = _program("dynamic-sparse-flat")
    assert kernel_launches(run)["calls"].get("dp_mix_round")
    errors = _errors(check_dense_mixing(run, sparse=True, n_workers=6))
    assert errors and all("kernel call dp_mix_round" in f.message
                          for f in errors)


def _fixture_tree(root):
    (root / "pkg").mkdir()
    (root / "pkg" / "a.py").write_text(
        "def f():\n    print('x')\n    s = 'print(' \n")
    (root / "pkg" / "__main__.py").write_text("print('cli')\n")
    (root / "launch").mkdir()
    (root / "launch" / "b.py").write_text("print('driver')\n")
    (root / "obs").mkdir()
    (root / "obs" / "c.py").write_text("print('report')\n")
    (root / "bad.py").write_text("def (:\n")
    (root / "ok.py").write_text("from pprint import pprint\npprint(1)\n")


def test_lint_and_report_equal_the_reference(tmp_path):
    ref = pytest.importorskip("repro.analysis.sourcelint")
    ref_findings = pytest.importorskip("repro.analysis.findings")
    _fixture_tree(tmp_path)
    mine = lint_source(tmp_path)
    theirs = ref.lint_source(tmp_path)
    key = lambda f: (f.checker, str(f.severity), f.program, f.where)
    assert sorted(map(key, mine)) == sorted(map(key, theirs))
    assert sorted(f.where for f in mine) == ["bad.py:1", "pkg/a.py:2"]
    findings = [Finding("x", Severity.ERROR, "p", "m", "w", {"k": 1}),
                Finding("y", Severity.INFO, "q", "n")]
    ref_list = [ref_findings.Finding("x", ref_findings.Severity.ERROR, "p",
                                     "m", "w", {"k": 1}),
                ref_findings.Finding("y", ref_findings.Severity.INFO, "q",
                                     "n")]
    meta = {"elapsed_s": 1.0}
    assert json.loads(report_json(findings, ["p", "q"], meta)) == \
        json.loads(ref_findings.report_json(ref_list, ["p", "q"], meta))
    assert summarize(findings) == ref_findings.summarize(ref_list)
    assert [str(f) for f in findings] == [str(f) for f in ref_list]


def test_the_port_s_source_has_no_stray_print():
    assert not lint_source()


def test_cli_on_the_source_only():
    from repro_torch.analysis.__main__ import main
    assert main(["--source-only"]) == 0
