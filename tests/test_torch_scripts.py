"""The port's dev and CI scripts (``scripts/port_*``) on the CPU: the
dev smoke over reduced archs (finite loss, gradient and decode logits),
the perf helper on one small (arch, shape) pair on the meta device (its
roofline the dry run's for the same pair), the roofline report rendering
a record the port's dry run wrote, and the CI script, which runs only
the port's entry points.
"""
import json
import re
from pathlib import Path

import pytest
import torch

from repro_torch.launch import dryrun as D
from test_torch_examples import load

ROOT = Path(__file__).resolve().parents[1]
PAIR = ("gemma-2b", "decode_32k")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def script(name: str):
    return load(ROOT / "scripts" / f"{name}.py")


@pytest.mark.parametrize("arch", ["gemma-2b", "zamba2-7b", "whisper-medium",
                                  "dwfl-paper"])
def test_dev_smoke_on_reduced_archs(arch, capsys):
    (rec,) = script("port_dev_smoke").main(["--device", "cpu", arch])
    assert rec["arch"] == arch and rec["finite"] and rec["params"] > 0
    assert rec["gnorm"] > 0
    if arch != "dwfl-paper":
        assert rec["decode_finite"] and rec["decode_shape"][:2] == [2, 1]
    assert capsys.readouterr().out.startswith(arch)


def test_perf_iter_counts_a_pair_on_meta(tmp_path, capsys):
    rec = script("port_perf_iter").main([*PAIR, "t1", "--top", "--out",
                                         str(tmp_path)])
    path = tmp_path / f"{PAIR[0]}__{PAIR[1]}__t1.json"
    assert json.loads(path.read_text())["roofline"] == json.loads(
        json.dumps(rec["roofline"], default=str))
    r = rec["roofline"]
    assert r["collective_s"] is None and r["memory_s"] > 0
    assert r["dominant"] == "memory" and rec["counted"]["how"] == "direct"
    assert rec["top"]["collectives"] == [] and len(rec["top"]["ops"]) == 12
    tops = [o["bytes"] for o in rec["top"]["ops"]]
    assert tops == sorted(tops, reverse=True)
    # the dry run counts the same step
    assert D.main([*sum(zip(("--arch", "--shape"), PAIR), ()), "--out",
                   str(tmp_path / "dry")]) == 0
    dry = json.loads((tmp_path / "dry" / f"{PAIR[0]}__{PAIR[1]}__singlepod"
                      ".json").read_text())
    for k in ("compute_s", "memory_s", "flops_per_chip", "bytes_per_chip"):
        assert r[k] == dry["roofline"][k], k
    out = capsys.readouterr().out
    assert "compute=" in out and "collective=null" in out


def test_roofline_report_renders_the_dry_run_s_records(tmp_path, capsys):
    assert D.main(["--arch", PAIR[0], "--shape", PAIR[1], "--out",
                   str(tmp_path)]) == 0
    assert D.main(["--arch", "olmo-1b", "--shape", "long_500k", "--out",
                   str(tmp_path)]) == 0      # a designed skip: no record
    lines = script("port_roofline_report").main(["--dir", str(tmp_path)])
    assert lines[0].startswith("| arch | shape |") and len(lines) == 3
    row = lines[2].split(" | ")
    assert row[0] == f"| {PAIR[0]}" and row[1] == PAIR[1]
    assert row[2] == "decode" and "**memory**" in lines[2]
    assert row[9] == "-"                     # no collective on meta
    # a failed record renders as FAIL
    (tmp_path / "x__train_4k__singlepod.json").write_text(json.dumps(
        {"arch": "x", "shape": "train_4k", "ok": False, "error": "boom"}))
    lines = script("port_roofline_report").main(["--dir", str(tmp_path)])
    assert any("FAIL" in line and "boom" in line for line in lines)
    assert script("port_roofline_report").main(
        ["multipod", "--dir", str(tmp_path)])[2:] == []


def test_ci_check_runs_only_the_port():
    text = (ROOT / "scripts" / "port_ci_check.sh").read_text()
    modules = re.findall(r"python -m ([\w.]+)", text)
    assert modules and all(m.split(".")[0] in ("repro_torch", "pytest")
                           for m in modules), modules
    assert "benchmarks" not in re.sub(r"#.*", "", text)
    files = re.findall(r"python ((?:examples|scripts)/\S+\.py)", text)
    assert {Path(f).name for f in files} >= {
        "port_quickstart.py", "port_dynamic_quickstart.py",
        "port_fleet_quickstart.py", "port_compare_schemes.py",
        "port_train_dwfl_e2e.py", "port_dev_smoke.py", "port_dev_dwfl.py",
        "port_perf_iter.py", "port_roofline_report.py"}
    for f in files:
        assert Path(f).name.startswith("port_") and (ROOT / f).is_file(), f
    for mode in ("--fast", "--smoke", "--lint"):
        assert f'"{mode}"' in text
    assert "tests/test_torch_*.py" in text


@pytest.mark.parametrize("name,argv", [("port_dev_smoke", ["gemma-2b"]),
                                       ("port_dev_dwfl", [])])
def test_scripts_default_to_the_card_and_never_fall_back(name, argv):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        script(name).main(argv)


def test_dp_mix_turns_alternate_the_trees(tmp_path, monkeypatch):
    """port_dp_mix_turns times the trees in turns, the order reversed
    every other turn, one record a tree and shape with the least time;
    a shape a tree's harness lacks is left out; a directory that is not a
    checkout is refused before anything is built."""
    mod = script("port_dp_mix_turns")
    order = []

    def fake(tree, shapes):
        order.append(tree.name)
        k = len(order)
        return {(R, N): {"R": R, "N": N, "d": 7, "ms": float(k * N)}
                for R, N in shapes if not (tree.name == "a" and R > 1)}
    monkeypatch.setattr(mod, "time_tree", fake)
    trees = [Path("a"), Path("b")]
    recs = mod.turns(trees, [[1, 64], [4, 64]], 3)
    assert order == ["a", "b", "b", "a", "a", "b"]
    by = {(r["tree"], r["R"], r["N"]): r for r in recs}
    assert set(by) == {("a", 1, 64), ("b", 1, 64), ("b", 4, 64)}
    assert by[("a", 1, 64)]["ms_in_turns"] == [64.0, 256.0, 320.0]
    assert by[("b", 4, 64)]["ms"] == 128.0 and by[("b", 4, 64)]["d"] == 7
    with pytest.raises(SystemExit, match="not a checkout"):
        mod.main([str(tmp_path)])
