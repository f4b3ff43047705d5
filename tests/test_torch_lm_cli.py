"""The training CLI of the port for the LMs, on the CPU at reduced size:
olmo-1b's tree and flat runs, the pinned eval batch (the batcher's first
draw), gemma-2b and deepseek-moe-16b, the dynamic network, the fleet and
the logical model shards through the shared local pass (the shards
bitwise the unsharded run), dwfl-paper's ``--reduced`` ignored (C7) and
whisper-medium's exit.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.data import LMBatcher, lm_dataset
from repro_torch.launch import train

N = 3
CLI = ["--device", "cpu", "--arch", "olmo-1b", "--reduced", "--seq-len", "32",
       "--workers", "3", "--steps", "3"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("extra", [[], ["--flat-buffer"]], ids=["tree", "flat"])
def test_cli_trains_reduced_olmo_on_cpu(extra, capsys):
    res = train.run(CLI + extra)
    out = capsys.readouterr().out
    assert "[train] olmo-1b scheme=dwfl N=3 eps=" in out
    assert "[train] params/worker: 1.44M" in out
    assert res["losses"].shape == (4,) and torch.isfinite(res["losses"]).all()
    ev = res["evals"][0]
    assert np.isfinite(ev["eval_loss"]) and 0.0 <= ev["eval_acc"] <= 1.0
    params = res["params"]
    lead = params if extra else X.tree_flatten(params)[0][0]
    assert lead.shape[0] == N


def test_cli_eval_is_the_pinned_first_draw():
    """The LM eval batch is the batcher's first draw, before any training
    batch; with --no-scan the rounds then take the next draws, as the
    reference's host stream does."""
    cfg = get_arch("olmo-1b").reduced()
    toks = lm_dataset(N * 200_000, cfg.vocab_size, seed=0)
    batcher = LMBatcher(toks, N, 2, 32, seed=0)
    first = {k: torch.from_numpy(v) for k, v in batcher.next().items()}
    res = train.run(CLI + ["--batch-size", "2", "--no-scan", "--steps", "0",
                           "--eval-every", "1"])
    wp = P.init_worker_params(torch.Generator().manual_seed(0), cfg, N, "cpu")
    proto = train.protocol_config(train.parse_args(
        CLI + ["--batch-size", "2", "--steps", "0"]))
    step = P.make_train_step(cfg, proto, "cpu")
    gen = torch.Generator().manual_seed(0)
    P.init_worker_params(gen, cfg, N, "cpu")        # the CLI's init draw
    params, _ = step(wp, {k: torch.from_numpy(v)
                          for k, v in batcher.next().items()}, gen)
    loss, acc = P.make_eval_fn(cfg)(params, first)
    assert res["evals"][0]["eval_loss"] == pytest.approx(float(loss),
                                                         rel=1e-6)
    assert res["evals"][0]["eval_acc"] == pytest.approx(float(acc))


def test_reduced_is_ignored_for_dwfl_paper():
    """C7: the reference ignores --reduced for dwfl-paper."""
    base = ["--device", "cpu", "--hidden", "16", "--workers", "3", "--steps",
            "2", "--dataset-size", "600"]
    a, b = train.run(base), train.run(base + ["--reduced"])
    torch.testing.assert_close(a["losses"], b["losses"], rtol=0, atol=0)
    for x, y in zip(X.tree_flatten(a["params"])[0],
                    X.tree_flatten(b["params"])[0]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_whisper_exits_naming_the_missing_frames():
    with pytest.raises(SystemExit, match=r"batch\['embeds'\].*A16"):
        train.run(["--device", "cpu", "--arch", "whisper-medium",
                   "--reduced"])


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-moe-16b"])
def test_cli_trains_other_reduced_families(arch):
    res = train.run(["--device", "cpu", "--arch", arch, "--reduced",
                     "--seq-len", "32", "--workers", "3", "--steps", "2"])
    assert res["losses"].shape == (3,) and torch.isfinite(res["losses"]).all()


@pytest.mark.parametrize("extra", [
    ["--channel-model", "dynamic", "--scenario", "iot_dense"],
    ["--channel-model", "dynamic", "--scenario", "vehicular",
     "--replicates", "2"],
    ["--flat-buffer", "--model-shards", "2", "--steps", "0"]],
    ids=["dynamic", "fleet", "model-shards"])
def test_cli_lm_paths_through_the_shared_local_pass(extra):
    """The dynamic network, the fleet and the logical model shards take an
    LM through the shared local pass: each trains, and the model shards'
    run is bitwise the unsharded flat run."""
    res = train.run(CLI + ["--steps", "2"] + extra)
    T = 3 if "--steps" not in extra else 1
    lead = (T, 2) if "--replicates" in extra else (T,)
    assert res["losses"].shape == lead
    assert torch.isfinite(res["losses"]).all()
    if "--model-shards" in extra:
        whole = train.run(CLI + ["--flat-buffer", "--steps", "0"])
        torch.testing.assert_close(res["losses"], whole["losses"], rtol=0,
                                   atol=0)
        d = whole["params"].shape[1]
        torch.testing.assert_close(res["params"][:, :d], whole["params"],
                                   rtol=0, atol=0)
    else:
        assert res["epsilon_report"]["rounds"] == T


def test_flat_cli_refuses_olmo_full_depth_before_allocating():
    """C2: olmo-1b's full-depth buffer at N = 2 needs 2 * 1,176,764,416
    noise counters, past 2^31; the flat CLI exits naming C2 from the
    parameters' shapes alone (an init on the meta device), before any
    parameter is allocated: on the CPU it returns at once."""
    with pytest.raises(SystemExit, match=r"2 \* 1176764416 exceeds 2\^31.*C2"):
        train.run(["--device", "cpu", "--arch", "olmo-1b", "--workers", "2",
                   "--flat-buffer", "--steps", "0"])
