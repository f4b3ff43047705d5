"""The port's user-facing examples (``examples/port_*.py``) and the data
and registry functions they stand on, against the reference on the CPU.

Each example's loop is a function of its operands; here it runs a few
rounds on the reference's realized operands — the same numpy batches
(the port's ``FederatedBatcher`` and ``LMBatcher`` are bitwise the
reference's), the flat round's int32 seed ``seed_from_key(k_n)``, the
tree round's ``jax.random`` normals, the simulator's channels and Ws —
beside the reference's own step functions. Tolerances are those of the
single-round tests, over the rounds run:

* flat buffer (quickstart, 3 rounds): atol 3e-6 (1 + max|x| + 5.42
  max|amp/c|), three rounds of test_torch_dynamic.py's 1e-6 bound;
  measured 4.8e-8 of that scale;
* worker tree (dynamic, fleet, compare_schemes; 3 rounds): 3e-6 (1 + max|x| + 5.42
  max|amp/c|), measured at most 2.4e-8 of it; the LM's two rounds: 2e-5
  of the largest parameter (test_torch_lm_train.py's 1e-5 a round),
  measured 1.4e-8;
* eval accuracy: equal within two flipped samples of the eval batch;
  losses rtol 1e-5;
* epsilon: host math (the static report, the compare_schemes harness)
  exact; tensor math (the trajectory's per-round budgets) rtol 1e-6 and
  its float64 compositions rtol 2e-6, as test_torch_accounting.py.

The network examples and the round guards that stand for the
reference's "traced exactly once" asserts: tests/test_torch_examples_net.py.
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.configs.dwfl_paper import CONFIG as REF_CFG
from repro.core import exchange as RX
from repro.core import protocol as RP
from repro.data import FederatedBatcher as RefBatcher
from repro.data import LMBatcher as RefLMBatcher
from repro.data import partition as rpartition
from repro.models import model as RM
import repro.models.mlp as ref_mlp
from repro_torch.checkpoint import restore
from repro_torch.configs import registry
from repro_torch.convert import lm_worker_params_from_jax, params_from_jax
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.data import LMBatcher, iid_partition, lm_dataset
from repro_torch.kernels.dp_mix import ops
from repro_torch.models import model as M
from test_torch_protocol import ref_normals

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 3
TREE_TOL = 3e-6
LM_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(path: Path):
    """A module of ``examples/`` or ``scripts/`` by its path."""
    name = "_ex_" + path.stem
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def example(name: str):
    return load(ROOT / "examples" / f"{name}.py")


def _scale(plan, want, c=None) -> float:
    c = plan.c if c is None else c
    return 1.0 + float(np.abs(want).max()) + 5.42 * float(
        (plan.amp / c).abs().max())


def _up(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _down(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tree(rwp):
    return X.tree_map(lambda a: torch.from_numpy(np.array(a)),
                      jax.tree_util.tree_map(np.asarray, rwp))


# -- data and registry ----------------------------------------------------------


@pytest.mark.parametrize("n,workers,seed", [(100, 4, 0), (1000, 7, 3),
                                            (6000, 10, 1), (13, 5, 2),
                                            (10, 10, 9)])
def test_iid_partition_is_bitwise_the_reference(n, workers, seed):
    got = iid_partition(n, workers, seed=seed)
    want = rpartition.iid_partition(n, workers, seed=seed)
    assert len(got) == len(want) == workers
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # disjoint, n // workers each
    flat = np.concatenate(got)
    assert len(np.unique(flat)) == flat.size == (n // workers) * workers


def test_applicable_and_all_pairs_are_the_reference_s():
    assert list(registry.all_pairs()) == list(rregistry.all_pairs())
    assert len(list(registry.all_pairs())) == 10 * 4
    for a, s, skip in rregistry.all_pairs():
        assert registry.applicable(a, s) == rregistry.applicable(a, s)
        assert registry.applicable(a, s) == (skip is None)
    assert not registry.applicable("olmo-1b", "long_500k")
    assert registry.applicable("gemma-2b", "long_500k")


# -- port_quickstart.py: the static flat buffer, one dp_mix round a step --------


def test_quickstart_loop_replays_the_reference():
    ex = example("port_quickstart")
    N, kw = ex.N, ex.PROTO
    x, y = ex.classification_dataset(6000, input_dim=ex.INPUT_DIM, seed=0)
    parts = ex.dirichlet_partition(y, N, alpha=0.5, seed=0)
    rbatcher = RefBatcher(x, y, parts, ex.BATCH)
    rcfg = REF_CFG.replace(d_model=ex.HIDDEN)
    params = ref_mlp.init(jax.random.PRNGKey(0), rcfg, input_dim=ex.INPUT_DIM)
    wp = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (N,) + a.shape), params)
    rspec = RX.make_flat_spec(wp)
    rflat = rspec.flatten(wp)
    rstep = jax.jit(RP.make_flat_train_step(rcfg, RP.ProtocolConfig(**kw),
                                            rspec.unravel_row))
    revaluate = jax.jit(RP.make_eval_fn(rcfg))
    ev = rbatcher.full(128)

    key = jax.random.PRNGKey(1)
    ref_evals, seeds, batches = [], [], []
    for r in range(ROUNDS):
        key, sk = jax.random.split(key)
        b = rbatcher.next()
        batches.append(_up(b))
        seeds.append(ops.seed_from_key(np.asarray(jax.random.split(sk, 3)[0])))
        rflat, rm = rstep(rflat, _down(b), sk)
        if r % 2 == 0:
            ref_evals.append((float(rm["loss"]),
                              float(revaluate(rspec.unravel(rflat),
                                              _down(ev))[1])))
    cfg = ex.DWFL_PAPER.replace(d_model=ex.HIDDEN)
    flat, _, spec = params_from_jax(jax.tree_util.tree_map(np.asarray, wp),
                                    device="cpu")
    proto = P.ProtocolConfig(**kw)
    step = P.make_flat_train_step(cfg, proto, spec, "cpu")
    out, evals, last = ex.train(step, P.make_eval_fn(cfg), spec, flat,
                                iter(batches), iter(seeds), _up(ev), ROUNDS,
                                eval_every=2)
    want = np.asarray(rflat)
    plan = proto.plan(proto.channel(), "cpu")
    np.testing.assert_allclose(out.numpy(), want, rtol=0,
                               atol=3e-6 * _scale(plan, want))
    assert [e[0] for e in evals] == [0, 2]
    for (_, loss, acc), (rloss, racc) in zip(evals, ref_evals):
        assert float(loss) == pytest.approx(rloss, rel=1e-5)
        assert abs(float(acc) - racc) <= 2 / (N * 128)
    assert last["seed"] is seeds[-1] and last["batch"] is batches[-1]


def test_quickstart_main_on_the_cpu(capsys):
    ex = example("port_quickstart")
    res = ex.main(["--device", "cpu", "--rounds", "3"])
    rep = RP.epsilon_report(RP.ProtocolConfig(**ex.PROTO),
                            RP.ProtocolConfig(**ex.PROTO).channel())
    assert res["privacy"] == {k: round(v, 4) for k, v in rep.items()
                              if isinstance(v, float)}
    assert res["epsilon"] == round(rep["epsilon_worst"], 3)
    assert res["launches"] == 0 and res["rounds"] == 3
    assert [e["round"] for e in res["evals"]] == [0]
    assert np.isfinite(res["evals"][0]["train_loss"])
    out = capsys.readouterr().out
    assert "privacy:" in out and "round    0  train_loss=" in out
    assert "dp_mix launches: 0 in 3 rounds" in out
    assert res["state"]["flat"].shape == (ex.N, res["state"]["spec"].width)


# -- port_compare_schemes.py: the four schemes at one epsilon ------------------


def test_compare_schemes_epsilon_and_sigma_are_the_reference_s(capsys):
    ex = example("port_compare_schemes")
    res = ex.main(["--device", "cpu", "--workers", "4", "--steps", "2"])
    assert list(res["schemes"]) == list(ex.SCHEMES)
    for scheme, got in res["schemes"].items():
        rproto = RP.ProtocolConfig(scheme=scheme, n_workers=4, gamma=0.02,
                                   eta=0.4, clip=1.0, p_dbm=60.0, seed=1,
                                   target_epsilon=0.5)
        want = RP.epsilon_report(rproto, rproto.channel())
        assert got["epsilon"] == float(want["epsilon_worst"]), scheme
        assert got["sigma"] == want["sigma"], scheme
        assert got["epsilon_sampled"] is None
        assert got["epsilon"] == pytest.approx(0.5, rel=1e-6)
        assert got["us_per_call"] > 0 and 0 <= got["final_acc"] <= 1
    out = capsys.readouterr().out
    assert "Fig.5 claim" in out and "Fig.6 claim" in out
    assert res["fig5_reproduced"] == (res["schemes"]["dwfl"]["final_acc"]
                                      > res["schemes"]["orthogonal"][
                                          "final_acc"])


def test_compare_schemes_loop_replays_the_reference_s_gossip_round():
    """run_steps on the harness's task, the reference's gossip rounds
    (no noise) from the same init and batches."""
    ex = example("port_compare_schemes")
    kw = dict(scheme="gossip", n_workers=4, gamma=0.02, eta=0.4, clip=1.0,
              p_dbm=60.0, seed=1, target_epsilon=0.5)
    x, y = ex.classification_dataset(ex.DATA_N, input_dim=ex.INPUT_DIM,
                                     seed=1)
    parts = ex.dirichlet_partition(y, 4, alpha=0.5, seed=1)
    rbat = RefBatcher(x, y, parts, ex.BATCH, seed=1)
    rcfg = REF_CFG.replace(d_model=ex.HIDDEN)
    params = ref_mlp.init(jax.random.PRNGKey(1), rcfg, input_dim=ex.INPUT_DIM)
    rwp = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (4,) + a.shape), params)
    wp0 = _tree(rwp)
    rstep = jax.jit(RP.make_train_step(rcfg, RP.ProtocolConfig(**kw)))
    batches = []
    for i in range(ROUNDS):
        b = rbat.next()
        batches.append(_up(b))
        rwp, _ = rstep(rwp, _down(b), jax.random.PRNGKey(i))
    cfg = ex.DWFL_PAPER.replace(d_model=ex.HIDDEN)
    step = P.make_train_step(cfg, P.ProtocolConfig(**kw), "cpu")
    wp, curve = ex.run_steps(step, wp0, iter(batches), None, ROUNDS)
    assert curve == []
    got = X.flatten_worker_tree(wp).numpy()
    want = np.concatenate([np.asarray(l).reshape(4, -1)
                           for l in jax.tree_util.tree_leaves(rwp)], axis=1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TREE_TOL * (1 + np.abs(want).max()))


# -- port_train_dwfl_e2e.py: the LM driver -------------------------------------


def _ref_e2e():
    return load(ROOT / "examples" / "train_dwfl_e2e.py")


@pytest.mark.parametrize("size", ["2m", "10m", "100m"])
def test_e2e_sizes_count_the_reference_s_params(size):
    ex, ref = example("port_train_dwfl_e2e"), _ref_e2e()
    cfg, rcfg = ex.SIZES[size], ref.SIZES[size]
    for f in ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "d_ff", "vocab_size", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(rcfg, f), f
    n = M.count_params(M.init_params(torch.Generator(), cfg, "meta"))
    shapes = jax.eval_shape(lambda k: RM.init_params(k, rcfg),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in
               jax.tree_util.tree_leaves(shapes))
    assert n == want
    if size == "100m":
        assert 90e6 < n < 130e6


@pytest.mark.parametrize("scheme", ["gossip", "dwfl"])
def test_e2e_two_rounds_of_2m_replay_the_reference(scheme):
    ex = example("port_train_dwfl_e2e")
    W, Bt, S = 2, 2, 16
    cfg, rcfg = ex.SIZES["2m"], _ref_e2e().SIZES["2m"]
    kw = dict(scheme=scheme, n_workers=W, gamma=0.02, eta=0.3, clip=1.0,
              target_epsilon=2.0, p_dbm=80.0)
    rwp = RP.init_worker_params(jax.random.PRNGKey(0), rcfg, W)
    _, tree, _ = lm_worker_params_from_jax(
        jax.tree_util.tree_map(np.asarray, rwp), "cpu")
    toks = lm_dataset(W * 4_000, cfg.vocab_size, seed=0)
    rbat = RefLMBatcher(toks, W, Bt, S, seed=0)
    bat = LMBatcher(toks, W, Bt, S, seed=0)
    rstep = jax.jit(RP.make_train_step(rcfg, RP.ProtocolConfig(**kw)))
    batches, noise, rlosses = [], [], []
    key = jax.random.PRNGKey(0)
    for _ in range(2):
        key, sk = jax.random.split(key)
        b = rbat.next()
        np.testing.assert_array_equal(bat.next()["tokens"], b["tokens"])
        batches.append(_up(b))
        noise.append(ref_normals(scheme, rwp, sk))
        rwp, rm = rstep(rwp, _down(b), sk)
        rlosses.append(float(rm["loss"]))
    step = P.make_train_step(cfg, P.ProtocolConfig(**kw), "cpu")
    wp, losses = ex.train(step, tree, iter(batches), None, 2,
                          noise=iter(noise))
    assert [float(v) for v in losses] == pytest.approx(rlosses, rel=1e-5)
    got = X.flatten_worker_tree(wp).numpy()
    want = np.asarray(RX.FlatSpec(rwp).flatten(rwp))
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err < LM_TOL, err


def test_e2e_checkpoint_round_trip_is_bitwise(tmp_path, capsys):
    ex = example("port_train_dwfl_e2e")
    path = str(tmp_path / "e2e")
    res = ex.main(["--device", "cpu", "--steps", "1", "--workers", "2",
                   "--batch", "2", "--seq-len", "16", "--checkpoint", path])
    assert res["rounds"] == 2 and all(np.isfinite(res["losses"]))
    wp = res["state"]["wp"]
    back, manifest = restore(path, wp)
    assert manifest["step"] == 1 and manifest["metadata"] == {"size": "2m"}
    a, _ = X.tree_flatten(wp)
    b, _ = X.tree_flatten(back)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    out = capsys.readouterr().out
    assert "[e2e] dwfl-lm-2m:" in out and f"checkpoint -> {path}" in out


def test_e2e_keeps_the_reference_s_three_verdicts():
    ex = example("port_train_dwfl_e2e")
    assert "IMPROVED" in ex.verdict(7.0, 6.9)
    assert "noise floor" in ex.verdict(7.0, 7.5)
    assert "diverged" in ex.verdict(7.0, 9.0)


# -- every example runs on the card by default --------------------------------


@pytest.mark.parametrize("name", ["port_quickstart", "port_dynamic_quickstart",
                                  "port_fleet_quickstart",
                                  "port_compare_schemes",
                                  "port_train_dwfl_e2e"])
def test_examples_default_to_the_card_and_never_fall_back(name):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        example(name).main([])
