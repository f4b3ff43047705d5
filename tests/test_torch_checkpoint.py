"""Checkpoints in the port (repro_torch.checkpoint, ROADMAP A13) against
the reference's repro.checkpoint.

* The format crosses between the packages bitwise: a buffer the
  reference's ``save_flat`` wrote restores into the port, and one the
  port wrote restores through the reference's ``restore_flat``, each into
  any shard layout; the port's manifest is the reference's for the same
  buffer (its ``treedef`` string aside, which no restore reads).
* A run resumed from its own mid-trajectory checkpoint (the buffer, the
  generator's state, the network's state) is bitwise the run that was not
  interrupted, at S = 1 and 2, under any other shard count or chunk
  budget, and through the CLI's ``--checkpoint``.
* A mismatched d or lead shape, or a drifted shard record, is refused as
  the reference refuses it; a bfloat16 leaf round-trips.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as D
from repro import checkpoint as rckpt
from repro.core import exchange as RX
from repro_torch import checkpoint
from repro_torch.configs import DWFL_PAPER
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.core import trajectory as TJ
from repro_torch.data import (ClassificationStore, classification_dataset,
                              dirichlet_partition)
from repro_torch.launch import train


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bitwise(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a, b) and torch.equal(a.signbit(), b.signbit())


def _ref_tree(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


def _buffer(wp, seed=3):
    """A canonical [N, d] buffer of random values (not the init's copies)."""
    d = X.FlatSpec(wp).d
    rng = np.random.default_rng(seed)
    return rng.normal(size=(D.N, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# the format, across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("read_shards", [1, 2, 4])
def test_reference_checkpoint_restores_into_the_port(read_shards, tmp_path):
    _, _, wp, _ = D.setup()
    canon = _buffer(wp)
    rspec = RX.make_flat_spec(_ref_tree(wp), n_shards=2, max_chunk_cols=40)
    path = os.path.join(tmp_path, "ref")
    rckpt.save_flat(path, rspec.layout.pad(jnp.asarray(canon)), rspec,
                    step=7, metadata={"who": "reference"})
    spec = X.make_flat_spec(wp, n_shards=read_shards)
    flat, state, manifest = checkpoint.restore_flat(path, spec,
                                                    device="cpu")
    assert state is None and flat.shape == (D.N, spec.width)
    np.testing.assert_array_equal(spec.unpad(flat).numpy(), canon)
    assert bool((flat[:, spec.d:] == 0).all())
    with open(path + ".json") as f:
        assert manifest == json.load(f)
    assert manifest["step"] == 7


@pytest.mark.parametrize("write_shards", [1, 2, 4])
def test_port_checkpoint_restores_into_the_reference(write_shards, tmp_path):
    _, _, wp, _ = D.setup()
    canon = _buffer(wp)
    spec = X.make_flat_spec(wp, n_shards=write_shards)
    rspec = RX.make_flat_spec(_ref_tree(wp), n_shards=write_shards)
    port, ref = (os.path.join(tmp_path, n) for n in ("port", "ref"))
    meta = {"arch": "dwfl-paper", "epsilon": 0.5}
    checkpoint.save_flat(port, torch.nn.functional.pad(
        torch.from_numpy(canon), (0, spec.width - spec.d)), spec, step=4,
        metadata=meta)
    rckpt.save_flat(ref, jnp.pad(jnp.asarray(canon),
                                 ((0, 0), (0, rspec.width - rspec.d))),
                    rspec, step=4, metadata=meta)
    for read in (1, 2):
        rread = RX.make_flat_spec(_ref_tree(wp), n_shards=read)
        flat, state, manifest = rckpt.restore_flat(port, rread)
        assert state is None
        np.testing.assert_array_equal(np.asarray(rread.unpad(flat)), canon)
    with open(port + ".json") as f, open(ref + ".json") as g:
        mine, theirs = json.load(f), json.load(g)
    mine.pop("treedef"), theirs.pop("treedef")
    assert mine == theirs
    with np.load(port + ".npz") as a, np.load(ref + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        np.testing.assert_array_equal(a["flat"], b["flat"])


def test_bfloat16_leaf_round_trips(tmp_path):
    """A bfloat16 leaf is stored float32 with orig_dtype "bfloat16" and
    narrowed back on restore, in either package."""
    gen = torch.Generator().manual_seed(0)
    tree = {"b": torch.randn((3, 5), generator=gen).to(torch.bfloat16),
            "a": [torch.arange(4, dtype=torch.int32),
                  torch.randn(2, generator=gen)],
            "c": np.arange(3, dtype=np.int64)}
    path = os.path.join(tmp_path, "bf")
    checkpoint.save(path, tree, step=2)
    with open(path + ".json") as f:
        leaves = json.load(f)["leaves"]
    assert leaves["b"] == {"shape": [3, 5], "dtype": "float32",
                           "orig_dtype": "bfloat16"}
    assert set(leaves) == {"a/0", "a/1", "b", "c"}
    like = {"b": torch.zeros((3, 5), dtype=torch.bfloat16),
            "a": [torch.zeros(4, dtype=torch.int32), torch.zeros(2)],
            "c": np.zeros(3, np.int64)}
    got, manifest = checkpoint.restore(path, like)
    assert manifest["step"] == 2
    _bitwise(got["b"], tree["b"])
    _bitwise(got["a"][0], tree["a"][0])
    _bitwise(got["a"][1], tree["a"][1])
    np.testing.assert_array_equal(got["c"], tree["c"])
    rgot, _ = rckpt.restore(path, {"b": jnp.zeros((3, 5), jnp.bfloat16),
                                   "a": [jnp.zeros(4, jnp.int32),
                                         jnp.zeros(2, jnp.float32)],
                                   "c": np.zeros(3, np.int64)})
    np.testing.assert_array_equal(
        np.asarray(rgot["b"]).astype(np.float32), tree["b"].float().numpy())
    # and a bfloat16 leaf the reference wrote, into the port
    rpath = os.path.join(tmp_path, "rbf")
    rckpt.save(rpath, {"b": jnp.asarray(tree["b"].float().numpy())
                       .astype(jnp.bfloat16)})
    got, _ = checkpoint.restore(rpath, {"b": like["b"]})
    _bitwise(got["b"], tree["b"])
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(path, dict(like, b=torch.zeros((3, 4),
                                                          dtype=torch.bfloat16)))


def test_restore_flat_rejects_a_mismatched_contract(tmp_path):
    _, _, wp, _ = D.setup()
    spec = X.make_flat_spec(wp, n_shards=2)
    path = os.path.join(tmp_path, "ck")
    checkpoint.save_flat(path, spec.flatten(wp), spec)
    wider = X.make_flat_spec(X.tree_map(
        lambda a: torch.cat([a, a], dim=-1), wp))
    with pytest.raises(ValueError, match="d="):
        checkpoint.restore_flat(path, wider, device="cpu")
    six = X.make_flat_spec(X.tree_map(lambda a: torch.cat([a, a[:1]]), wp))
    with pytest.raises(ValueError, match="lead shape"):
        checkpoint.restore_flat(path, six, device="cpu")
    with open(path + ".json") as f:
        man = json.load(f)
    man["metadata"]["flat_layout"]["shard"]["shard_width"] = 64
    with open(path + ".json", "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="layout metadata mismatch"):
        checkpoint.restore_flat(path, spec, device="cpu")
    # the reference refuses the port's drifted record alike
    with pytest.raises(ValueError, match="layout metadata mismatch"):
        rckpt.restore_flat(path, RX.make_flat_spec(_ref_tree(wp),
                                                   n_shards=2))


def test_save_flat_without_state_and_plain_save_coexist(tmp_path):
    _, _, wp, _ = D.setup()
    spec = X.make_flat_spec(wp)
    path = os.path.join(tmp_path, "plain")
    checkpoint.save_flat(path, spec.flatten(wp), spec, step=7)
    flat, state, manifest = checkpoint.restore_flat(path, spec, device="cpu")
    assert state is None and manifest["step"] == 7
    _bitwise(flat, spec.flatten(wp))
    checkpoint.save(os.path.join(tmp_path, "tree"), wp, step=1)
    got, _ = checkpoint.restore(os.path.join(tmp_path, "tree"), wp)
    for a, b in zip(X.tree_flatten(got)[0], X.tree_flatten(wp)[0]):
        _bitwise(a, b)


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------


def _store():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(160, D.DIM)).astype(np.float32)
    y = rng.integers(0, 10, 160).astype(np.int32)
    parts = [np.arange(w, 160, D.N) for w in range(D.N)]
    return ClassificationStore.build(x, y, parts, D.B, device="cpu")


def _dynamic_setup(n_shards, max_chunk_cols=None):
    cfg, proto, wp, _ = D.setup(channel_model="dynamic", scenario="iot_dense",
                                flat_buffer=True)
    sim = proto.simulator("cpu")
    spec = (X.make_flat_spec(wp, n_shards=n_shards,
                             max_chunk_cols=max_chunk_cols) if n_shards > 1
            else X.make_flat_spec(wp))
    body = TJ.make_round_body(cfg, proto, _store(), spec, "cpu", sim=sim)
    gen = torch.Generator().manual_seed(5)
    carry0 = TJ.TrajCarry(gen, spec.flatten(wp), sim.init(gen))
    return spec, body, carry0


def _run(body, carry, k):
    """k rounds from a copy of ``carry`` (its generator cloned)."""
    gen = torch.Generator().set_state(carry.generator.get_state())
    carry, _ = TJ.run_chunk(body, carry._replace(generator=gen), k)
    return carry


def _same_state(a, b):
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    for x, y in zip(checkpoint.checkpoint._items(a.net),
                    checkpoint.checkpoint._items(b.net)):
        assert x[0] == y[0]
        _bitwise(x[1], y[1])


@pytest.mark.parametrize("n_shards", [1, 2], ids=["unsharded", "sharded"])
def test_mid_trajectory_checkpoint_resumes_bitwise(n_shards, tmp_path):
    """6 dynamic rounds straight; 3, a checkpoint (buffer, generator,
    network), a restore into a fresh spec, 3 more: the buffer, the
    generator and the network bitwise."""
    spec, body, carry0 = _dynamic_setup(n_shards)
    ref = _run(body, carry0, 6)
    mid = _run(body, carry0, 3)
    path = os.path.join(tmp_path, "ckpt")
    checkpoint.save_flat(path, mid.params, spec, step=3,
                         state=checkpoint.trajectory_state(mid),
                         metadata={"test": "mid-trajectory"})
    spec2, body2, fresh = _dynamic_setup(n_shards)
    flat, state, manifest = checkpoint.restore_flat(
        path, spec2, state_like=checkpoint.trajectory_state(fresh),
        device="cpu")
    assert manifest["step"] == 3
    assert manifest["metadata"]["flat_layout"]["d"] == spec2.d
    assert set(manifest["leaves"]) >= {"flat", "state/generator",
                                       "state/net/fading/diffuse"}
    got = _run(body2, checkpoint.resume_carry(state, flat, "cpu"), 3)
    _bitwise(spec2.unpad(got.params), spec.unpad(ref.params))
    _same_state(got, ref)


def test_checkpoint_relayout_across_shard_counts(tmp_path):
    spec2, body2, carry2 = _dynamic_setup(2)
    mid = _run(body2, carry2, 3)
    path = os.path.join(tmp_path, "relayout")
    checkpoint.save_flat(path, mid.params, spec2, step=3,
                         state=checkpoint.trajectory_state(mid))
    with open(path + ".json") as f:
        assert "shard" in json.load(f)["metadata"]["flat_layout"]
    finals = {}
    for S in (1, 2, 4):
        spec, body, fresh = _dynamic_setup(S)
        flat, state, _ = checkpoint.restore_flat(
            path, spec, state_like=checkpoint.trajectory_state(fresh),
            device="cpu")
        assert flat.shape[-1] == spec.width
        got = _run(body, checkpoint.resume_carry(state, flat, "cpu"), 3)
        finals[S] = spec.unpad(got.params)
    _bitwise(finals[1], finals[2])
    _bitwise(finals[1], finals[4])


def test_checkpoint_relayout_across_chunk_budgets(tmp_path):
    spec_w, body_w, carry_w = _dynamic_setup(2, max_chunk_cols=64)
    ref = _run(body_w, carry_w, 6)
    mid = _run(body_w, carry_w, 3)
    path = os.path.join(tmp_path, "budget")
    checkpoint.save_flat(path, mid.params, spec_w, step=3,
                         state=checkpoint.trajectory_state(mid))
    with open(path + ".json") as f:
        plan_meta = json.load(f)["metadata"]["flat_layout"]["chunk_plan"]
    assert plan_meta == spec_w.chunk_plan.to_meta()
    assert plan_meta["max_chunk_cols"] == 64
    for S, cap in ((2, None), (2, 13), (4, 200)):
        spec, body, fresh = _dynamic_setup(S, max_chunk_cols=cap)
        flat, state, _ = checkpoint.restore_flat(
            path, spec, state_like=checkpoint.trajectory_state(fresh),
            device="cpu")
        got = _run(body, checkpoint.resume_carry(state, flat, "cpu"), 3)
        _bitwise(spec.unpad(got.params), spec_w.unpad(ref.params))


CLI = ["--device", "cpu", "--hidden", "16", "--workers", "4",
       "--dataset-size", "2000", "--flat-buffer", "--eval-every", "0"]


@pytest.mark.parametrize("extra", [[], ["--model-shards", "2"],
                                   ["--channel-model", "dynamic",
                                    "--scenario", "iot_dense"]],
                         ids=["static", "sharded", "dynamic"])
def test_cli_checkpoint_resumes_bitwise(extra, tmp_path):
    """``--steps 3 --checkpoint`` (4 rounds), restored and run 4 more rounds
    through the trajectory, is bitwise ``--steps 7``."""
    path = str(tmp_path / "cli")
    train.run(CLI + extra + ["--steps", "3", "--checkpoint", path])
    whole = train.run(CLI + extra + ["--steps", "7"])
    args = train.parse_args(CLI + extra + ["--steps", "7"])
    proto = train.protocol_config(args)
    cfg = dataclasses.replace(DWFL_PAPER, d_model=args.hidden)
    wp = P.init_worker_params(torch.Generator(), cfg, args.workers, "cpu")
    spec = X.make_flat_spec(wp, n_shards=args.model_shards)
    x, y = classification_dataset(args.dataset_size, seed=args.seed)
    parts = dirichlet_partition(y, args.workers, alpha=args.dirichlet_alpha,
                                seed=args.seed)
    store = ClassificationStore.build(x, y, parts, args.batch_size, "cpu")
    sim = proto.simulator("cpu") if args.channel_model == "dynamic" else None
    like = {"generator": torch.Generator().get_state()}
    if sim is not None:
        like["net"] = sim.init(torch.Generator())
    flat, state, manifest = checkpoint.restore_flat(path, spec, like, "cpu")
    assert manifest["step"] == 3
    assert manifest["metadata"]["arch"] == "dwfl-paper"
    body = TJ.make_round_body(cfg, proto, store, spec, "cpu", sim=sim)
    carry, out = TJ.run_chunk(body, checkpoint.resume_carry(state, flat,
                                                            "cpu"), 4)
    _bitwise(carry.params, whole["params"])
    _bitwise(out["metrics"]["loss"], whole["losses"][4:])


def test_cli_tree_checkpoint_restores_in_both_packages(tmp_path):
    """Without --flat-buffer the CLI checkpoints the worker tree; the
    reference restores it into its own tree of the same paths."""
    path = str(tmp_path / "tree")
    res = train.run(["--device", "cpu", "--hidden", "16", "--workers", "4",
                     "--steps", "2", "--dataset-size", "2000",
                     "--eval-every", "0", "--checkpoint", path])
    got, manifest = checkpoint.restore(path, res["params"])
    for a, b in zip(X.tree_flatten(got)[0], X.tree_flatten(res["params"])[0]):
        _bitwise(a, b)
    rgot, _ = rckpt.restore(path, _ref_tree(res["params"]))
    for a, b in zip(jax.tree_util.tree_leaves(rgot),
                    X.tree_flatten(res["params"])[0]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert manifest["metadata"]["scheme"] == "dwfl"
