"""The port's worker-tree round (``protocol.make_train_step``) against the
reference's jitted ``make_train_step`` for the four static schemes, with
the local step plain and through the dp_perturb kernel (the reference's
``sgd_update`` per leaf in interpret mode, the port's one-launch
``sgd_update_leaves``, its plain version on the CPU),
replaying the reference's realized ``jax.random`` normals through the
step's ``normals`` argument; a replayed 6-round trajectory; the per-round
(``--no-scan``) executor against the chunked one; and the CLI's
worker-tree runs.

Tolerance of one round: the two packages take the same gradient and the
same normals, and differ by float32 rounding in the gradient products,
the N-term mix and the noise scaling (XLA contracts p - gamma g into a
fused multiply-add where the port's plain local step does not). Measured
on the CPU (N = 4, hidden 16, sigma 0.5, parameters up to 18 after the
round): at most 1.73e-7 relative to 1 + max|x| over the schemes, both
local steps, and with fuse_exchange; the test allows 1e-6. The 6-round
trajectory runs the flat path's configuration (eps = 1 per round,
tests/test_torch_train.py) under its DRIFT_BOUND: measured at most 1.2e-7
over 3 seeds, on parameters of magnitude <= 0.98.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dwfl_paper import CONFIG as REF_CFG
from repro.core import protocol as RP
from repro_torch.configs import DWFL_PAPER
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.core import trajectory as TJ
from repro_torch.data import (FederatedBatcher, classification_dataset,
                              dirichlet_partition)
from repro_torch.kernels.dp_perturb import ops as dp_ops

ROOT = Path(__file__).resolve().parents[1]
N, B, HIDDEN = 4, 8, 16
ROUND_TOL = 1e-6
DRIFT_BOUND = 1e-6
SCHEMES = ("dwfl", "gossip", "orthogonal", "centralized")
# fixed sigma: DP noise of the order of the parameters
KW = dict(n_workers=N, gamma=0.01, eta=0.4, clip=1.0, target_epsilon=0.0,
          sigma=0.5)
# the flat path's trajectory configuration (tests/test_torch_train.py)
EPS1 = dict(KW, target_epsilon=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_normals(scheme, X_ref, k_step, fuse=False):
    """The standard normals the reference's round draws at ``k_step``, in
    the port's {"n", "m"} layout (exchange.py's per-leaf key splits)."""
    k_n, k_m, k_x = jax.random.split(k_step, 3)
    if fuse:
        X_ref = {"flat": jnp.zeros((N, sum(
            int(np.prod(l.shape[1:])) for l in jax.tree_util.tree_leaves(X_ref))))}
    leaves, treedef = jax.tree_util.tree_flatten(X_ref)

    def per_leaf(key, shape_of):
        keys = jax.random.split(key, len(leaves))
        return [np.asarray(jax.random.normal(k, shape_of(x), jnp.float32))
                for k, x in zip(keys, leaves)]

    full = lambda x: x.shape
    if scheme == "gossip":
        return None
    if scheme == "orthogonal":
        pairs = [jax.random.split(k) for k in jax.random.split(k_x, len(leaves))]
        n = [np.asarray(jax.random.normal(p[0], x.shape, jnp.float32))
             for p, x in zip(pairs, leaves)]
        m = [np.asarray(jax.random.normal(p[1], x.shape, jnp.float32))
             for p, x in zip(pairs, leaves)]
    elif scheme == "centralized":
        n = per_leaf(k_n, full)
        m = per_leaf(k_m, lambda x: (1,) + x.shape[1:])
    else:
        n, m = per_leaf(k_n, full), per_leaf(k_m, full)
    to_t = lambda ls: jax.tree_util.tree_unflatten(
        treedef, [torch.from_numpy(np.array(a)) for a in ls])
    return {"n": to_t(n), "m": to_t(m)}


def _tree(wp_ref):
    return X.tree_map(lambda a: torch.from_numpy(np.array(a)),
                      jax.tree_util.tree_map(np.asarray, wp_ref))


def _both(scheme, use_pallas, seed=0, fuse=False, base=KW):
    kw = dict(base, scheme=scheme, use_pallas=use_pallas, fuse_exchange=fuse)
    rcfg = REF_CFG.replace(d_model=HIDDEN)
    wp = RP.init_worker_params(jax.random.PRNGKey(seed), rcfg, N)
    rstep = jax.jit(RP.make_train_step(rcfg, RP.ProtocolConfig(**kw)))
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    step = P.make_train_step(cfg, P.ProtocolConfig(**kw), "cpu")
    x, y = classification_dataset(400, seed=seed)
    batcher = FederatedBatcher(x, y, dirichlet_partition(y, N, seed=seed), B,
                               seed=seed)
    return rstep, wp, step, _tree(wp), batcher


def _flat(tree):
    return np.concatenate([np.asarray(l, np.float32).reshape(N, -1)
                           for l in jax.tree_util.tree_leaves(tree)], axis=1)


def _port_flat(tree):
    return X.flatten_worker_tree(tree).numpy()


def _batch(batcher):
    b = batcher.next()
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "pallas"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_one_tree_round_matches_reference(scheme, use_pallas):
    rstep, rwp, step, wp, batcher = _both(scheme, use_pallas)
    rb, tb = _batch(batcher)
    key = jax.random.PRNGKey(11)
    rout, rm = rstep(rwp, rb, key)
    before = (dp_ops.sgd_update.launches, dp_ops.sgd_update_leaves.launches)
    out, m = step(wp, tb, None, normals=ref_normals(scheme, rwp, key))
    # the CPU runs no kernel
    assert (dp_ops.sgd_update.launches,
            dp_ops.sgd_update_leaves.launches) == before
    want, got = _flat(rout), _port_flat(out)
    err = float(np.abs(got - want).max())
    assert err < ROUND_TOL * (1.0 + float(np.abs(want).max())), err
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                  rel=1e-4)
    assert float(m["param_norm"]) == pytest.approx(float(rm["param_norm"]),
                                                   rel=1e-5)


@pytest.mark.parametrize("scheme", ["dwfl", "gossip"])
def test_fused_exchange_round_matches_reference(scheme):
    """fuse_exchange buckets the tree into one [N, d] leaf for the
    exchange; the noise is then drawn over that one leaf."""
    rstep, rwp, step, wp, batcher = _both(scheme, False, seed=2, fuse=True)
    rb, tb = _batch(batcher)
    key = jax.random.PRNGKey(5)
    rout, _ = rstep(rwp, rb, key)
    out, _ = step(wp, tb, None, normals=ref_normals(scheme, rwp, key, True))
    want, got = _flat(rout), _port_flat(out)
    assert float(np.abs(got - want).max()) < ROUND_TOL * (
        1.0 + float(np.abs(want).max()))


def test_tree_trajectory_replay_stays_within_drift_bound():
    rstep, rwp, step, wp, batcher = _both("dwfl", True, seed=1, base=EPS1)
    key = jax.random.PRNGKey(3)
    drift = []
    for _ in range(6):
        key, sk = jax.random.split(key)
        rb, tb = _batch(batcher)
        normals = ref_normals("dwfl", rwp, sk)
        rwp, _ = rstep(rwp, rb, sk)
        wp, _ = step(wp, tb, None, normals=normals)
        drift.append(float(np.abs(_port_flat(wp) - _flat(rwp)).max()))
    assert max(drift) < DRIFT_BOUND, drift
    assert np.isfinite(_port_flat(wp)).all()


def test_generator_round_draws_n_then_m():
    """Without ``normals`` the step draws {"n", "m"} from the generator
    after the gradients: the same generator state replayed as normals
    gives the same round."""
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    proto = P.ProtocolConfig(**dict(KW, scheme="centralized"))
    step = P.make_train_step(cfg, proto, "cpu")
    wp = P.init_worker_params(torch.Generator().manual_seed(4), cfg, N, "cpu")
    x, y = classification_dataset(400, seed=4)
    batcher = FederatedBatcher(x, y, dirichlet_partition(y, N, seed=4), B)
    _, tb = _batch(batcher)
    out, _ = step(wp, tb, torch.Generator().manual_seed(8))
    normals = X.draw_normals(wp, torch.Generator().manual_seed(8),
                             shared_m=True)
    assert normals["m"]["layers"][0]["w"].shape == (1, 3072, HIDDEN)
    again, _ = step(wp, tb, None, normals=normals)
    torch.testing.assert_close(_port_flat(out), _port_flat(again), rtol=0,
                               atol=0)


def test_no_scan_executor_matches_chunked_body_on_the_same_batches():
    """--no-scan's host-batch source with the per-round executor gives the
    chunked executor's round on the same batches, and both are the step
    applied round by round."""
    x, y = classification_dataset(400, seed=6)
    parts = dirichlet_partition(y, N, seed=6)
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    proto = P.ProtocolConfig(**dict(KW, use_pallas=True))
    wp = P.init_worker_params(torch.Generator().manual_seed(6), cfg, N, "cpu")
    finals = []
    for runner, cuts in ((TJ.run_per_round, (5,)), (TJ.run_chunk, (2, 3))):
        src = TJ.HostBatches(FederatedBatcher(x, y, parts, B, seed=6), "cpu")
        body = TJ.make_round_body(cfg, proto, src, device="cpu")
        carry = TJ.TrajCarry(torch.Generator().manual_seed(9), wp)
        losses = []
        for k in cuts:
            carry, out = runner(body, carry, k)
            losses.append(out["metrics"]["loss"])
        assert torch.cat(losses).shape == (5,)
        finals.append(_port_flat(carry.params))
    step = P.make_train_step(cfg, proto, "cpu")
    batcher = FederatedBatcher(x, y, parts, B, seed=6)
    gen, params = torch.Generator().manual_seed(9), wp
    for _ in range(5):
        params, _ = step(params, _batch(batcher)[1], gen)
    finals.append(_port_flat(params))
    for f in finals[1:]:
        np.testing.assert_array_equal(f, finals[0])


def test_federated_batcher_next_is_bitwise_the_reference():
    from repro.data import FederatedBatcher as RefBatcher
    x, y = classification_dataset(300, seed=3)
    parts = dirichlet_partition(y, 5, seed=3)
    parts[1] = parts[1][:4]          # a pool smaller than the batch
    ours, ref = FederatedBatcher(x, y, parts, 8, seed=7), \
        RefBatcher(x, y, parts, 8, seed=7)
    for _ in range(3):
        a, b = ours.next(), ref.next()
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])


def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--hidden", "16", "--workers", "4", "--steps", "3",
         "--dataset-size", "2000", *argv],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_cli_tree_path_runs_each_scheme(scheme):
    r = _cli("--scheme", scheme, "--no-scan")
    assert r.returncode == 0, r.stderr
    assert f"[train] dwfl-paper scheme={scheme} N=4 eps=" in r.stdout
    assert "per-round loop: host batches" in r.stdout
    assert "(flat dp_mix buffer)" not in r.stdout
    assert "[train] step=    0 loss=" in r.stdout


@pytest.mark.parametrize("scheme", ["orthogonal", "centralized"])
def test_cli_flat_buffer_refuses_the_baselines(scheme):
    r = _cli("--scheme", scheme, "--flat-buffer")
    assert r.returncode != 0
    assert ("--flat-buffer supports the mixing-family schemes only "
            "(dwfl/gossip)") in r.stderr
