"""Neighbor-list mixing on the port (ROADMAP A10) against the reference on
the CPU, at tests/test_sparse.py's sizes (N <= 64, d <= 300, k <= 12).

* The graph: ``geometry._block_topk`` and ``sparse_metropolis`` from the
  reference's positions and masks, replayed — idx, valid and w bitwise
  (ties go to the lower index in both: ``lax.top_k`` and the port's stable
  sort), self_w within 1 ULP (1 - sum w over the k slots; XLA may sum
  them in another order), over block sizes, a cap that gives the disk
  graph, and the fallback. ``sparsify_dense`` bitwise, tied weights and
  all.
* The round: ``dp_mix_sparse_plain`` (through ``ops.dp_mix_round_sparse``)
  against the reference's ``dp_mix_sparse_jnp``: 1e-6 on the identity
  graph, 1e-5 over the graph sweep (the reference test's tolerances: both
  sum in slot order, XLA fuses the chain differently); column windows
  reassemble the whole round bitwise; the two noise fields bitwise the
  dense round's and the plain generator's.
* The plan, the exchange, epsilon and sigma: ``plan_dynamic_sparse`` and
  ``mix_exchange_sparse`` against the reference's and against the dense
  plan of ``SparseW.dense()`` (1e-5); the sparse budgets and sigma against
  the dense formula (rtol 1e-5, atol 1e-7) and the reference's; a stacked
  ``epsilon_report`` with the reference's keys (rtol 2e-6, as
  tests/test_torch_dynamic.py holds the dense one).
* The steps: the dynamic sparse flat and tree rounds, and three flat
  rounds in a row, against the reference on its realized channels,
  neighbor lists, parameters, batches and noise (atol 1e-6 * scale, as
  tests/test_torch_dynamic.py); the port's own sparse trajectory the same
  however it is cut into chunks; the CLI.
* No [N, N] tensor is made in a sparse round: every operator's output
  shape is watched.
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
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.dwfl_paper import CONFIG as REF_CFG
from repro.core import exchange as RX
from repro.core import privacy as rprivacy
from repro.core import protocol as RP
from repro.kernels.dp_mix import ops as rops
from repro.net import geometry as RG
from repro.net.sparse import sparsify_dense as ref_sparsify_dense
from repro_torch.configs import DWFL_PAPER
from repro_torch.convert import params_from_jax
from repro_torch.core import accounting, privacy
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.core import trajectory as TJ
from repro_torch.data import (ClassificationStore, FederatedBatcher,
                              classification_dataset, dirichlet_partition)
from repro_torch.kernels import noise
from repro_torch.kernels.dp_mix import ops
from repro_torch.kernels.dp_perturb import ops as dp_ops
from repro_torch.net import geometry as G
from repro_torch.net.sparse import (SparseW, cat_w, isolated_count, stack_w,
                                    sparsify_dense)
from repro_torch.net.state import FIELDS
from test_torch_net import port_chan, t
from test_torch_protocol import _batch, _port_flat, _tree

ROOT = Path(__file__).resolve().parents[1]
SWEEP = [(8, 2), (8, 4), (32, 3), (32, 6), (64, 4), (64, 12)]
N, B, HIDDEN, K = 8, 8, 16, 3
KW = dict(scheme="dwfl", n_workers=N, gamma=0.01, eta=0.4, clip=1.0,
          target_epsilon=0.0, sigma=0.5, channel_model="dynamic",
          scenario="iot_dense", sparse_neighbors=K)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the reference's graph builders compiled once per shape (eager, each of
# their operators compiles at every new shape: seconds a call)
ref_sparse_metropolis = jax.jit(RG.sparse_metropolis,
                                static_argnames=("cfg", "k", "fallback",
                                                 "block"))
ref_block_topk = jax.jit(RG._block_topk,
                         static_argnames=("k", "radius", "block"))


def ref_rounds(scenario, n, seed, rounds, **kw):
    """``test_torch_net.ref_round`` with the reference's round compiled
    once (eager, a round takes seconds): (simulator, its jitted round, the
    network state, channel, mask and W after ``rounds`` rounds)."""
    from repro.net import scenarios as rscenarios
    from repro.net import simulator as rsimulator
    sim = rsimulator.NetworkSimulator(rscenarios.get_scenario(scenario), n,
                                      **kw)
    step = jax.jit(sim.round)
    st = sim.init(jax.random.PRNGKey(seed))
    k = jax.random.PRNGKey(seed + 1)
    for _ in range(rounds):
        k, kk = jax.random.split(k)
        st, chan, mask, W = step(kk, st)
    return sim, step, st, chan, mask, W


def _radius(n, area=100.0):
    # ~8 expected in-disk neighbors whatever N (the reference test's)
    return float(area * np.sqrt(8.0 / (np.pi * n)))


def _pos(seed, n, area=100.0):
    return jax.random.uniform(jax.random.PRNGKey(seed), (n, 2),
                              jnp.float32) * area


def port_sw(sw) -> SparseW:
    """The reference's realized SparseW, replayed."""
    return SparseW(t(sw.idx), t(sw.w), t(sw.self_w))


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def _graph(trial, n, k, fallback=False, blocks=(0,), radius=None):
    """The reference's capped graph (built unblocked; its own test holds
    every block size bitwise to it) and the port's at each of ``blocks``,
    from the same positions and churn mask."""
    kp, km = jax.random.split(jax.random.PRNGKey(100 + trial))
    pos = _pos(100 + trial, n) if radius is None else _pos(7 + n, n)
    mask = jax.random.bernoulli(km, 0.8, (n,)) if trial % 2 else None
    r = _radius(n) if radius is None else radius
    ref = ref_sparse_metropolis(RG.GeometryConfig(area=100.0, comm_radius=r),
                                pos, k=k, mask=mask, fallback=fallback)
    got = [G.sparse_metropolis(
        G.GeometryConfig(area=100.0, comm_radius=r), t(pos), k,
        mask=None if mask is None else t(mask), fallback=fallback,
        block=block) for block in blocks]
    return ref, got, pos, mask


# ---------------------------------------------------------------------------
# the graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fallback", [False, True], ids=["plain", "fallback"])
@pytest.mark.parametrize("trial,n,k", [(i, n, k) for i, (n, k)
                                       in enumerate(SWEEP)])
def test_sparse_metropolis_equals_reference(trial, n, k, fallback):
    """idx and w bitwise, self_w within 1 ULP, for every block size; the
    port's own properties: padded slots self-pointing with weight 0,
    symmetric and doubly stochastic, degree <= k, churned-out rows
    empty."""
    ref, gots, _, mask = _graph(trial, n, k, fallback, blocks=(0, 5, 16))
    for got in gots:
        assert got.idx.dtype == torch.int32 and got.idx.shape == (n, k)
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
        np.testing.assert_array_equal(got.w.numpy(), np.asarray(ref.w))
        assert _ulps(got.self_w, ref.self_w).max() <= 1
        np.testing.assert_array_equal(got.off_degree().numpy(),
                                      np.asarray(ref.off_degree()))
    idx, w = got.idx.numpy(), got.w.numpy()
    rows = np.broadcast_to(np.arange(n)[:, None], (n, k))
    assert np.array_equal(idx[w == 0], rows[w == 0])
    assert ((w > 0).sum(1) <= k).all()
    if mask is not None:
        assert not (w > 0)[~np.asarray(mask)].any()
    if not fallback:
        Wd = got.dense().numpy()
        np.testing.assert_allclose(Wd, Wd.T, atol=1e-6)
        np.testing.assert_allclose(Wd.sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("k,radius", [(1, 0.0), (4, 20.0), (63, 30.0)])
@pytest.mark.parametrize("masked", [False, True])
def test_block_topk_equals_reference(k, radius, masked):
    """Each worker's k nearest, bitwise the reference's (unblocked: its own
    test holds every block size to it) at every block size (the last
    block's rows clipped and cut off), ties toward the lower index — the
    unit grid ties every distance."""
    n = 64
    grid = jnp.stack(jnp.meshgrid(jnp.arange(8.0), jnp.arange(8.0)),
                     -1).reshape(n, 2) * 10.0
    mask = (jnp.arange(n) % 5 != 0) if masked else None
    for pos in (grid, _pos(3, n)):
        ridx, rvalid = ref_block_topk(pos, k=k, radius=radius, mask=mask)
        for block in (0, 7, 16, 64):
            idx, valid = G._block_topk(t(pos), k, radius=radius,
                                       mask=None if mask is None else t(mask),
                                       block=block)
            np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
            np.testing.assert_array_equal(
                np.where(valid.numpy(), idx.numpy(), -1),
                np.where(np.asarray(rvalid), np.asarray(ridx), -1))
    with pytest.raises(ValueError, match="degree cap"):
        G._block_topk(t(grid), 0, radius=0.0)


@pytest.mark.parametrize("n", [8, 32])
def test_capped_graph_is_disk_graph_when_k_large(n):
    """k = N - 1: the capped graph is the disk graph, and SparseW.dense()
    is the dense Metropolis W (up to the order of self_w's sum)."""
    r = _radius(n) * 1.5
    _, (got,), pos, _ = _graph(0, n, n - 1, radius=r)
    cfg = G.GeometryConfig(area=100.0, comm_radius=r)
    Wd = G.metropolis_weights(G.adjacency(cfg, t(pos))).numpy()
    Ws = got.dense().numpy()
    assert np.array_equal(Ws > 0, Wd > 0)
    np.testing.assert_allclose(Ws, Wd, atol=2e-6)


def test_fallback_bridges_isolated_workers():
    """An out-of-radius worker is isolated without the fallback and has one
    nearest-neighbor edge with it; a churned-out worker is not counted as
    isolated; the reference's counts."""
    n = 12
    pos = _pos(3, n, area=50.0).at[0].set(jnp.array([5000.0, 5000.0]))
    cfg = G.GeometryConfig(area=50.0, comm_radius=40.0)
    sw = G.sparse_metropolis(cfg, t(pos), 4)
    assert int(isolated_count(sw)) >= 1 and float(sw.off_degree()[0]) == 0.0
    swf = G.sparse_metropolis(cfg, t(pos), 4, fallback=True)
    assert int(isolated_count(swf)) == 0
    assert float(swf.off_degree()[0]) == 1.0
    mask = torch.ones(n).index_fill(0, torch.tensor([0]), 0.0)
    swm = G.sparse_metropolis(cfg, t(pos), 4, mask=mask)
    assert int(isolated_count(swm, mask)) == int(isolated_count(swm)) - 1
    rcfg = RG.GeometryConfig(area=50.0, comm_radius=40.0)
    for fb in (False, True):
        ref = ref_sparse_metropolis(rcfg, pos, k=4, fallback=fb)
        got = G.sparse_metropolis(cfg, t(pos), 4, fallback=fb)
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
        np.testing.assert_array_equal(got.w.numpy(), np.asarray(ref.w))


@pytest.mark.parametrize("k", [1, 2, 3, 5, 15])
def test_sparsify_dense_equals_reference_with_ties(k):
    """Metropolis weights tie all the time: the kept slots are the
    reference's (the lower index first) bitwise, and with k >= the
    largest degree dense() gives W back bitwise."""
    pos = _pos(11, 16)
    W = RG.metropolis_weights(RG.adjacency(
        RG.GeometryConfig(area=100.0, comm_radius=_radius(16)), pos))
    Wn = np.asarray(W)
    assert len(np.unique(Wn[Wn > 0])) < (Wn > 0).sum()      # ties exist
    ref, got = ref_sparsify_dense(W, k), sparsify_dense(t(W), k)
    for f in ("idx", "w", "self_w"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    offd = (Wn > 0) & ~np.eye(16, dtype=bool)
    if k >= offd.sum(1).max():
        np.testing.assert_array_equal(got.dense().numpy(), Wn)


def test_sparse_w_layout_stacking_and_refusals():
    ref, (got,), _, _ = _graph(2, 32, 3)
    assert got.layout_meta() == ref.layout_meta()
    stacked = stack_w([got, got, got])
    assert stacked.idx.shape == (3, 32, 3) and stacked.n_workers == 32
    joined = cat_w([stacked[:1], stacked[1:]])
    for f in ("idx", "w", "self_w"):
        assert torch.equal(getattr(joined, f), getattr(stacked, f))
        assert torch.equal(getattr(stacked[2], f), getattr(got, f))
    np.testing.assert_array_equal(isolated_count(stacked).numpy(),
                                  [int(isolated_count(got))] * 3)
    with pytest.raises(ValueError, match="unbatched"):
        stacked.dense()


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------


def _round_args(key, n, d):
    ks = jax.random.split(key, 4)
    p = jax.random.normal(ks[0], (n, d), jnp.float32)
    g = jax.random.normal(ks[1], (n, d), jnp.float32) * 0.1
    amp = jax.random.uniform(ks[2], (n,)) + 0.5
    mscale = jax.random.uniform(ks[3], (n,)) * 0.3
    return p, g, amp, mscale


@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "gossip"])
def test_sparse_round_identity_graph(noisy):
    """Empty lists (self_w = 1): the sparse round against the reference's
    and the port's dense round with W = I, within 1e-6."""
    n, d = 16, 40
    p, g, amp, mscale = _round_args(jax.random.PRNGKey(0), n, d)
    rows = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], (n, 2))
    from repro.net.sparse import SparseW as RSparseW
    rsw = RSparseW(idx=rows, w=jnp.zeros((n, 2), jnp.float32),
                   self_w=jnp.ones((n,), jnp.float32))
    want = rops.dp_mix_round_sparse(p, g, jnp.int32(77), rsw, amp, 2.0, 0.3,
                                    gamma=0.05, eta=0.4, m_scale=mscale,
                                    noisy=noisy)
    kw = dict(gamma=0.05, eta=0.4, m_scale=t(mscale), noisy=noisy)
    got = ops.dp_mix_round_sparse(t(p), t(g), 77, port_sw(rsw), t(amp), 2.0,
                                  0.3, **kw)
    dense = ops.dp_mix_round(t(p), t(g), 77, torch.eye(n), t(amp), 2.0, 0.3,
                             **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "gossip"])
@pytest.mark.parametrize("trial,n,k", [(i, n, k) for i, (n, k)
                                       in enumerate(SWEEP + [(13, 5)])])
def test_sparse_round_matches_reference_sweep(trial, n, k, noisy):
    """dp_mix_round_sparse's plain twin against the reference's
    dp_mix_sparse_jnp and the port's dense round of SparseW.dense(), 1e-5,
    on the reference's graph; N = 13 pads to 16 rows."""
    kp, kr = jax.random.split(jax.random.PRNGKey(200 + trial))
    rsw = ref_sparse_metropolis(
        RG.GeometryConfig(area=100.0, comm_radius=_radius(n)),
        jax.random.uniform(kp, (n, 2)) * 100.0, k=k)
    p, g, amp, mscale = _round_args(kr, n, 40)
    want = rops.dp_mix_round_sparse(p, g, jnp.int32(5 + trial), rsw, amp, 2.0,
                                    0.3, gamma=0.05, eta=0.4, m_scale=mscale,
                                    noisy=noisy)
    sw = port_sw(rsw)
    kw = dict(gamma=0.05, eta=0.4, m_scale=t(mscale), noisy=noisy)
    before = ops.dp_mix_round_sparse.launches
    got = ops.dp_mix_round_sparse(t(p), t(g), 5 + trial, sw, t(amp), 2.0, 0.3,
                                  **kw)
    assert ops.dp_mix_round_sparse.launches == before     # the CPU's twin
    assert got.shape == (n, 40)
    dense = ops.dp_mix_round(t(p), t(g), 5 + trial, sw.dense(), t(amp), 2.0,
                             0.3, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_sparse_round_column_windows_bitwise():
    """Two half-width windows with their global col0 and the full
    counter_width reassemble the whole round bitwise, as in the
    reference."""
    n, d = 16, 256
    sw = G.sparse_metropolis(G.GeometryConfig(area=100.0,
                                              comm_radius=_radius(n)),
                             t(_pos(2, n)), 4)
    p, g, amp, mscale = (t(a) for a in _round_args(jax.random.PRNGKey(3), n,
                                                   d))
    kw = dict(gamma=0.05, eta=0.4, m_scale=mscale)
    full = ops.dp_mix_round_sparse(p, g, 21, sw, amp, 2.0, 0.3, **kw)
    halves = [ops.dp_mix_round_sparse(p[:, c:c + 128], g[:, c:c + 128], 21,
                                      sw, amp, 2.0, 0.3, col0=c,
                                      counter_width=d, **kw)
              for c in (0, 128)]
    assert torch.equal(full, torch.cat(halves, dim=1))


@pytest.mark.parametrize("n,d,col0", [(8, 300, 0), (13, 200, 512)])
def test_sparse_noise_fields_bitwise_the_dense_rounds(n, d, col0):
    """p = g = 0, amp = c = 1, self = m_scale = 0 on the identity list
    gives out = Gn; w = self_w = amp = self = 0, m_scale = sigma_m = 1
    gives out = Gm: both bitwise the dense round's (W = I, W = 0) and the
    plain generator's fields at the same seed, col0 and counter_width."""
    cw = 1024
    zeros = torch.zeros((n, d))
    one, zero = torch.ones(n), torch.zeros(n)
    rows = torch.arange(n, dtype=torch.int32)[:, None].expand(n, 3)
    fields = noise.normal_pair_hash((n, d), cw, col0, 4242)
    kw = dict(gamma=0.0, eta=1.0, col0=col0, counter_width=cw)
    for field, amp, ms, sw, W in (
            (fields[0], one, zero, SparseW(rows, torch.zeros(n, 3), one),
             torch.eye(n)),
            (fields[1], zero, one, SparseW(rows, torch.zeros(n, 3), zero),
             torch.zeros((n, n)))):
        got = ops.dp_mix_round_sparse(zeros, zeros, 4242, sw, amp, 1.0, 1.0,
                                      self_scale=zero, m_scale=ms, **kw)
        dense = ops.dp_mix_round(zeros, zeros, 4242, W, amp, 1.0, 1.0,
                                 self_scale=zero, m_scale=ms, **kw)
        bits = lambda a: a.contiguous().view(torch.int32)
        assert torch.equal(bits(got), bits(field))
        assert torch.equal(bits(dense), bits(field))


def test_sparse_round_refuses_the_counter_wrap_and_bad_lists():
    sw = G.sparse_metropolis(G.GeometryConfig(area=100.0, comm_radius=40.0),
                             t(_pos(1, 8)), 2)
    p = torch.zeros((8, 16))
    with pytest.raises(ValueError, match="exceeds 2\\^31"):
        ops.dp_mix_round_sparse(p, p, 1, sw, torch.ones(8), 1.0, 1.0,
                                gamma=0.1, eta=0.4, counter_width=1 << 29)
    with pytest.raises(ValueError, match="neighbor list"):
        ops.dp_mix_round_sparse(p[:6], p[:6], 1, sw, torch.ones(6), 1.0, 1.0,
                                gamma=0.1, eta=0.4)


def test_sparse_argtypes_follow_the_c_entry():
    """One SPARSE_ARGTYPES entry per parameter of dp_mix_sparse_launch, of
    the C parameter's kind (a missing entry shifts every argument after
    it, and ctypes cuts a pointer passed as an int to 32 bits)."""
    import ctypes
    import re
    text = (ops._CSRC / "dp_mix.cu").read_text()
    sig = re.search(r"int dp_mix_sparse_launch\(([^)]*)\)\s*\{",
                    text).group(1)
    params = [" ".join(a.split()[:-1]) for a in sig.split(",")]
    assert len(params) == len(ops.SPARSE_ARGTYPES)
    for c_type, py in zip(params, ops.SPARSE_ARGTYPES):
        want = (ctypes.c_void_p if "*" in c_type else
                ctypes.c_float if c_type == "float" else
                ctypes.c_uint if "unsigned" in c_type else ctypes.c_int)
        assert py is want, (c_type, py)


# ---------------------------------------------------------------------------
# plan, exchange, epsilon
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sparse_round():
    """A realized iot_dense round of the reference with a neighbor list
    (k = 3) and sigma 0.5: some workers churned out or isolated."""
    *_, rchan, rmask, rW = ref_rounds("iot_dense", N, 7, rounds=4,
                                      sigma=0.5, sigma_m=0.3, p_dbm=30.0,
                                      sparse_k=K)
    deg = np.asarray(rW.off_degree())
    assert (deg == 0).any() and (deg > 0).sum() >= 2
    return rchan, rW


def _scale(plan, x):
    return 1.0 + float(np.abs(x).max()) + 5.42 * float(
        (plan.amp / plan.c).abs().max())


def test_plan_dynamic_sparse_equals_reference_and_dense_plan(sparse_round):
    rchan, rW = sparse_round
    chan, sw = port_chan(rchan), port_sw(rW)
    plan = X.plan_dynamic_sparse(P.ProtocolConfig(**KW), chan, "cpu", sw)
    rplan = RX.plan_dynamic_sparse(RP.ProtocolConfig(**KW), rchan, W_arg=rW)
    dense = X.plan_dynamic(None, chan, "cpu", sw.dense())
    assert isinstance(plan.W, SparseW)
    for f in ("c", "amp", "sigma_m", "m_scale", "listen"):
        np.testing.assert_allclose(np.asarray(getattr(plan, f)),
                                   np.asarray(getattr(rplan, f)), rtol=1e-6,
                                   err_msg=f)
        assert torch.equal(getattr(plan, f), getattr(dense, f)), f
    assert (plan.listen == 0).any()
    p, g, _, _ = (t(a) for a in _round_args(jax.random.PRNGKey(4), N, 24))
    out_s = ops.dp_mix_round_plan(p, g, 9, plan, gamma=0.05, eta=0.4)
    out_d = ops.dp_mix_round_plan(p, g, 9, dense, gamma=0.05, eta=0.4)
    np.testing.assert_allclose(out_s.numpy(), out_d.numpy(), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="mixing matrix"):
        X.plan_dynamic_sparse(None, chan, "cpu")


def test_mix_exchange_sparse_equals_reference_and_dense(sparse_round):
    """The worker-tree mix through the neighbor list on replayed noise:
    the reference's, and the port's dense exchange of SparseW.dense(),
    1e-5."""
    rchan, rW = sparse_round
    key = jax.random.PRNGKey(5)
    Xr = {"a": jax.random.normal(key, (N, 7)),
          "b": jax.random.normal(jax.random.fold_in(key, 1), (N, 3, 4))}
    nr = jax.tree_util.tree_map(
        lambda x: 0.3 * jax.random.normal(jax.random.fold_in(key, 2),
                                          x.shape), Xr)
    mr = jax.tree_util.tree_map(
        lambda x: 0.2 * jax.random.normal(jax.random.fold_in(key, 3),
                                          x.shape), Xr)
    rplan = RX.plan_dynamic_sparse(None, rchan, W_arg=rW)
    want = RX.run_mix(Xr, nr, mr, 0.4, rplan)
    chan, sw = port_chan(rchan), port_sw(rW)
    tree = lambda tr: X.tree_map(lambda a: t(a), jax.tree_util.tree_map(
        np.asarray, tr))
    got = X.run_mix(tree(Xr), tree(nr), tree(mr), 0.4,
                    X.plan_dynamic_sparse(None, chan, "cpu", sw))
    dense = X.run_mix(tree(Xr), tree(nr), tree(mr), 0.4,
                      X.plan_dynamic(None, chan, "cpu", sw.dense()))
    for name in ("a", "b"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[name].numpy(), dense[name].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_epsilon_and_sigma_sparse_match_dense_formula():
    """mesh_sparse rounds (N = 32, k = 3): the budgets and sigma from the
    neighbor list against the dense formula of SparseW.dense() (rtol 1e-5,
    atol 1e-7) and the reference's; listening masks exactly; the RDP
    ledger's traced functions too."""
    _, step, rst, _, _, _ = ref_rounds("mesh_sparse", 32, 5, rounds=1,
                                       sparse_k=3)
    key = jax.random.PRNGKey(6)
    for r in range(3):
        rst, rchan, _, rW = step(jax.random.fold_in(key, r), rst)
        chan, sw = port_chan(rchan), port_sw(rW)
        eps_s = privacy.epsilon_dwfl_traced(0.05, 1.0, chan, 1e-5, W=sw)
        eps_d = privacy.epsilon_dwfl_traced(0.05, 1.0, chan, 1e-5,
                                            W=sw.dense())
        eps_r = rprivacy.epsilon_dwfl_traced(0.05, 1.0, rchan, 1e-5, W=rW)
        np.testing.assert_allclose(eps_s.numpy(), eps_d.numpy(), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(eps_s.numpy(), np.asarray(eps_r),
                                   rtol=1e-5, atol=1e-7)
        assert torch.equal(eps_s > 0, eps_d > 0)
        sig = [f(1.0, 0.05, 1.0, chan, 1e-5, W=w) for f, w in
               ((privacy.sigma_for_epsilon_traced, sw),
                (privacy.sigma_for_epsilon_traced, sw.dense()))]
        np.testing.assert_allclose(sig[0].numpy(), sig[1].numpy(), rtol=1e-5)
        np.testing.assert_allclose(
            sig[0].numpy(), np.asarray(rprivacy.sigma_for_epsilon_traced(
                1.0, 0.05, 1.0, rchan, 1e-5, W=rW)), rtol=1e-5)
        for f, args in ((accounting.rdp_dwfl_traced, (0.05, 1.0, chan)),
                        (accounting.sigma_for_rho_traced,
                         (0.01, 0.05, 1.0, chan))):
            np.testing.assert_allclose(f(*args, W=sw).numpy(),
                                       f(*args, W=sw.dense()).numpy(),
                                       rtol=1e-5, atol=1e-7)


def test_stacked_sparse_epsilon_report_equals_reference():
    """A 4-round trajectory's stacked neighbor lists ([T, N, k] leaves):
    the port's epsilon_report from the reference's realized channels and
    lists has the reference's keys and values (rtol 2e-6), and each
    round's budgets are those of the round alone, bitwise."""
    rsim, _, rst, _, _, _ = ref_rounds("iot_dense", N, 8, rounds=1,
                                       sparse_k=K)
    rchans, _, rWs = rsim.trajectory(jax.random.PRNGKey(9), 4, rst)
    assert rWs.idx.shape == (4, N, K)
    kw = dict(scheme="dwfl", n_workers=N, gamma=0.05, clip=1.0,
              channel_model="dynamic", scenario="iot_dense",
              sparse_neighbors=K)
    chans, sws = port_chan(rchans), port_sw(rWs)
    rep = P.epsilon_report(P.ProtocolConfig(**kw), chans, Ws=sws)
    rrep = RP.epsilon_report(RP.ProtocolConfig(**kw), rchans, Ws=rWs)
    assert set(rep) == set(rrep)
    for k, v in rrep.items():
        if isinstance(v, (str, bool, int)) or k == "rdp_order":
            assert rep[k] == v, k
        else:
            np.testing.assert_allclose(rep[k], v, rtol=2e-6, err_msg=k)
    per_round = privacy.epsilon_trajectory(0.05, 1.0, chans, 1e-5, sws)
    for r in range(4):
        chan_r = dataclasses.replace(chans, **{f: getattr(chans, f)[r]
                                               for f in FIELDS})
        one = privacy.epsilon_dwfl_traced(0.05, 1.0, chan_r, 1e-5, sws[r])
        assert torch.equal(per_round[r], one)


# ---------------------------------------------------------------------------
# the dynamic sparse rounds against the reference
# ---------------------------------------------------------------------------


def _flat_both(seed=0):
    rcfg = REF_CFG.replace(d_model=HIDDEN)
    wp = RP.init_worker_params(jax.random.PRNGKey(seed), rcfg, N)
    rspec = RX.FlatSpec(wp)
    rstep = jax.jit(RP.make_dynamic_flat_train_step(
        rcfg, RP.ProtocolConfig(**KW), rspec.unravel_row))
    flat, _, spec = params_from_jax(jax.tree_util.tree_map(np.asarray, wp),
                                    device="cpu")
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    step = P.make_dynamic_flat_train_step(cfg, P.ProtocolConfig(**KW), spec,
                                          "cpu")
    x, y = classification_dataset(400, seed=seed)
    parts = dirichlet_partition(y, N, seed=seed)
    from repro.data import device as ref_device
    rstore = ref_device.ClassificationStore.build(x, y, parts, B)
    store = ClassificationStore.build(x, y, parts, B, device="cpu")
    return rstep, rspec.flatten(wp), rstore, step, flat, store


def test_dynamic_sparse_flat_rounds_match_reference():
    """Three dynamic sparse flat rounds in a row, each from the reference's
    realized channel, neighbor list, batch uniforms and noise seed: every
    round's buffer within atol 1e-6 * scale of the reference's, its loss
    within rtol 1e-5; one route the whole way (the neighbor list: no
    dense dp_mix_round)."""
    _, net_round, rst, _, _, _ = ref_rounds("iot_dense", N, 7, rounds=1,
                                            sigma=0.5, sigma_m=0.3,
                                            p_dbm=30.0, sparse_k=K)
    rstep, rflat, rstore, step, flat, store = _flat_both()
    key = jax.random.PRNGKey(11)
    dense_before = ops.dp_mix_round.launches
    for r in range(3):
        key, k_net, k_data, k_step = jax.random.split(key, 4)
        rst, rchan, _, rW = net_round(k_net, rst)
        rflat, rm = rstep(rflat, rstore.sample(k_data), k_step, rchan, rW)
        u = torch.from_numpy(np.array(jax.random.uniform(k_data, (N, B))))
        seed = ops.seed_from_key(np.asarray(jax.random.split(k_step)[0]))
        chan, sw = port_chan(rchan), port_sw(rW)
        flat, m = step(flat, store.sample(u), seed, chan, sw)
        want = np.asarray(rflat)
        plan = X.plan_dynamic_sparse(None, chan, "cpu", sw)
        np.testing.assert_allclose(flat.numpy(), want, rtol=0,
                                   atol=1e-6 * _scale(plan, want),
                                   err_msg=f"round {r}")
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
        flat = torch.from_numpy(np.array(want))    # next round from the same
    assert ops.dp_mix_round.launches == dense_before


def _tree_normals(X_ref, key):
    """``test_torch_dynamic._dynamic_normals`` drawn in one compiled call:
    the step key splits in two, each half per leaf."""
    leaves, treedef = jax.tree_util.tree_flatten(X_ref)

    def draw(key):
        return [[jax.random.normal(k, x.shape, jnp.float32)
                 for k, x in zip(jax.random.split(half, len(leaves)), leaves)]
                for half in jax.random.split(key)]

    n, m = jax.jit(draw)(key)
    tree = lambda ls: jax.tree_util.tree_unflatten(
        treedef, [torch.from_numpy(np.array(a)) for a in ls])
    return {"n": tree(n), "m": tree(m)}


def test_one_dynamic_sparse_tree_round_matches_reference(sparse_round):
    """With use_pallas: the local step's dp_perturb wrapper (its plain twin
    here) and the neighbor-list exchange."""
    rchan, rW = sparse_round
    kw = dict(KW, use_pallas=True)
    rcfg = REF_CFG.replace(d_model=HIDDEN)
    rwp = RP.init_worker_params(jax.random.PRNGKey(1), rcfg, N)
    rstep = jax.jit(RP.make_dynamic_train_step(rcfg, RP.ProtocolConfig(**kw)))
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    step = P.make_dynamic_train_step(cfg, P.ProtocolConfig(**kw), "cpu")
    x, y = classification_dataset(400, seed=1)
    batcher = FederatedBatcher(x, y, dirichlet_partition(y, N, seed=1), B,
                               seed=1)
    rb, tb = _batch(batcher)
    key = jax.random.PRNGKey(3)
    rout, rm = rstep(rwp, rb, key, rchan, rW)
    before = dp_ops.sgd_update_leaves.launches
    out, m = step(_tree(rwp), tb, None, port_chan(rchan), port_sw(rW),
                  normals=_tree_normals(rwp, key))
    assert dp_ops.sgd_update_leaves.launches == before
    want = np.concatenate([np.asarray(l).reshape(N, -1)
                           for l in jax.tree_util.tree_leaves(rout)], axis=1)
    plan = X.plan_dynamic_sparse(None, port_chan(rchan), "cpu", port_sw(rW))
    np.testing.assert_allclose(_port_flat(out), want, rtol=0,
                               atol=1e-6 * _scale(plan, want))
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)


def _sparse_body(flat: bool, n=16, seed=2):
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    proto = P.ProtocolConfig(**dict(KW, n_workers=n, scenario="mesh_sparse",
                                    graph_fallback=True))
    wp = P.init_worker_params(torch.Generator().manual_seed(seed), cfg, n,
                              "cpu")
    spec = X.FlatSpec(wp) if flat else None
    x, y = classification_dataset(400, seed=seed)
    store = ClassificationStore.build(x, y, dirichlet_partition(y, n,
                                                                seed=seed),
                                      B, device="cpu")
    sim = proto.simulator("cpu")
    body = TJ.make_round_body(cfg, proto, store, spec, "cpu", sim=sim)
    g = torch.Generator().manual_seed(9)
    return body, TJ.TrajCarry(g, spec.flatten(wp) if flat else wp,
                              sim.init(g))


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "tree"])
def test_sparse_trajectory_chunks_do_not_change_the_stream(flat):
    """The port's own sparse trajectory: 3 rounds as one chunk or as 1 + 2
    give the same parameters and neighbor lists; the stacked lists are a
    SparseW of [3, N, k] leaves."""
    finals = []
    for parts in ((3,), (1, 2)):
        body, carry = _sparse_body(flat)
        outs = []
        for k in parts:
            carry, out = TJ.run_chunk(body, carry, k)
            outs.append(out)
        finals.append((carry, TJ.concat_chunks(outs)["W"]))
    (c1, w1), (c2, w2) = finals
    assert isinstance(w1, SparseW) and w1.idx.shape == (3, 16, K)
    p1, p2 = ((c.params,) if flat else X.tree_flatten(c.params)[0]
              for c in (c1, c2))
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)
    for f in ("idx", "w", "self_w"):
        assert torch.equal(getattr(w1, f), getattr(w2, f))


class _Shapes(TorchDispatchMode):
    """Records the shape of every operator's tensor outputs."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.shapes.append(tuple(o.shape))
        return out


def test_no_n_by_n_tensor_in_a_sparse_round():
    """A whole dynamic sparse flat round at N = 32 (graph_block 8: the
    simulator, the plan, the gradients, the mix, the metrics) makes no
    tensor with two axes of N; its graph build's largest transient is
    [8, N]. The dense simulator round of the same scenario does make
    [N, N] ones (the watcher sees them)."""
    n = 32
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    wp = P.init_worker_params(torch.Generator().manual_seed(0), cfg, n, "cpu")
    spec = X.FlatSpec(wp)
    x, y = classification_dataset(400, seed=0)
    store = ClassificationStore.build(x, y, dirichlet_partition(y, n, seed=0),
                                      B, device="cpu")
    proto = P.ProtocolConfig(**dict(KW, n_workers=n, sparse_neighbors=12,
                                    scenario="mesh_sparse"))
    sim = proto.simulator("cpu")
    sim.graph_block = 8
    body = TJ.make_round_body(cfg, proto, store, spec, "cpu", sim=sim)
    g = torch.Generator().manual_seed(1)
    carry = TJ.TrajCarry(g, spec.flatten(wp), sim.init(g))
    with _Shapes() as sparse:
        body(carry)
    nn = [s for s in sparse.shapes if sum(a == n for a in s) >= 2]
    assert not nn, nn
    assert (8, n) in sparse.shapes
    dense = P.ProtocolConfig(**dict(KW, n_workers=n, sparse_neighbors=0,
                                    scenario="mesh_sparse")).simulator("cpu")
    with _Shapes() as watch:
        dense.round(g, dense.init(g))
    assert any(sum(a == n for a in s) >= 2 for s in watch.shapes)


def test_simulator_sparse_k_checks_and_default_block():
    from repro_torch.net import get_scenario
    from repro_torch.net.simulator import NetworkSimulator
    scn = get_scenario("mesh_sparse")
    sim = NetworkSimulator(scn, 2048, sparse_k=12, device="cpu")
    assert (sim.sparse_k, sim.graph_block) == (12, 1024)
    assert NetworkSimulator(scn, 40, sparse_k=4, device="cpu").graph_block == 40
    with pytest.raises(ValueError, match="exceeds n_workers"):
        NetworkSimulator(scn, 8, sparse_k=9, device="cpu")
    with pytest.raises(ValueError, match="unit-disk"):
        NetworkSimulator(get_scenario("static_paper"), 8, sparse_k=4,
                         device="cpu")


def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--hidden", "16", "--workers", "16", "--steps", "2",
         "--dataset-size", "2000", "--channel-model", "dynamic",
         "--scenario", "mesh_sparse", "--sparse-neighbors", "4", *argv],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)


def test_sparse_cli_runs_on_cpu():
    r = _cli("--flat-buffer")
    assert r.returncode == 0, r.stderr
    assert ("[train] dwfl-paper scheme=dwfl N=16 dynamic scenario=mesh_sparse "
            "coherence=10 rounds") in r.stdout
    assert "active workers isolated in the first graph draw" in r.stdout
    assert "[train] per-round eps over 3 rounds: min=" in r.stdout
    assert "[train] accountant[" in r.stdout and "-> quoting" in r.stdout


def test_sparse_neighbors_need_the_dynamic_channel():
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match="requires --channel-model dynamic"):
        train.parse_args(["--sparse-neighbors", "4"])


def test_chip_smoke_sparse_bound_at_the_path_shape():
    """chip_smoke.sparse_work at (2048, 855,050, k 12, float32): the
    function's bytes (p, g read and out written once, the list and the
    vectors) over 3.35 TB/s; its normals (on their branches) and the
    element's other instructions at this run's mean realized slots over
    132 SMs x 128 lanes at 1.98 GHz; (nnz + N) d FMAs at 67 TFLOP/s; the
    longest bounds it. The workspace floor beside it: 36 bytes an element
    (63.0 GB, 18.8 ms), 84 with every gathered row from HBM (43.9 ms)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    N, d, k, nnz = 2048, 855_050, 12, 20_094
    counts = {"small": 52, "large": 58, "tail_extra": 14}
    rates = {"sms": 132, "sm_clock_hz": 1.98e9}
    branches = {"small": 2_254_051_717, "large": 1_248_233_083,
                "tail": 11_820_610}
    w = chip_smoke.sparse_work(N, d, k, 4, True, nnz, counts, rates, branches)
    assert w["bytes"] == 3 * N * d * 4 + N * k * 8 + 6 * N * 4 + 16
    instr = (2_254_051_717 * 52 + 1_248_233_083 * 58 + 11_820_610 * 14
             + N * d * chip_smoke.sparse_element_ops(nnz / N, True))
    assert w["lane_instructions"] == pytest.approx(instr)
    assert w["fma_ms"] == pytest.approx(1e3 * 2 * (nnz + N) * d / 67e12)
    assert w["bound_ms"] == max(w["bytes_ms"], w["instructions_ms"],
                                w["fma_ms"])
    assert w["bound_by"] == "operations"
    assert w["workspace_bytes"] == 36 * N * d
    assert w["workspace_floor_ms"] == pytest.approx(18.818, abs=1e-3)
    assert w["gathered_from_hbm_ms"] == pytest.approx(43.909, abs=1e-3)
    gossip = chip_smoke.sparse_work(N, d, k, 4, False, nnz, counts, rates,
                                    None)
    assert gossip["bound_by"] == "bytes"
    assert gossip["workspace_bytes"] == 28 * N * d
