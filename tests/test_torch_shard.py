"""Sharding of the flat DWFL buffer in the port (repro_torch.shard, ROADMAP
A14) against the reference's repro.shard and against the port's own
unsharded rounds.

* Geometry (ShardLayout, plan_chunks, FlatSpec's layout record): equal
  to the reference's over a sweep.
* The model axis, logical mode (one device, S dp_mix calls a round):
  bitwise the unsharded port round, step and trajectory at S = 1, 2, 4
  (S = 1 is the padded one-window layout), whatever the chunks; against
  the reference's logical mode on replayed operands within the f32
  tolerance of the reference's own kernel tests, atol = 1e-5 scale.
* B1's row0 (the worker axis): the plain twin's noise fields against the
  reference's ``_normal_pair_hash(row0=)`` (hash bits bitwise, normals
  within 2 ULP, C1's bound: bitwise except in the far tail); stitched row
  windows bitwise the whole sparse round.
* gloo process groups (tests/_torch_dist.py, 4 ranks in one start): the
  model axis bitwise the logical round; the worker axis within rtol
  1e-5, atol 3e-5 of the unsharded sparse round with loss and gradient
  norm bitwise; the 2-D (replicas, model) fleet within rtol 5e-6, atol
  5e-7 (the reference's tolerances, tests/test_shard.py and
  tests/test_sparse.py); exchange_dwfl_collective and the collective
  route within rtol 1e-5, atol 1e-6 of exchange_dwfl (the reference's,
  tests/test_dwfl.py). The CLI on 2 gloo ranks with --worker-shards.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as D
from repro.core import dwfl as rdwfl
from repro.core import exchange as RX
from repro.core.channel import ChannelConfig as RefChannelConfig
from repro.kernels.dp_mix import dp_mix as ref_mix
from repro.kernels.dp_perturb.dp_perturb import _hash_bits
from repro.shard import layout as rlayout
from repro.shard import round as rround
from repro_torch.core import dwfl
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.core import trajectory as TJ
from repro_torch.core.channel import ChannelConfig
from repro_torch.data import ClassificationStore
from repro_torch.kernels import noise
from repro_torch.kernels.dp_mix import ops
from repro_torch.launch import train
from repro_torch.net.sparse import SparseW
from repro_torch.shard import (LANES, ShardLayout, dp_mix_round_sharded,
                               make_sharded_dynamic_flat_train_step,
                               make_sharded_flat_train_step, plan_chunks,
                               shard_window_round, worker_window_round)
from repro_torch.shard import round as sround
from repro_torch.shard import worker as sworker


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
    assert torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _ref_tree(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", [None, 1, 13, 64, 200])
def test_layout_and_chunk_plan_equal_the_reference(budget):
    leafs = [[266], [96, 8, 64, 8, 80, 10], [1, 1, 300, 7], [128] * 5]
    for sizes in leafs:
        d = sum(sizes)
        for S in (1, 2, 3, 4, 5):
            lay, rlay = ShardLayout(d, S), rlayout.ShardLayout(d, S)
            assert lay.to_meta() == rlay.to_meta()
            np.testing.assert_array_equal(lay.col_offsets(),
                                          rlay.col_offsets())
            plan = plan_chunks(lay, sizes, budget)
            rplan = rlayout.plan_chunks(rlay, sizes, budget)
            assert [dataclasses.astuple(c) for c in plan.chunks] == \
                [dataclasses.astuple(c) for c in rplan.chunks]
            assert plan.exec_segments() == rplan.exec_segments()
            assert plan.to_meta() == rplan.to_meta()


def test_layout_contract():
    assert LANES == ops.LANES == rlayout.LANES
    lay = ShardLayout(1000, 3)
    assert lay.counter_width == ShardLayout(1000, 1).counter_width == 1024
    x = torch.randn(2, 1000)
    padded = lay.pad(x)
    assert padded.shape == (2, lay.padded_width)
    assert bool((padded[:, 1000:] == 0).all())
    _bitwise(lay.unpad(padded), x)
    _bitwise(ShardLayout(1000, 4).relayout(ShardLayout(1000, 2).pad(x), lay),
             padded)
    meta = lay.to_meta()
    assert ShardLayout.from_meta(meta) == lay
    with pytest.raises(ValueError, match="layout metadata mismatch"):
        ShardLayout.from_meta(dict(meta, shard_width=64))
    with pytest.raises(ValueError):
        plan_chunks(lay, [999], None)
    with pytest.raises(ValueError):
        plan_chunks(lay, [1000], 0)


@pytest.mark.parametrize("n_shards,budget", [(None, None), (2, None),
                                             (2, 37), (4, 200)])
def test_flat_spec_layout_equals_the_reference(n_shards, budget):
    _, _, wp, _ = D.setup()
    spec = X.make_flat_spec(wp, n_shards=n_shards, max_chunk_cols=budget)
    rspec = RX.make_flat_spec(_ref_tree(wp), n_shards=n_shards,
                              max_chunk_cols=budget)
    assert spec.layout_meta() == rspec.layout_meta()
    assert (spec.d, spec.width, spec.n_shards) == \
        (rspec.d, rspec.width, rspec.n_shards)
    assert spec.leaf_sizes() == rspec.leaf_sizes()
    assert spec.leaf_offsets() == rspec.leaf_offsets()
    flat = spec.flatten(wp)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(rspec.flatten(_ref_tree(wp))))
    for a, b in zip(X.tree_flatten(spec.unravel(flat))[0],
                    X.tree_flatten(wp)[0]):
        _bitwise(a, b)


def test_flat_spec_refusals():
    _, _, wp, _ = D.setup()
    d = X.FlatSpec(wp).d
    with pytest.raises(ValueError, match="requires a ShardLayout"):
        X.FlatSpec(wp, max_chunk_cols=8)
    with pytest.raises(ValueError, match="d="):
        X.FlatSpec(wp, layout=ShardLayout(d + 1, 2))
    with pytest.raises(ValueError, match="OR"):
        X.make_flat_spec(wp, layout=ShardLayout(d, 2), n_shards=2)
    assert X.make_flat_spec(wp, max_chunk_cols=8).max_chunk_cols is None


# ---------------------------------------------------------------------------
# the model axis, logical mode
# ---------------------------------------------------------------------------


def _round_operands(N=6, d=500, sigma=0.7, sigma_m=0.3):
    kw = dict(n_workers=N, p_dbm=30.0, sigma=sigma, sigma_m=sigma_m, seed=3)
    rng = np.random.default_rng(0)
    p = rng.normal(size=(N, d)).astype(np.float32)
    g = (0.2 * rng.normal(size=(N, d))).astype(np.float32)
    return (ChannelConfig(**kw).realize(), RefChannelConfig(**kw).realize(),
            p, g)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "gossip"])
def test_sharded_round_reconstructs_the_unsharded_round(n_shards, noisy):
    chan, _, p, g = _round_operands()
    plan = (X.plan_complete if noisy else X.plan_gossip)(None, chan, "cpu")
    N, d = p.shape
    full = ops.dp_mix_round_plan(torch.from_numpy(p), torch.from_numpy(g), 7,
                                 plan, gamma=0.05, eta=0.4)
    lay = ShardLayout(d, n_shards)
    pp, gp = lay.pad(torch.from_numpy(p)), lay.pad(torch.from_numpy(g))
    before = ops.dp_mix_round.launches
    out = dp_mix_round_sharded(pp, gp, 7, plan, lay, gamma=0.05, eta=0.4)
    assert ops.dp_mix_round.launches == before      # the CPU's plain twin
    _bitwise(lay.unpad(out), full)
    assert bool((out[:, d:] == 0).all())            # the padding invariant
    s, sw = 1 % n_shards, lay.shard_width
    win = shard_window_round(pp[:, s * sw:(s + 1) * sw].contiguous(),
                             gp[:, s * sw:(s + 1) * sw].contiguous(), 7,
                             plan, s * sw, lay, gamma=0.05, eta=0.4)
    _bitwise(win, out[:, s * sw:(s + 1) * sw])


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "gossip"])
def test_logical_mode_matches_the_reference_logical_mode(n_shards, noisy):
    """Replayed operands through both packages' logical sharded rounds:
    within atol 1e-5 scale, the reference's kernel tests' bound."""
    chan, rchan, p, g = _round_operands()
    make = X.plan_complete if noisy else X.plan_gossip
    rmake = RX.plan_complete if noisy else RX.plan_gossip
    plan, rplan = make(None, chan, "cpu"), rmake(None, rchan)
    lay, rlay = ShardLayout(p.shape[1], n_shards), \
        rlayout.ShardLayout(p.shape[1], n_shards)
    want = np.asarray(rround.dp_mix_round_sharded(
        rlay.pad(jnp.asarray(p)), rlay.pad(jnp.asarray(g)), jnp.int32(11),
        rplan, rlay, gamma=0.05, eta=0.4, impl="jnp"))
    got = dp_mix_round_sharded(lay.pad(torch.from_numpy(p)),
                               lay.pad(torch.from_numpy(g)), 11, plan, lay,
                               gamma=0.05, eta=0.4).numpy()
    scale = float(np.abs(want).max()
                  + 5.42 * (plan.amp / plan.c).abs().max().item() + 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    assert np.all(got[:, p.shape[1]:] == 0)


def _spec(wp, S, budget=None):
    if S == 1:      # the one-window layout: padded, one dp_mix call
        return X.make_flat_spec(wp, layout=ShardLayout(X.FlatSpec(wp).d, 1))
    return X.make_flat_spec(wp, n_shards=S, max_chunk_cols=budget)


def _check_metrics(m1, m2):
    for k in m1:
        _bitwise(m1[k], m2[k])


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_logical_sharded_static_step_bitwise(n_shards):
    cfg, proto, wp, batch = D.setup()
    spec0 = X.make_flat_spec(wp)
    f1, m1 = P.make_flat_train_step(cfg, proto, spec0, "cpu")(
        spec0.flatten(wp), batch, 42)
    spec = _spec(wp, n_shards)
    f2, m2 = make_sharded_flat_train_step(cfg, proto, spec, device="cpu")(
        spec.flatten(wp), batch, 42)
    assert f2.shape == (D.N, spec.width)
    _bitwise(spec.unpad(f2), f1)
    assert bool((f2[:, spec.d:] == 0).all())
    _check_metrics(m1, m2)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_logical_sharded_dynamic_step_bitwise(n_shards):
    cfg, proto, wp, batch = D.setup(channel_model="dynamic",
                                    scenario="iot_dense")
    chan, W = D.dynamic_round(proto, 2)
    spec0 = X.make_flat_spec(wp)
    f1, m1 = P.make_dynamic_flat_train_step(cfg, proto, spec0, "cpu")(
        spec0.flatten(wp), batch, 3, chan, W)
    spec = _spec(wp, n_shards, budget=37)
    step = make_sharded_dynamic_flat_train_step(cfg, proto, spec,
                                                device="cpu", remat=True)
    f2, m2 = step(spec.flatten(wp), batch, 3, chan, W)
    _bitwise(spec.unpad(f2), f1)
    _check_metrics(m1, m2)


def test_sampled_participation_sharded_step_bitwise():
    """The static step draws a sampled round's mask from the generator,
    as the unsharded step does."""
    cfg, proto, wp, batch = D.setup(participation=0.5)
    spec0, spec = X.make_flat_spec(wp), X.make_flat_spec(wp, n_shards=2)
    f1, _ = P.make_flat_train_step(cfg, proto, spec0, "cpu")(
        spec0.flatten(wp), batch, 5, torch.Generator().manual_seed(1))
    f2, _ = make_sharded_flat_train_step(cfg, proto, spec, device="cpu")(
        spec.flatten(wp), batch, 5, torch.Generator().manual_seed(1))
    _bitwise(spec.unpad(f2), f1)


def _store():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(160, D.DIM)).astype(np.float32)
    y = rng.integers(0, 10, 160).astype(np.int32)
    parts = [np.arange(w, 160, D.N) for w in range(D.N)]
    return ClassificationStore.build(x, y, parts, D.B, device="cpu")


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_trajectory_sharded_bitwise_and_chunk_invariant(dynamic):
    """The sharded trajectory in chunks of 4 and 2 against the unsharded
    one in a single chunk of 6: the canonical columns, the generator and
    every round's metrics bitwise."""
    kw = (dict(channel_model="dynamic", scenario="iot_dense") if dynamic
          else {})
    cfg, proto, wp, _ = D.setup(flat_buffer=True, **kw)
    store = _store()

    def start(spec):
        gen = torch.Generator().manual_seed(3)
        sim = proto.simulator("cpu") if dynamic else None
        net = sim.init(gen) if dynamic else None
        body = TJ.make_round_body(cfg, proto, store, spec, "cpu", sim=sim)
        return body, TJ.TrajCarry(gen, spec.flatten(wp), net)

    body0, c0 = start(X.make_flat_spec(wp))
    ref, out_ref = TJ.run_chunk(body0, c0, 6)
    spec = X.make_flat_spec(wp, n_shards=2, max_chunk_cols=50)
    body, c = start(spec)
    outs = []
    for k in (4, 2):
        c, out = TJ.run_chunk(body, c, k)
        outs.append(out)
    _bitwise(spec.unpad(c.params), ref.params)
    assert torch.equal(c.generator.get_state(), ref.generator.get_state())
    for k in ("loss", "grad_norm", "param_norm"):
        _bitwise(torch.cat([o["metrics"][k] for o in outs]),
                 out_ref["metrics"][k])


def test_fleet_logical_sharded_step():
    """The fleet's [R, N, width] buffer sharded logically: within the
    reference's rtol 5e-6, atol 5e-7 of the unsharded fleet step (here in
    fact bitwise)."""
    cfg, fleet, wpR, batchR = D.fleet_setup()
    flat_e, spec_e = fleet.init_flat_spec(torch.Generator().manual_seed(4),
                                          cfg, n_shards=2)
    assert spec_e.lead_axes == 2 and spec_e.n_shards == 2
    assert flat_e.shape == (2, D.N, spec_e.width)
    spec0 = X.make_flat_spec(wpR, lead_axes=2)
    spec2 = X.make_flat_spec(wpR, lead_axes=2, n_shards=2)
    gen = torch.Generator().manual_seed(5)
    _, chans, _, Ws = fleet.round(gen, fleet.init(gen))
    seeds = torch.tensor([3, 4], dtype=torch.int32)
    f_a, m_a = fleet.make_fleet_step(cfg, spec=spec0)(
        spec0.flatten(wpR), batchR, seeds, chans, Ws)
    f_b, m_b = fleet.make_fleet_step(cfg, spec=spec2)(
        spec2.flatten(wpR), batchR, seeds, chans, Ws)
    assert f_b.shape == (2, D.N, spec2.width)
    np.testing.assert_allclose(spec2.unpad(f_b).numpy(), f_a.numpy(),
                               rtol=5e-6, atol=5e-7)
    np.testing.assert_allclose(m_b["loss"].numpy(), m_a["loss"].numpy(),
                               rtol=1e-6)


def test_sharded_steps_refuse_what_they_do_not_run():
    cfg, proto, wp, _ = D.setup()
    with pytest.raises(ValueError, match="ShardLayout"):
        make_sharded_flat_train_step(cfg, proto, X.make_flat_spec(wp),
                                     device="cpu")
    spec2 = X.make_flat_spec(wp, n_shards=2)

    class Mesh:
        mesh_dim_names = ("model",)

        def size(self, i):
            return 1

    with pytest.raises(ValueError, match="2 shards but mesh 'model' axis "
                                         "has 1 ranks"):
        make_sharded_flat_train_step(cfg, proto, spec2, mesh=Mesh(),
                                     device="cpu")
    with pytest.raises(ValueError, match="no 'workers' axis"):
        make_sharded_flat_train_step(cfg, proto, spec2, mesh=Mesh(),
                                     axis="workers", device="cpu")
    with pytest.raises(ValueError, match="unsharded exact-d"):
        sworker.make_worker_sharded_dynamic_flat_train_step(
            cfg, proto, spec2, Mesh(), device="cpu")
    with pytest.raises(ValueError, match="lead_axes=2"):
        sround.make_fleet_sharded_step(cfg, proto, spec2, device="cpu")
    chan, _, p, g = _round_operands()
    plan = X.plan_complete(None, chan, "cpu")
    with pytest.raises(TypeError, match="sparse neighbor list"):
        worker_window_round(torch.from_numpy(p), torch.from_numpy(g), 1,
                            plan, 0, 6, gamma=0.05, eta=0.4)


# ---------------------------------------------------------------------------
# B1's row0: the worker axis's noise and row windows (plain twins)
# ---------------------------------------------------------------------------


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("shape,cw,col0,row0,seed", [
    ((8, 384), 384, 0, 8, 7),
    ((4, 256), 1024, 512, 12, -5),
    ((3, 130), 256, 0, 1000, 2**31 - 1),
])
def test_row0_noise_fields_match_the_reference(shape, cw, col0, row0, seed):
    """Hash bits bitwise; normals within C1's 2 ULP (bitwise except in the
    far tail); and each row window bitwise the whole field's rows."""
    g = ref_mix._normal_pair_hash(shape, cw, jnp.int32(col0), jnp.int32(seed),
                                  row0=row0)
    R, C = shape
    idx = noise.counters(shape, cw, col0, row0)
    for f in (0, 1):
        t = noise.normal_field(shape, cw, col0, seed, f, row0=row0)
        assert _ulp(t.numpy(), g[f]).max() <= 2
        assert (_ulp(t.numpy(), g[f]) > 0).mean() < 1e-3
        want_bits = np.asarray(_hash_bits(
            jnp.asarray((idx.numpy() * 2 + f).astype(np.uint32)),
            jnp.int32(seed)))
        np.testing.assert_array_equal(
            noise.hash_bits((idx * 2 + f) & noise.MASK32, seed)
            .numpy().astype(np.uint32), want_bits)
        whole = noise.normal_field((row0 + R, C), cw, col0, seed, f)
        _bitwise(t, whole[row0:])
    pair = noise.normal_pair_hash(shape, cw, col0, seed, row0=row0)
    _bitwise(pair[0], noise.normal_field(shape, cw, col0, seed, 0, row0=row0))


def _sparse_operands(N=16, d=300, k=4, seed=0):
    """A seeded neighbor list (rows with k, fewer and no neighbors) and a
    round's operands."""
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, N, (N, k), generator=gen, dtype=torch.int32)
    w = torch.rand((N, k), generator=gen) * 0.2
    w[::3, k // 2:] = 0.0
    w[5] = 0.0
    idx = torch.where(w > 0, idx, torch.arange(N, dtype=torch.int32)[:, None])
    sw = SparseW(idx, w, 1.0 - w.sum(1))
    p = torch.randn((N, d), generator=gen)
    g = 0.2 * torch.randn((N, d), generator=gen)
    amp = torch.rand(N, generator=gen) + 0.5
    mscale = 0.3 * torch.rand(N, generator=gen)
    listen = (sw.off_degree() > 0).float()
    return sw, p, g, amp, mscale, listen


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "gossip"])
def test_row_windows_stitch_to_the_sparse_round(n_shards, noisy):
    sw, p, g, amp, mscale, listen = _sparse_operands()
    N = p.shape[0]
    kw = dict(gamma=0.05, eta=0.4, noisy=noisy, col0=128, counter_width=512)
    whole = ops.dp_mix_round_sparse(p, g, 77, sw, amp, 2.0, 0.3,
                                    m_scale=mscale, listen=listen, **kw)
    nb = N // n_shards
    rows = [slice(s * nb, (s + 1) * nb) for s in range(n_shards)]
    ws = [ops.dp_mix_prep_rows(p[r], g[r], 77, amp[r], 2.0, gamma=0.05,
                               row0=r.start, n_workers=N, noisy=noisy,
                               col0=128, counter_width=512) for r in rows]
    z = torch.cat([w[0] for w in ws])
    out = torch.cat([
        ops.dp_mix_gather_rows(p[r], g[r], w, z, 77, sw[r], amp[r], 2.0, 0.3,
                               row0=r.start, m_scale=mscale[r],
                               listen=listen[r], **kw)
        for r, w in zip(rows, ws)])
    _bitwise(out, whole)


@pytest.mark.parametrize("row0", [0, 8, 40])
def test_sparse_round_row0_matches_the_reference(row0):
    """ops.dp_mix_round_sparse(row0=) against the reference's
    dp_mix_sparse_jnp(row0=) on the same operands, 1e-5 (the sparse
    suite's bound); row0 = 0 is the round without it, bitwise."""
    sw, p, g, amp, mscale, listen = _sparse_operands(N=16, d=256)
    kw = dict(gamma=0.05, eta=0.4, noisy=True)
    got = ops.dp_mix_round_sparse(p, g, 9, sw, amp, 2.0, 0.3, m_scale=mscale,
                                  listen=listen, row0=row0, **kw)
    j = lambda t: jnp.asarray(t.numpy())
    one = lambda v: jnp.asarray([v], jnp.int32)
    want = ref_mix.dp_mix_sparse_jnp(
        j(p), j(g), one(9), one(0), jnp.asarray([2.0, 0.3], jnp.float32),
        j(amp), jnp.ones(16, jnp.float32), j(mscale), j(listen), j(sw.idx),
        j(sw.w), j(sw.self_w), counter_width=256, row0=row0, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if row0 == 0:
        _bitwise(got, ops.dp_mix_round_sparse(p, g, 9, sw, amp, 2.0, 0.3,
                                              m_scale=mscale, listen=listen,
                                              **kw))


def test_row_window_limits():
    sw, p, g, amp, mscale, listen = _sparse_operands()
    with pytest.raises(ValueError, match="pass n_workers"):
        ops.dp_mix_prep_rows(p[:8], g[:8], 1, amp[:8], 2.0, gamma=0.1,
                             row0=12, n_workers=16)
    with pytest.raises(ValueError, match="2\\^31"):
        ops.dp_mix_prep_rows(p[:8], g[:8], 1, amp[:8], 2.0, gamma=0.1,
                             row0=8, n_workers=16, counter_width=1 << 28)
    with pytest.raises(ValueError, match="2\\^31"):
        ops.dp_mix_round_sparse(p, g, 1, sw, amp, 2.0, 0.3, gamma=0.1,
                                eta=0.4, row0=(1 << 31) // 512 - 8,
                                counter_width=512)
    ws = ops.dp_mix_prep_rows(p[:8], g[:8], 1, amp[:8], 2.0, gamma=0.1,
                              row0=0, n_workers=16)
    with pytest.raises(ValueError, match="m_scale"):
        ops.dp_mix_gather_rows(p[:8], g[:8], ws, ws[0], 1, sw[:8], amp[:8],
                               2.0, 0.3, gamma=0.1, eta=0.4, row0=0)


@pytest.mark.parametrize("entry,types", [("dp_mix_prep_launch", "PREP"),
                                         ("dp_mix_gather_launch", "GATHER")])
def test_row_window_argtypes_follow_the_c_entry(entry, types):
    """One ARGTYPES entry per parameter of the C entry, of the C
    parameter's kind (a missing entry shifts every argument after it, and
    ctypes cuts a pointer passed as an int to 32 bits)."""
    import ctypes
    import re
    text = (ops._CSRC / "dp_mix.cu").read_text()
    sig = re.search(rf"int {entry}\(([^)]*)\)\s*\{{", text).group(1)
    params = [" ".join(a.split()[:-1]) for a in sig.split(",")]
    argtypes = getattr(ops, f"{types}_ARGTYPES")
    assert len(params) == len(argtypes)
    for c_type, py in zip(params, argtypes):
        want = (ctypes.c_void_p if "*" in c_type else
                ctypes.c_float if c_type == "float" else
                ctypes.c_uint if "unsigned" in c_type else ctypes.c_int)
        assert py is want, (c_type, py)


# ---------------------------------------------------------------------------
# gloo process groups: 4 ranks, one start
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return D.run_ranks(D.four_ranks, 4, tmp_path_factory.mktemp("four"))


def test_gloo_model_axis_is_bitwise_the_logical_round(four):
    cfg, proto, wp, batch = D.setup()
    spec = X.make_flat_spec(wp, n_shards=2, max_chunk_cols=37)
    step = make_sharded_flat_train_step(cfg, proto, spec, device="cpu")
    flat, metrics = spec.flatten(wp), []
    for seed in (42, 43):
        flat, m = step(flat, batch, seed)
        metrics.append(m)
    dproto = dataclasses.replace(proto, channel_model="dynamic",
                                 scenario="iot_dense")
    chan, W = D.dynamic_round(dproto, 2)
    dflat, dm = make_sharded_dynamic_flat_train_step(
        cfg, dproto, spec, device="cpu")(spec.flatten(wp), batch, 3, chan, W)
    for r in range(4):
        got = four[r]["model"]
        _bitwise(got["static"], flat)
        _bitwise(got["dynamic"], dflat)
        for want_m, got_m in zip(metrics + [dm],
                                 got["metrics"] + [got["dyn_metrics"]]):
            _bitwise(got_m["loss"], want_m["loss"])
            _bitwise(got_m["grad_norm"], want_m["grad_norm"])
            torch.testing.assert_close(got_m["param_norm"],
                                       want_m["param_norm"], rtol=1e-6,
                                       atol=0)


def test_gloo_worker_axis_matches_the_unsharded_sparse_round(four):
    cfg, proto, wp, batch, chan, W = D.sparse_setup()
    spec = X.make_flat_spec(wp)
    want, wm = P.make_dynamic_flat_train_step(cfg, proto, spec, "cpu")(
        spec.flatten(wp), batch, 9, chan, W)
    for r in range(4):
        got = four[r]["worker"]
        np.testing.assert_allclose(got["flat"].numpy(), want.numpy(),
                                   rtol=1e-5, atol=3e-5)
        _bitwise(got["metrics"]["loss"], wm["loss"])
        _bitwise(got["metrics"]["grad_norm"], wm["grad_norm"])
        torch.testing.assert_close(got["metrics"]["param_norm"],
                                   wm["param_norm"], rtol=1e-6, atol=0)


def test_gloo_fleet_2d_matches_the_unsharded_fleet(four):
    cfg, fleet, wpR, batchR = D.fleet_setup()
    spec0 = X.make_flat_spec(wpR, lead_axes=2)
    gen = torch.Generator().manual_seed(4)
    states = fleet.init(gen)
    _, want, wm, _, _ = fleet.make_fleet_round(cfg, spec=spec0)(
        gen, states, spec0.flatten(wpR), batchR)
    spec2 = X.make_flat_spec(wpR, lead_axes=2, n_shards=2)
    seen = set()
    for r in range(4):
        got = four[r]["fleet"]
        lo, hi = got["replicates"]
        seen.add(lo)
        np.testing.assert_allclose(spec2.unpad(got["flat"]).numpy(),
                                   want[lo:hi].numpy(), rtol=5e-6, atol=5e-7)
        np.testing.assert_allclose(got["metrics"]["loss"].numpy(),
                                   wm["loss"].numpy(), rtol=1e-6)
        assert got["metrics"]["param_norm"].shape == (2,)
    assert seen == {0, 1}


def test_gloo_collective_exchange_agrees_with_exchange_dwfl(four):
    rng = np.random.default_rng(7)
    Xs, n, m = (rng.normal(size=(4, 16)).astype(np.float32) for _ in range(3))
    kw = dict(n_workers=4, p_dbm=30.0, sigma=0.7, sigma_m=0.3, seed=7)
    port = dwfl.exchange_dwfl(*({"w": torch.from_numpy(a)} for a in (Xs, n, m)),
                              ChannelConfig(**kw).realize(), 0.4)["w"]
    ref = np.asarray(rdwfl.exchange_dwfl(
        *({"w": jnp.asarray(a)} for a in (Xs, n, m)),
        RefChannelConfig(**kw).realize(), 0.4)["w"])
    got = torch.cat([four[r]["collective"]["collective"] for r in range(4)])
    np.testing.assert_allclose(got.numpy(), port.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_gloo_orthogonal_ring_is_the_neighbor_mean(four):
    Xs = np.random.default_rng(7).normal(size=(4, 16)).astype(np.float32)
    want = (Xs.sum(0, keepdims=True) - Xs) / 3
    got = torch.cat([four[r]["collective"]["ring"] for r in range(4)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_gloo_collective_route_of_make_train_step(four):
    """make_train_step(axis=group), one worker a rank, against the
    vectorized step with the same normals; and resolve_spec's route."""
    cfg, proto, wp, batch = D.setup(4)
    assert X.resolve_spec(proto, axis=object()).name == "collective"
    assert RX.resolve_spec(proto, axis="data").name == "collective"
    want, _ = P.make_train_step(cfg, proto, "cpu")(
        wp, batch, None, normals=D.population_normals(wp))
    for a, b in zip(X.tree_flatten(want)[0],
                    zip(*(X.tree_flatten(four[r]["step"])[0]
                          for r in range(4)))):
        np.testing.assert_allclose(torch.cat(b).numpy(), a.numpy(),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = ["--device", "cpu", "--hidden", "16", "--workers", "4", "--steps",
       "3", "--dataset-size", "2000", "--flat-buffer", "--eval-every", "2"]
SPARSE_CLI = ["--device", "cpu", "--hidden", "16", "--workers", "16",
              "--steps", "2", "--dataset-size", "2000", "--flat-buffer",
              "--channel-model", "dynamic", "--scenario", "mesh_sparse",
              "--sparse-neighbors", "4", "--eval-every", "0"]


@pytest.mark.parametrize("extra", [[], ["--channel-model", "dynamic",
                                        "--scenario", "iot_dense"]],
                         ids=["static", "dynamic"])
def test_cli_model_shards_is_bitwise_the_unsharded_run(extra, tmp_path):
    base = train.run(CLI + extra)
    got = train.run(CLI + extra + ["--model-shards", "2", "--max-chunk-cols",
                                   "5000", "--remat", "--checkpoint",
                                   str(tmp_path / "ck")])
    _bitwise(got["params"][:, :base["params"].shape[1]], base["params"])
    _bitwise(got["losses"], base["losses"])
    assert (tmp_path / "ck.npz").exists() and (tmp_path / "ck.json").exists()


@pytest.mark.parametrize("argv,msg", [
    (["--model-shards", "2"], "requires --flat-buffer"),
    (["--flat-buffer", "--max-chunk-cols", "8"], "requires --model-shards"),
    (["--flat-buffer", "--remat"], "requires --model-shards > 1 or"),
    (["--flat-buffer", "--worker-shards", "2"], "--sparse-neighbors > 0"),
    (SPARSE_CLI[4:] + ["--worker-shards", "2", "--no-scan"], "composes"),
    (SPARSE_CLI[4:] + ["--worker-shards", "3"], "divide evenly"),
    (SPARSE_CLI[4:] + ["--worker-shards", "2"], "needs that many ranks"),
])
def test_cli_shard_refusals(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        train.run(["--device", "cpu", "--hidden", "16", "--workers", "4",
                   "--steps", "1"] + argv)


def test_cli_worker_shards_on_two_gloo_ranks(tmp_path):
    """``--worker-shards 2`` on two gloo ranks (the process group up, as
    torchrun leaves it): the stitched rows within rtol 1e-5, atol 3e-5 of
    the unsharded CLI, the losses bitwise; rank 0 writes the checkpoint."""
    ck = str(tmp_path / "w")
    ranks = D.run_ranks(D.cli_ranks, 2, tmp_path,
                        SPARSE_CLI + ["--worker-shards", "2", "--remat",
                                      "--checkpoint", ck])
    base = train.run(SPARSE_CLI)
    got = torch.cat([r["params"] for r in ranks])
    np.testing.assert_allclose(got.numpy(), base["params"].numpy(),
                               rtol=1e-5, atol=3e-5)
    for r in ranks:
        _bitwise(r["losses"], base["losses"])
    import json
    with open(ck + ".json") as f:
        meta = json.load(f)["metadata"]
    assert meta["sparse_w"]["k"] == 4
    assert meta["flat_layout"]["d"] == got.shape[1]
    with np.load(ck + ".npz") as data:
        np.testing.assert_array_equal(data["flat"], got.numpy())
