"""The neighbor list's locality key and the gather's receiver order, on
the CPU.

* ``geometry.sparse_metropolis`` carries an int32 key [..., N]: each
  worker's Morton code, bitwise a numpy reference of the quantized
  position, a permutation once argsorted, one a network of a stack. It
  draws nothing and changes no weight: idx, w and self_w bitwise the
  reference's graph, the generator's state after a simulator round the
  same as with the key left out.
* Every SparseW helper carries the key: stacked, joined, sliced, moved,
  replicate-major, the fleet's stacked rounds; a list built without one
  (``sparsify_dense``) has none and runs in index order.
* ``ops.locality_order``: the key's stable argsort as int32, the worker
  axis's pad rows last, None without a key; on the CPU the wrapper's
  round is the plain twin whatever the key.
* At mesh_sparse N = 2048, k = 12 on the simulator's own positions, a
  gather group of 16 receivers in the key's order reads at most a third of
  the distinct rows a receiver that index order's does (chip_smoke's
  ``group_rows`` against a set count here).
* ``scripts/port_dp_mix_turns.py``'s sparse turns alternate the trees and
  collect each tree's digests.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.net import geometry as RG
from repro_torch.core import trajectory as TJ
from repro_torch.fleet import engine as fleet_engine
from repro_torch.kernels.dp_mix import ops
from repro_torch.net import geometry as G
from repro_torch.net.sparse import SparseW, cat_w, sparsify_dense, stack_w

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(area=100.0, comm_radius=30.0)


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pos(seed, shape, area=100.0):
    return np.random.default_rng(seed).uniform(0.0, area, shape).astype(
        np.float32)


def _morton_np(pos, area, bits=15):
    """The key by another hand: each coordinate quantized to 15 bits over
    the area, its bits interleaved one by one (x on the even bits)."""
    q = np.clip(np.floor(pos.astype(np.float32)
                         * np.float32((1 << bits) / area)),
                0, (1 << bits) - 1).astype(np.int64)
    key = np.zeros(pos.shape[:-1], np.int64)
    for b in range(bits):
        key |= ((q[..., 0] >> b) & 1) << (2 * b)
        key |= ((q[..., 1] >> b) & 1) << (2 * b + 1)
    return key.astype(np.int32)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["one", "stack"])
def test_key_is_the_morton_code_and_sorts_to_a_permutation(lead):
    """int32 [..., N], bitwise the numpy Morton code of the positions (one
    clamped past the area), argsorting to a permutation of each network's
    workers; a stack's rows are the single builds' keys."""
    n = 40
    pos = _pos(1, lead + (n, 2))
    pos[..., 0, :] = 1e4                     # past the area: clamped
    cfg = G.GeometryConfig(**CFG)
    sw = G.sparse_metropolis(cfg, torch.from_numpy(pos), 4)
    assert sw.key.dtype == torch.int32 and sw.key.shape == lead + (n,)
    np.testing.assert_array_equal(sw.key.numpy(), _morton_np(pos, 100.0))
    perm = torch.argsort(sw.key, dim=-1, stable=True)
    assert torch.equal(perm.sort(dim=-1).values,
                       torch.arange(n).expand(lead + (n,)))
    for r in range(lead[0] if lead else 0):
        one = G.sparse_metropolis(cfg, torch.from_numpy(pos[r]), 4)
        assert torch.equal(sw.key[r], one.key)


def test_key_changes_no_weight():
    """idx and w bitwise the reference's graph and self_w within 1 ULP (as
    tests/test_torch_sparse.py holds them), with the key beside them."""
    n, k = 48, 6
    pos = _pos(2, (n, 2))
    ref = RG.sparse_metropolis(RG.GeometryConfig(**CFG),
                               jax.numpy.asarray(pos), k=k)
    got = G.sparse_metropolis(G.GeometryConfig(**CFG), torch.from_numpy(pos),
                              k)
    assert got.key is not None
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(ref.w))
    ulps = np.abs(got.self_w.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(ref.self_w).view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def test_key_draws_nothing(monkeypatch):
    """A mesh_sparse simulator round leaves its generator in the same state
    with the key as with the key left out, and the same list."""
    from repro_torch.core.protocol import ProtocolConfig
    proto = ProtocolConfig(n_workers=64, channel_model="dynamic",
                           scenario="mesh_sparse", sparse_neighbors=6)
    sim = proto.simulator("cpu")

    def run():
        gen = torch.Generator().manual_seed(7)
        state = sim.init(gen)
        for _ in range(2):
            state, _, _, W = sim.round(gen, state)
        return gen.get_state(), W

    state_k, keyed = run()
    monkeypatch.setattr(G, "locality_key", lambda cfg, pos: None)
    state_n, plain = run()
    assert keyed.key is not None and plain.key is None
    assert torch.equal(state_k, state_n)
    for f in ("idx", "w", "self_w"):
        assert torch.equal(getattr(keyed, f), getattr(plain, f))


def test_every_helper_carries_the_key():
    """stack_w, cat_w, [r], slices, to(), replicate_major and the fleet's
    stack_rounds keep the key with the leaves; a join of lists of which
    one has no key has none; layout_meta stays the reference's
    descriptor."""
    cfg = G.GeometryConfig(**CFG)
    lists = [G.sparse_metropolis(cfg, torch.from_numpy(_pos(s, (16, 2))), 3)
             for s in range(3)]
    stacked = stack_w(lists)
    assert stacked.key.shape == (3, 16)
    for r, sw in enumerate(lists):
        assert torch.equal(stacked[r].key, sw.key)
    assert torch.equal(cat_w([stacked[:1], stacked[1:]]).key, stacked.key)
    assert torch.equal(stacked[1:].key, stacked.key[1:])
    assert torch.equal(lists[0][4:9].key, lists[0].key[4:9])
    assert torch.equal(stacked.to("cpu").key, stacked.key)
    rounds = [stack_w(lists[:2]), stack_w(lists[1:])]       # [R, ...] each
    fleet = fleet_engine.stack_rounds(rounds)                # [R, T, ...]
    assert torch.equal(fleet.key, torch.stack([r.key for r in rounds], 1))
    major = TJ.replicate_major(stack_w(rounds))              # [T, R] -> [R, T]
    assert torch.equal(major.key, fleet.key)
    bare = SparseW(lists[0].idx, lists[0].w, lists[0].self_w)
    assert stack_w([lists[0], bare]).key is None
    assert lists[0].layout_meta() == bare.layout_meta() == {
        "format": "padded-neighbor-v1", "n_workers": 16, "k": 3,
        "pad": "self-index-zero-weight"}


def test_locality_order_is_the_keys_stable_argsort():
    """int32, a permutation, equal keys in index order, the pad rows last;
    per network of a stack; None for a list without a key (sparsify_dense,
    a hand-built one)."""
    key = torch.tensor([[5, 1, 5, 0, 1], [2, 2, 2, 2, 2]], dtype=torch.int32)
    sw = SparseW(torch.zeros((2, 5, 1), dtype=torch.int32),
                 torch.zeros((2, 5, 1)), torch.ones((2, 5)), key)
    order = ops.locality_order(sw, 8, "cpu")
    assert order.dtype == torch.int32
    assert order.tolist() == [[3, 1, 4, 0, 2, 5, 6, 7],
                              [0, 1, 2, 3, 4, 5, 6, 7]]
    assert ops.locality_order(sw[0], 5, "cpu").tolist() == [3, 1, 4, 0, 2]
    W = torch.tensor([[0.5, 0.5], [0.5, 0.5]])
    assert sparsify_dense(W, 1).key is None
    assert ops.locality_order(sparsify_dense(W, 1), 2, "cpu") is None


def test_cpu_round_is_the_plain_twin_whatever_the_key():
    """On the CPU the key orders nothing: the round of a keyed list is
    bitwise the round of the same list without it."""
    n, d = 24, 50
    sw = G.sparse_metropolis(G.GeometryConfig(**CFG),
                             torch.from_numpy(_pos(4, (n, 2))), 4)
    bare = SparseW(sw.idx, sw.w, sw.self_w)
    gen = torch.Generator().manual_seed(0)
    p = torch.randn((n, d), generator=gen)
    g = torch.randn((n, d), generator=gen)
    amp = torch.rand(n, generator=gen) + 0.5
    kw = dict(gamma=0.05, eta=0.4, m_scale=torch.full((n,), 0.1))
    a = ops.dp_mix_round_sparse(p, g, 3, sw, amp, 2.0, 0.3, **kw)
    b = ops.dp_mix_round_sparse(p, g, 3, bare, amp, 2.0, 0.3, **kw)
    assert torch.equal(a, b)


def _distinct_rows(sw, order, G):
    """Distinct rows a group of G reads, a receiver, by Python sets."""
    idx = sw.idx.tolist()
    recv = list(range(sw.n_workers)) if order is None else order.tolist()
    total = 0
    for s in range(0, len(recv), G):
        rows = set()
        for i in recv[s:s + G]:
            rows.add(i)
            rows.update(idx[i])
        total += len(rows)
    return total / sw.n_workers


def test_key_order_shares_rows_at_the_worker_scale():
    """mesh_sparse at N = 2048, k = 12 on the simulator's own positions: a
    group of 16 in the key's order reads at most a third of the distinct
    rows a receiver that index order's does (the design's probe: 2.93
    against 10.41); chip_smoke.group_rows counts the same."""
    from repro_torch.core.protocol import ProtocolConfig
    proto = ProtocolConfig(n_workers=2048, channel_model="dynamic",
                           scenario="mesh_sparse", sparse_neighbors=12)
    sim = proto.simulator("cpu")
    gen = torch.Generator().manual_seed(0)
    _, _, _, W = sim.round(gen, sim.init(gen))
    order = ops.locality_order(W, 2048, "cpu")
    keyed, index = _distinct_rows(W, order, 16), _distinct_rows(W, None, 16)
    assert keyed <= index / 3, (keyed, index)
    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    assert smoke.group_rows(W, order, 16)["per_receiver"] == pytest.approx(
        keyed)
    assert smoke.group_rows(W, None, 8)["per_receiver"] == pytest.approx(
        _distinct_rows(W, None, 8))


def test_dp_mix_turns_time_the_sparse_round_in_turns(monkeypatch):
    """The sparse round of each tree in turns, the order reversed every
    other turn; a tree's times in turns, their least, and its digests (one
    when every turn and order gave the same bits)."""
    mod = _module("port_dp_mix_turns", ROOT / "scripts" /
                  "port_dp_mix_turns.py")
    order = []

    def fake(tree, N):
        order.append(tree.name)
        k = len(order)
        rec = {"N": N, "d": 7, "k": 12, "keyed": tree.name == "b",
               "digest": "aa", "round_ms": float(k), "prep_ms": 1.0,
               "gather_ms": float(10 * k)}
        if tree.name == "b":
            rec.update(index_digest="aa", index_round_ms=2.0 * k)
        return rec
    monkeypatch.setattr(mod, "time_sparse", fake)
    recs = mod.sparse_turns([Path("a"), Path("b")], 64, 2)
    assert order == ["a", "b", "b", "a"]
    by = {r["tree"]: r for r in recs}
    assert by["a"]["round_ms_in_turns"] == [1.0, 4.0]
    assert by["a"]["round_ms"] == 1.0 and "index_round_ms" not in by["a"]
    assert by["b"]["index_round_ms_in_turns"] == [4.0, 6.0]
    assert by["b"]["gather_ms"] == 20.0
    assert by["a"]["digests"] == by["b"]["digests"] == ["aa"]
