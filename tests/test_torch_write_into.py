"""A neighbor-list round written into a destination, as
``core.trajectory.ChunkRunner``'s graph writes its static buffer in place
every round (no write-back of the [N, d] buffer a chunk).

On the CPU (the plain versions; the card's kernels are held by
chip_smoke's graph phase and the gpu cases of test_torch_cuda.py):
``ops.dp_mix_round_sparse(out=p)`` is bitwise the round into a new
buffer, at N a multiple of the worker axis's pad of 8 and past it, for
one round and a stack of 2; ``dp_mix_gather_rows(out=p)`` likewise for a
worker shard; the dense round refuses ``out``. A ``writes_into`` body
(the sparse flat round, with telemetry, and the fleet's sparse flat
round) through ``run_chunk(..., into=carry.params)`` is bitwise the same
chunk into new buffers (parameters, generator, network state, epsilon
moments, every output), and the body of any other path carries no mark;
the worker-axis step and body over two gloo ranks likewise. Then
chip_smoke's harness of the graph over several ranks
(``mesh_graph_ranks``: a rank's watchdog, the graph against run_chunk,
one JSON record a rank) runs on two gloo ranks at reduced width.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the ranks find its functions by name)

from repro_torch.configs import DWFL_PAPER  # noqa: E402
from repro_torch.core import exchange as X  # noqa: E402
from repro_torch.core import protocol as P  # noqa: E402
from repro_torch.core import trajectory as TJ  # noqa: E402
from repro_torch.fleet import FleetEngine  # noqa: E402
from repro_torch.kernels.dp_mix import ops  # noqa: E402
from repro_torch.net.sparse import SparseW  # noqa: E402
from repro_torch.obs import telemetry as tele  # noqa: E402

SMALL = dict(device="cpu", N=6, hidden=16, dataset=400, batch=8, R=2, k=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _sparse_operands(lead, N, d=40, k=3, seed=0):
    """A neighbor-list round's operands from a seed: p, g [*lead, N, d],
    a SparseW of [*lead, N, k] leaves (some slots weightless), amp,
    listen [*lead, N], c, sigma_m, seed."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32))
    shape = tuple(lead) + (N,)
    idx = torch.tensor(rng.integers(0, N, shape + (k,)).astype(np.int32))
    w = torch.tensor(rng.uniform(0, 0.3, shape + (k,)).astype(np.float32))
    w[..., -1] = 0.0
    sw = SparseW(idx=idx, w=w, self_w=1.0 - w.sum(-1))
    amp = torch.tensor(rng.uniform(0.1, 1.0, shape).astype(np.float32))
    listen = torch.tensor((rng.uniform(size=shape) > 0.2).astype(np.float32))
    n = lead[0] if lead else None
    scalar = lambda v: v if n is None else torch.full((n,), v)
    seeds = (torch.tensor(7, dtype=torch.int32) if n is None
             else torch.arange(7, 7 + n, dtype=torch.int32))
    return (f(*shape, d), f(*shape, d), seeds, sw, amp, scalar(2.0),
            scalar(0.3), listen)


@pytest.mark.parametrize("lead,N", [((), 16), ((), 13), ((2,), 16)],
                         ids=["N16", "N13-padded", "R2xN16"])
def test_sparse_round_writes_into_p_bitwise(lead, N):
    """``dp_mix_round_sparse(..., out=p)`` writes the round into p itself
    and returns it, bitwise the round into a new buffer (past the pad of
    8 rows the round runs padded and is copied in)."""
    p, g, seed, sw, amp, c, sm, listen = _sparse_operands(lead, N)
    kw = dict(gamma=0.05, eta=0.4, listen=listen)
    want = ops.dp_mix_round_sparse(p, g, seed, sw, amp, c, sm, **kw)
    into = p.clone()
    got = ops.dp_mix_round_sparse(into, g, seed, sw, amp, c, sm, **kw,
                                  out=into)
    assert got is into
    assert torch.equal(_bits(got), _bits(want))
    other = torch.empty_like(p)
    assert ops.dp_mix_round_sparse(p, g, seed, sw, amp, c, sm, **kw,
                                   out=other) is other
    assert torch.equal(_bits(other), _bits(want))


def test_gather_rows_writes_into_p_bitwise():
    """A worker shard's gather (rows 8..15 of 16) into its own rows of p
    in place, bitwise the gather into a new buffer."""
    N, nb, row0 = 16, 8, 8
    p, g, seed, sw, amp, c, sm, listen = _sparse_operands((), N, seed=1)
    rows = slice(row0, row0 + nb)
    ws = ops.dp_mix_prep_rows(p[rows], g[rows], seed, amp[rows], c,
                              gamma=0.05, row0=row0, n_workers=N)
    z = ops.dp_mix_prep_rows(p, g, seed, amp, c, gamma=0.05, row0=0,
                             n_workers=N)[0]
    m_scale = torch.full((nb,), 1.0 / (c * (N - 1)))
    kw = dict(gamma=0.05, eta=0.4, row0=row0, m_scale=m_scale,
              listen=listen[rows])
    shard = SparseW(idx=sw.idx[rows], w=sw.w[rows], self_w=sw.self_w[rows])
    want = ops.dp_mix_gather_rows(p[rows], g[rows], ws, z, seed, shard,
                                  amp[rows], c, sm, **kw)
    into = p[rows].clone()
    got = ops.dp_mix_gather_rows(into, g[rows], ws, z, seed, shard,
                                 amp[rows], c, sm, **kw, out=into)
    assert got is into
    assert torch.equal(_bits(got), _bits(want))


def test_dense_plan_refuses_out():
    """The dense round writes a new buffer: ``dp_mix_round_plan`` takes
    ``out`` with a neighbor list only."""
    proto = P.ProtocolConfig(n_workers=4, flat_buffer=True)
    plan = P._round_plan(proto, P._flat_spec(proto, dynamic=False),
                         torch.device("cpu"))(None, None)
    p = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="neighbor-list plan"):
        ops.dp_mix_round_plan(p, p, 1, plan, gamma=0.1, eta=0.4, out=p)


def _fleet_sparse(R=2, N=8, k=3):
    """(body, carry) of the fleet's sparse flat round (mesh_sparse, R
    networks of N workers, degree cap k) at reduced width."""
    from repro_torch.data import (ClassificationStore,
                                  classification_dataset,
                                  dirichlet_partition)
    cfg = dataclasses.replace(DWFL_PAPER, d_model=16)
    proto = chip_smoke.dynamic_proto(N, "mesh_sparse", sparse_neighbors=k,
                                     flat_buffer=True)
    x, y = classification_dataset(400, seed=0)
    store = ClassificationStore.build(
        x, y, dirichlet_partition(y, N, alpha=0.5, seed=0), 8, "cpu")
    gen = torch.Generator().manual_seed(2)
    fleet = FleetEngine(proto, R, device="cpu")
    wp = fleet.init_worker_params(gen, cfg)
    spec = X.FlatSpec(wp, lead_axes=2)
    body = TJ.make_round_body(cfg, proto, store, spec, "cpu", fleet=fleet)
    return body, TJ.TrajCarry(gen, spec.flatten(wp), fleet.init(gen))


def _body(path):
    if path == "fleet sparse":
        return _fleet_sparse()
    if path == "sparse telemetry":
        body, carry = chip_smoke.graph_path("sparse", **SMALL)
        proto = chip_smoke.dynamic_proto(SMALL["N"], "mesh_sparse",
                                         sparse_neighbors=SMALL["k"])
        from repro_torch.data import (ClassificationStore,
                                      classification_dataset,
                                      dirichlet_partition)
        x, y = classification_dataset(400, seed=0)
        store = ClassificationStore.build(
            x, y, dirichlet_partition(y, SMALL["N"], alpha=0.5, seed=0), 8,
            "cpu")
        cfg = dataclasses.replace(DWFL_PAPER, d_model=SMALL["hidden"])
        spec = X.FlatSpec(P.init_worker_params(torch.Generator(), cfg,
                                               SMALL["N"], "cpu"))
        body = TJ.make_round_body(cfg, proto, store, spec, "cpu",
                                  sim=proto.simulator("cpu"),
                                  telemetry=tele.TelemetrySpec())
        return body, carry._replace(eps=tele.init_eps_moments(device="cpu"))
    return chip_smoke.graph_path(path, **SMALL)


@pytest.mark.parametrize("path", ["sparse", "sparse telemetry",
                                  "fleet sparse"])
def test_body_writes_into_its_destination_bitwise(path):
    """A ``writes_into`` body's chunk through ``run_chunk(into=)`` with
    the carry's own buffer as the destination (as ChunkRunner's graph
    runs it) is bitwise the chunk into new buffers: parameters, generator
    state, network state, epsilon moments, every output."""
    body, carry = _body(path)
    assert body.writes_into
    twin = TJ.copy_carry(carry)
    a, out_a = TJ.run_chunk(body, carry, 3)
    buf = twin.params
    b, out_b = TJ.run_chunk(body, twin, 3, into=buf)
    assert b.params is buf
    want = chip_smoke.chunk_record(a, [out_a])
    got = chip_smoke.chunk_record(b, [out_b])
    assert got.keys() == want.keys()
    assert [n for n in want if not chip_smoke.same_bits(got[n], want[n])] \
        == []


@pytest.mark.parametrize("path", ["flat", "flat telemetry", "dynamic flat",
                                  "tree", "dynamic tree", "fleet"])
def test_other_bodies_write_new_buffers(path):
    """Every other path's body writes its parameters into new buffers
    (ChunkRunner's graph copies them back into its static ones): no
    ``writes_into`` mark."""
    body, _ = chip_smoke.graph_path(path, **SMALL)
    assert body.writes_into is False


def test_worker_axis_writes_into_over_two_gloo_ranks(tmp_path):
    """The worker-axis step and body on two gloo ranks: the step into the
    rank's rows in place bitwise the step into a new buffer, and a
    3-round chunk with telemetry (its consensus a collective) through
    ``run_chunk(into=)`` bitwise the chunk into new buffers, every
    leaf; the ranks' rows gathered back agree."""
    import _torch_dist as D
    ranks = D.run_ranks(D.worker_axis_into, 2, tmp_path)
    for r in ranks:
        assert r["same_step"] and r["same_chunk"] and r["leaves"] > 8
        assert torch.equal(_bits(r["flat"]), _bits(ranks[0]["flat"]))


@pytest.mark.parametrize("case", ["model", "fleet", "workers"])
def test_mesh_graph_harness_on_two_gloo_ranks(case, tmp_path):
    """chip_smoke's harness of the graph over several ranks on two gloo
    ranks (the runner's eager program) at reduced width: each rank's
    record says its chunks through ChunkRunner are bitwise run_chunk's,
    and its last step is written where the parent reads it."""
    ranks = chip_smoke.mesh_graph_ranks(case, device="cpu", small=True,
                                        turns=False, timeout=200,
                                        out_dir=tmp_path / case)
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["ok"] and r["differ"] == [] and r["device"] == "cpu"
        assert (tmp_path / case / f"rank{r['rank']}.step").read_text() \
            == "done"
