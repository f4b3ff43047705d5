"""Multi-process parts of the port's shard tests: gloo process groups on
the CPU, started with ``torch.multiprocessing.spawn`` and a ``file://``
rendezvous. Kept apart from the test modules, which import JAX: a rank
imports this module, torch and repro_torch only.

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` ranks of
``fn(rank, out_dir, *args)``; each saves what it computed to
``out_dir/r<rank>.pt``, which the test reads back. ``setup()`` builds
the small model, buffer and batch that the ranks and the single-process
references share, from seeds.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

N, DIM, B = 5, 12, 4


def _entry(rank, fn, world, init_file, out_dir, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        torch.save(fn(rank, *args), os.path.join(out_dir, f"r{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args) -> list:
    """Every rank's saved result, in rank order."""
    import torch.multiprocessing as mp
    out = os.path.join(str(tmp_path), f"out-{fn.__name__}")
    os.makedirs(out, exist_ok=True)
    mp.spawn(_entry, args=(fn, world, os.path.join(out, "rendezvous"), out,
                           args), nprocs=world, join=True)
    return [torch.load(os.path.join(out, f"r{r}.pt")) for r in range(world)]


def setup(n_workers: int = N, **proto_kw):
    """(cfg, proto, worker params [N, ...], batch) of the tests' small MLP
    (d = 266), all from seeds, on the CPU."""
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.models import mlp
    cfg = dataclasses.replace(DWFL_PAPER, d_model=8)
    kw = dict(scheme="dwfl", n_workers=n_workers, gamma=0.05, eta=0.4,
              clip=1.0, p_dbm=60.0, sigma=0.7, sigma_m=0.5)
    kw.update(proto_kw)
    proto = P.ProtocolConfig(**kw)
    params = mlp.init(torch.Generator().manual_seed(0), cfg, input_dim=DIM,
                      device="cpu")
    wp = X.tree_map(lambda a: a.expand((n_workers,) + a.shape).contiguous(),
                    params)
    rng = np.random.default_rng(1)
    batch = {"x": torch.tensor(rng.normal(size=(n_workers, B, DIM))
                               .astype(np.float32)),
             "y": torch.tensor(rng.integers(0, 10, (n_workers, B))
                               .astype(np.int32))}
    return cfg, proto, wp, batch


def dynamic_round(proto, seed: int):
    """(chan, W) of one round of ``proto``'s network, from a seed."""
    gen = torch.Generator().manual_seed(seed)
    sim = proto.simulator("cpu")
    net = sim.init(gen)
    _, chan, _, W = sim.round(gen, net)
    return chan, W


def collective_case(rank: int):
    """The stacked inputs of the collective tests (N = 4, d = 16) and this
    rank's collective and ring exchanges."""
    from repro_torch.core import dwfl
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.launch.mesh import make_host_mesh
    workers = make_host_mesh(4, 1).get_group("data")
    rng = np.random.default_rng(7)
    Xs, n, m = (torch.tensor(rng.normal(size=(4, 16)).astype(np.float32))
                for _ in range(3))
    chan = ChannelConfig(n_workers=4, p_dbm=30.0, sigma=0.7, sigma_m=0.3,
                         seed=7).realize()
    quiet = ChannelConfig(n_workers=4, p_dbm=30.0, sigma=0.0, sigma_m=0.0,
                          seed=7).realize()
    row = lambda t: {"w": t[rank:rank + 1]}
    out = dwfl.exchange_dwfl_collective(row(Xs), row(n), row(m), chan, 0.4,
                                        workers)
    ring = dwfl.exchange_orthogonal_ring(row(Xs), quiet, 1.0, workers)
    return {"collective": out["w"], "ring": ring["w"]}


def collective_step(rank: int):
    """This rank's worker of ``make_train_step(axis=WORLD)`` (N = 4, one
    worker a rank) with the population's normals given."""
    import torch.distributed as dist
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    cfg, proto, wp, batch = setup(4)
    normals = population_normals(wp)
    mine = lambda t: t[rank:rank + 1]
    step = P.make_train_step(cfg, proto, "cpu", axis=dist.group.WORLD)
    out, metrics = step(X.tree_map(mine, wp), X.tree_map(mine, batch), None,
                        normals=X.tree_map(mine, normals))
    return out


def population_normals(wp):
    """{"n", "m"} standard normals over the worker tree, from a seed."""
    from repro_torch.core import exchange as X
    gen = torch.Generator().manual_seed(11)
    return X.draw_normals(wp, gen)


def model_axis(rank: int):
    """The model axis on a (replicas 2, model 2) mesh of 4 ranks: two
    static rounds (chunk budget 37 columns) and one dynamic round with
    remat, this rank's window gathered back."""
    from repro_torch.core import exchange as X
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.shard.round import (full_buffer, local_window,
                                         make_sharded_dynamic_flat_train_step,
                                         make_sharded_flat_train_step)
    cfg, proto, wp, batch = setup()
    mesh = make_shard_mesh(2, n_replicas=2, device="cpu")
    spec = X.make_flat_spec(wp, n_shards=2, max_chunk_cols=37)
    step = make_sharded_flat_train_step(cfg, proto, spec, mesh=mesh,
                                        device="cpu")
    flat = local_window(spec.flatten(wp), spec, mesh)
    metrics = []
    for seed in (42, 43):
        flat, m = step(flat, batch, seed)
        metrics.append(m)
    dproto = dataclasses.replace(proto, channel_model="dynamic",
                                 scenario="iot_dense")
    chan, W = dynamic_round(dproto, 2)
    dstep = make_sharded_dynamic_flat_train_step(cfg, dproto, spec,
                                                 mesh=mesh, device="cpu",
                                                 remat=True)
    dflat, dm = dstep(local_window(spec.flatten(wp), spec, mesh), batch, 3,
                      chan, W)
    return {"static": full_buffer(flat, spec, mesh), "metrics": metrics,
            "dynamic": full_buffer(dflat, spec, mesh), "dyn_metrics": dm}


def sparse_setup():
    """The worker-axis case: mesh_sparse at N = 16 with k = 4, one round."""
    cfg, proto, wp, batch = setup(16, channel_model="dynamic",
                                  scenario="mesh_sparse", sparse_neighbors=4,
                                  flat_buffer=True)
    chan, W = dynamic_round(proto, 5)
    return cfg, proto, wp, batch, chan, W


def worker_axis(rank: int):
    """The worker axis on a (replicas 2, workers 2) mesh of 4 ranks: one
    sparse round on this rank's 8 rows, gathered back."""
    from repro_torch.core import exchange as X
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.shard.worker import (
        full_rows, local_rows, make_worker_sharded_dynamic_flat_train_step)
    cfg, proto, wp, batch, chan, W = sparse_setup()
    # two 'workers' groups of 2 side by side (the step reads that axis only)
    mesh = init_device_mesh("cpu", (2, 2),
                            mesh_dim_names=("replicas", "workers"))
    spec = X.make_flat_spec(wp)
    step = make_worker_sharded_dynamic_flat_train_step(cfg, proto, spec, mesh,
                                                       device="cpu")
    out, metrics = step(local_rows(spec.flatten(wp), mesh), batch, 9, chan, W)
    return {"flat": full_rows(out, mesh), "metrics": metrics}


def fleet_setup():
    """The fleet case: iot_dense, R = 2 networks of N = 5, its engine, the
    stacked parameters and batch."""
    from repro_torch.core import exchange as X
    from repro_torch.fleet import FleetEngine
    cfg, proto, wp, batch = setup(channel_model="dynamic",
                                  scenario="iot_dense", replicates=2,
                                  flat_buffer=True)
    fleet = FleetEngine(proto, device="cpu")
    stack = lambda t: torch.stack([t, t])
    return (cfg, fleet, X.tree_map(stack, wp), X.tree_map(stack, batch))


def fleet_2d(rank: int):
    """The fleet on a (replicas 2, model 2) mesh: one round, each rank's
    replicate and window gathered over the model axis."""
    from repro_torch.core import exchange as X
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.shard.round import full_buffer, local_window
    cfg, fleet, wpR, batchR = fleet_setup()
    mesh = make_shard_mesh(2, n_replicas=2, device="cpu")
    spec = X.make_flat_spec(wpR, lead_axes=2, n_shards=2)
    gen = torch.Generator().manual_seed(4)
    states = fleet.init(gen)
    fleet_round = fleet.make_fleet_round(cfg, spec=spec, mesh=mesh)
    mine = fleet.replicate_slice(mesh)
    flat = local_window(spec.flatten(wpR), spec, mesh)[mine]
    _, flat, metrics, _, _ = fleet_round(gen, states, flat, batchR)
    return {"replicates": (mine.start, mine.stop),
            "flat": full_buffer(flat, spec, mesh), "metrics": metrics}


def four_ranks(rank: int):
    """Everything the 4-rank gloo group checks, in one start."""
    return {"collective": collective_case(rank),
            "step": collective_step(rank), "model": model_axis(rank),
            "worker": worker_axis(rank), "fleet": fleet_2d(rank)}


def cli_ranks(rank: int, argv):
    """``launch.train.run(argv)`` on this rank (the group already up):
    what it returned, its run-log directory as a string."""
    from repro_torch.launch import train
    res = train.run(list(argv))
    run_dir = res["runlog_dir"]
    return {"params": res["params"], "losses": res["losses"],
            "telemetry": res["telemetry"], "eps": res["eps_moments"],
            "runlog_dir": None if run_dir is None else str(run_dir)}


def cli_executor(rank: int, argv):
    """``launch.train.run(argv)`` on this rank (the group already up), its
    standard output kept: the executor lines it printed and its
    losses."""
    import contextlib
    import io
    from repro_torch.launch import train
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train.run(list(argv))
    return {"executor": [l for l in out.getvalue().splitlines()
                         if l.startswith("[train] executor:")],
            "losses": res["losses"]}


# ---------------------------------------------------------------------------
# telemetry over a mesh (ROADMAP A21)
# ---------------------------------------------------------------------------

TELE_ROUNDS = 3


def _tele_store(n_workers: int):
    """A device store of the tests' 12-feature data, ``n_workers`` parts."""
    from repro_torch.data import ClassificationStore, dirichlet_partition
    rng = np.random.default_rng(3)
    x = rng.normal(size=(400, DIM)).astype(np.float32)
    y = rng.integers(0, 10, 400).astype(np.int32)
    return ClassificationStore.build(
        x, y, dirichlet_partition(y, n_workers, seed=3), B, device="cpu")


def telemetry_trajectory(kind: str, mesh=None, shards: int = 2) -> dict:
    """A TELE_ROUNDS-round dynamic trajectory with every telemetry column
    on, in one chunk: its rows ([K, M], the fleet's [K, R, M]) and
    carry.eps. ``kind``: "model" (iot_dense, N = 5, the buffer in
    ``shards`` column windows), "workers" (mesh_sparse, N = 16, k = 4) or
    "fleet" (iot_dense, R = 2 networks of N = 5 each mixing through its
    neighbor list, k = 3, ``shards`` column windows). ``mesh`` None: the logical mode (the padded buffer on one
    process; the worker axis's: the unsharded buffer); else this rank's
    part on ``mesh``."""
    from repro_torch.core import exchange as X
    from repro_torch.core import trajectory as TJ
    from repro_torch.fleet import FleetEngine
    from repro_torch.obs import telemetry as tele
    from repro_torch.shard import ShardLayout, local_rows, local_window
    n = 16 if kind == "workers" else N
    kw = (dict(scenario="mesh_sparse", sparse_neighbors=4)
          if kind == "workers" else dict(scenario="iot_dense"))
    if kind == "fleet":
        kw.update(replicates=2, sparse_neighbors=3)
    cfg, proto, wp, _ = setup(n, channel_model="dynamic", flat_buffer=True,
                              **kw)
    gen = torch.Generator().manual_seed(7)
    body_kw = dict(telemetry=tele.TelemetrySpec())
    reps = None
    if kind == "fleet":
        fleet = FleetEngine(proto, device="cpu")
        reps = fleet.replicates
        wp = X.tree_map(lambda t: torch.stack([t] * reps), wp)
        net = fleet.init(gen)
        body_kw.update(fleet=fleet, shard_mesh=mesh)
    else:
        sim = proto.simulator("cpu")
        net = sim.init(gen)
        body_kw.update(sim=sim)
    lead = 2 if kind == "fleet" else 1
    layout = (None if kind == "workers"
              else ShardLayout(X.FlatSpec(wp, lead).d, shards))
    spec = X.make_flat_spec(wp, lead_axes=lead, layout=layout)
    params = spec.flatten(wp)
    if mesh is not None and kind == "workers":
        body_kw["worker_mesh"] = mesh
        params = local_rows(params, mesh)
    elif mesh is not None:
        body_kw["shard_mesh"] = mesh
        params = local_window(params, spec, mesh)
        if kind == "fleet":
            params = params[fleet.replicate_slice(mesh)]
    body = TJ.make_round_body(cfg, proto, _tele_store(n), spec, "cpu",
                              **body_kw)
    carry = TJ.TrajCarry(gen, params, net,
                         tele.init_eps_moments(reps, device="cpu"))
    carry, out = TJ.run_chunk(body, carry, TELE_ROUNDS)
    return {"rows": out["telemetry"], "eps": carry.eps}


def telemetry_model(rank: int):
    from repro_torch.launch.mesh import make_shard_mesh
    return telemetry_trajectory("model", make_shard_mesh(2, device="cpu"))


def telemetry_workers(rank: int):
    from repro_torch.launch.mesh import make_worker_mesh
    return telemetry_trajectory("workers", make_worker_mesh(2, device="cpu"))


def telemetry_fleet(rank: int):
    """The fleet on the two 2-D meshes of 2 ranks: (replicas 1, model 2),
    the CLI's, and (replicas 2, model 1)."""
    from repro_torch.launch.mesh import make_shard_mesh
    return {
        "1x2": telemetry_trajectory(
            "fleet", make_shard_mesh(2, n_replicas=1, device="cpu")),
        "2x1": telemetry_trajectory(
            "fleet", make_shard_mesh(1, n_replicas=2, device="cpu"),
            shards=1)}


def telemetry_one_rank(rank: int):
    """Every mesh kind on a one-rank group."""
    from repro_torch.launch.mesh import make_shard_mesh, make_worker_mesh
    return {
        "model": telemetry_trajectory(
            "model", make_shard_mesh(1, device="cpu"), shards=1),
        "workers": telemetry_trajectory(
            "workers", make_worker_mesh(1, device="cpu")),
        "fleet": telemetry_trajectory(
            "fleet", make_shard_mesh(1, n_replicas=1, device="cpu"),
            shards=1)}



def analysis_mesh(rank: int, hidden: int, full_width_gather: bool):
    """One rank of ``repro_torch.analysis``'s two-rank program,
    shard-flat-s2-mesh, at ``hidden``: its findings as (checker,
    severity) pairs. ``full_width_gather`` seeds the gather check's
    defect: each round also all-gathers the rank's column window over the
    "model" group, the whole padded width stacked on the leading axis."""
    from repro_torch.analysis import (analyze_run, build_programs,
                                      run_program)
    from repro_torch.launch.mesh import gather_into
    prog, = build_programs(["shard-flat-s2-mesh"], hidden=hidden,
                           device="cpu")
    if full_width_gather:
        import torch.distributed as dist
        body = prog.body

        def widened(carry):
            new, out = body(carry)
            win = new.params
            full = win.new_empty((dist.get_world_size() * win.shape[0],)
                                 + tuple(win.shape[1:]))
            gather_into(full, win)
            return new, out

        prog.body = widened
    return [(f.checker, str(f.severity)) for f in
            analyze_run(run_program(prog))]


# ---------------------------------------------------------------------------
# a round written into a destination (ChunkRunner's in-place rounds)
# ---------------------------------------------------------------------------

def _bits(t):
    return t.contiguous().view(torch.int32) if t.is_floating_point() else t


def worker_axis_into(rank: int):
    """The worker axis on 2 ranks: the sharded step into a new buffer and
    into this rank's rows in place (``out=``), and a trajectory of 3
    rounds with telemetry (every field; the consensus a collective)
    through ``run_chunk`` without and with ``into`` = the carry's rows:
    whether each pair is bitwise the same, and the rows gathered back."""
    from repro_torch.core import exchange as X
    from repro_torch.core import trajectory as TJ
    from repro_torch.data import ClassificationStore, dirichlet_partition
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.obs import telemetry as tele
    from repro_torch.shard.worker import (
        full_rows, local_rows, make_worker_sharded_dynamic_flat_train_step)
    cfg, proto, wp, batch, chan, W = sparse_setup()
    mesh = make_worker_mesh(2, device="cpu")
    spec = X.make_flat_spec(wp)
    step = make_worker_sharded_dynamic_flat_train_step(cfg, proto, spec, mesh,
                                                       device="cpu")
    rows = local_rows(spec.flatten(wp), mesh)
    new, m_new = step(rows, batch, 9, chan, W)
    into = rows.clone()
    got, m_into = step(into, batch, 9, chan, W, out=into)
    same_step = (got is into and torch.equal(_bits(new), _bits(got))
                 and all(torch.equal(m_new[k], m_into[k]) for k in m_new))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(200, DIM)).astype(np.float32)
    y = rng.integers(0, 10, 200).astype(np.int32)
    store = ClassificationStore.build(
        x, y, dirichlet_partition(y, proto.n_workers, seed=0), B, "cpu")
    sim = proto.simulator("cpu")
    body = TJ.make_round_body(cfg, proto, store, spec, "cpu", sim=sim,
                              worker_mesh=mesh,
                              telemetry=tele.TelemetrySpec())
    gen = torch.Generator().manual_seed(4)
    carry = TJ.TrajCarry(gen, rows.clone(), sim.init(gen),
                         tele.init_eps_moments(device="cpu"))
    twin = TJ.copy_carry(carry)
    a, out_a = TJ.run_chunk(body, carry, 3)
    buf = twin.params
    b, out_b = TJ.run_chunk(body, twin, 3, into=buf)
    leaves = list(zip(TJ.tree_tensors((a.params, a.net, a.eps, out_a)),
                      TJ.tree_tensors((b.params, b.net, b.eps, out_b))))
    same_chunk = (b.params is buf and body.writes_into
                  and torch.equal(a.generator.get_state(),
                                  b.generator.get_state())
                  and all(torch.equal(_bits(u), _bits(v))
                          for u, v in leaves))
    return {"same_step": same_step, "same_chunk": same_chunk,
            "leaves": len(leaves), "flat": full_rows(b.params, mesh)}
