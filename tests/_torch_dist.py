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
    """``launch.train.run(argv)`` on this rank (the group already up)."""
    from repro_torch.launch import train
    res = train.run(list(argv))
    return {"params": res["params"], "losses": res["losses"]}
