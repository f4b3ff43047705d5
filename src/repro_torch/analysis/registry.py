"""Registry of the driver programs ``repro_torch.analysis`` checks (the
reference's ``repro.analysis.registry``).

Each entry builds the round body ``launch/train.py`` ships —
``core.trajectory.make_round_body`` over the device store, run by
``run_chunk`` — at the reference's smoke scale (W = 6 workers, batch 4,
K = 3 rounds a chunk, R = 2 fleet replicates; dwfl-paper's arch at a
width given as an argument: the tests run narrow, the card runs
dwfl-paper's 256). ``run_program`` then runs two chunks of it, each under
a ``utils.trace.Recorder``, and keeps what the checkers read: the
recorded ops, kernel calls, noise draws and collectives, the live carry
buffers at each round's start, and the mixing operands each round hands
to the dp_mix kernel (or, on the worker-tree path, the round's outputs).

The catalogue covers the shipped paths: static, dynamic and fleet ×
tree and flat, telemetry and epsilon in the carry, the sparse
neighbor-list round, and the model-sharded flat round twice — S = 2
logically on one device, and on a two-rank "model" mesh
(``shard-flat-s2-mesh``: it needs a process group of two ranks, so it
drops out of ``available_programs()`` on one).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

N_WORKERS = 6
BATCH = 4
CHUNK = 3
REPLICATES = 2
HIDDEN = 256          # dwfl-paper's width
_SEED = 0


@dataclasses.dataclass
class BuiltProgram:
    """One registry program, ready to run."""
    name: str
    dynamic: bool          # declared channel model (weak-closure severity)
    n_workers: int
    body: Callable
    carry: object          # the initial TrajCarry (run_program takes it)
    device: torch.device
    sharded: bool = False  # model-sharded: gather-free contract applies
    flat_width: int = 0    # padded buffer width (sharded only)
    shard_width: int = 0   # columns a rank holds (sharded only)
    sparse: bool = False   # neighbor-list mixing: dense-mixing contract
    flat: bool = False     # the fused flat-buffer round (dp_mix)
    replicates: Optional[int] = None


@dataclasses.dataclass
class ChunkRun:
    recorder: object            # utils.trace.Recorder of the chunk
    out: dict                   # run_chunk's stacked outputs
    round_index: List[int]      # recorder index at each round's start
    live_buffers: List[int]     # live carry-sized storages, round starts
    carry_ptrs: List[int]       # the carry's largest leaf, after each round


@dataclasses.dataclass
class ProgramRun:
    program: BuiltProgram
    chunks: List[ChunkRun]
    buffer_bytes: int           # the carry's largest leaf's storage
    buffer_leaves: int          # carry leaves of that size

    @property
    def name(self) -> str:
        return self.program.name


def _base(hidden: int, device):
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import (FederatedBatcher, classification_dataset,
                                  dirichlet_partition, store_from_batcher)
    cfg = get_arch("dwfl-paper").replace(d_model=int(hidden))
    x, y = classification_dataset(512, seed=_SEED)
    parts = dirichlet_partition(y, N_WORKERS, alpha=0.5, seed=_SEED)
    batcher = FederatedBatcher(x, y, parts, BATCH, seed=_SEED)
    return cfg, store_from_batcher(batcher, device)


def _proto(**kw):
    from repro_torch.core import protocol as P
    base = dict(scheme="dwfl", n_workers=N_WORKERS, seed=_SEED)
    base.update(kw)
    return P.ProtocolConfig(**base)


def _generator(dev) -> torch.Generator:
    """The run's generator: on the device, a CPU one for the meta device
    (whose draws then carry shapes only)."""
    where = "cpu" if dev.type == "meta" else dev
    return torch.Generator(device=where).manual_seed(_SEED)


def _static(name: str, hidden: int, dev, flat: bool, n_shards: int = 1,
            mesh: bool = False) -> BuiltProgram:
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    cfg, store = _base(hidden, dev)
    proto = _proto(flat_buffer=flat)
    gen = _generator(dev)
    wp = P.init_worker_params(gen, cfg, N_WORKERS, dev)
    spec = shard_mesh = None
    params = wp
    if flat:
        spec = X.make_flat_spec(wp, n_shards=n_shards if n_shards > 1
                                else None)
        params = spec.flatten(wp)
    if mesh:
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.shard.round import local_window
        shard_mesh = mesh_lib.make_shard_mesh(n_shards, device=dev)
        params = local_window(params, spec, shard_mesh)
    body = TJ.make_round_body(cfg, proto, store, spec, dev,
                              shard_mesh=shard_mesh)
    layout = spec.layout if spec is not None else None
    return BuiltProgram(
        name, False, N_WORKERS, body, TJ.TrajCarry(gen, params), dev,
        sharded=mesh, flat_width=layout.padded_width if mesh else 0,
        shard_width=layout.shard_width if mesh else 0, flat=flat)


def _dynamic(name: str, hidden: int, dev, flat: bool,
             telemetry: bool = False, sparse_k: int = 0) -> BuiltProgram:
    from repro_torch import obs
    from repro_torch.core import exchange as X
    from repro_torch.core import protocol as P
    from repro_torch.core import trajectory as TJ
    cfg, store = _base(hidden, dev)
    proto = _proto(channel_model="dynamic", scenario="iot_dense",
                   coherence_rounds=4, flat_buffer=flat,
                   sparse_neighbors=sparse_k)
    gen = _generator(dev)
    sim = proto.simulator(dev)
    wp = P.init_worker_params(gen, cfg, N_WORKERS, dev)
    net = sim.init(gen)
    spec = X.make_flat_spec(wp) if flat else None
    params = spec.flatten(wp) if flat else wp
    tele = eps0 = None
    if telemetry:
        tele = obs.TelemetrySpec()
        if tele.epsilon:
            eps0 = obs.init_eps_moments(None, device=dev)
    body = TJ.make_round_body(cfg, proto, store, spec, dev, sim=sim,
                              telemetry=tele)
    return BuiltProgram(name, True, N_WORKERS, body,
                        TJ.TrajCarry(gen, params, net, eps0), dev,
                        sparse=sparse_k > 0, flat=flat)


def _fleet(name: str, hidden: int, dev, flat: bool) -> BuiltProgram:
    from repro_torch.core import trajectory as TJ
    from repro_torch.fleet import FleetEngine
    cfg, store = _base(hidden, dev)
    proto = _proto(channel_model="dynamic", scenario="iot_dense",
                   coherence_rounds=4, replicates=REPLICATES,
                   flat_buffer=flat)
    fleet = FleetEngine(proto, device=dev)
    gen = _generator(dev)
    spec = None
    if flat:
        params, spec = fleet.init_flat_spec(gen, cfg)
    else:
        params = fleet.init_worker_params(gen, cfg)
    net = fleet.init(gen)
    body = TJ.make_round_body(cfg, proto, store, spec, dev, fleet=fleet)
    return BuiltProgram(name, True, N_WORKERS, body,
                        TJ.TrajCarry(gen, params, net), dev, flat=flat,
                        replicates=REPLICATES)


# name -> builder(hidden, device); the order is the CLI's report order
PROGRAMS: Dict[str, Callable] = {
    "static-tree": lambda h, d: _static("static-tree", h, d, flat=False),
    "static-flat": lambda h, d: _static("static-flat", h, d, flat=True),
    "dynamic-tree": lambda h, d: _dynamic("dynamic-tree", h, d, flat=False),
    "dynamic-flat-tele": lambda h, d: _dynamic(
        "dynamic-flat-tele", h, d, flat=True, telemetry=True),
    # the sparse neighbor-list round, with telemetry and epsilon in the
    # carry, so the accountant's sparse branch runs inside the check too
    "dynamic-sparse-flat": lambda h, d: _dynamic(
        "dynamic-sparse-flat", h, d, flat=True, telemetry=True, sparse_k=3),
    "fleet-tree": lambda h, d: _fleet("fleet-tree", h, d, flat=False),
    "fleet-flat": lambda h, d: _fleet("fleet-flat", h, d, flat=True),
    "shard-flat-s2": lambda h, d: _static("shard-flat-s2", h, d, flat=True,
                                          n_shards=2),
    # the mesh program, on a two-rank "model" mesh: the one the gather
    # check holds to its memory contract
    "shard-flat-s2-mesh": lambda h, d: _static(
        "shard-flat-s2-mesh", h, d, flat=True, n_shards=2, mesh=True),
}


def _two_ranks() -> bool:
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == 2)


# programs with a precondition on the process: name -> () -> bool
_REQUIRES: Dict[str, Callable[[], bool]] = {
    "shard-flat-s2-mesh": _two_ranks,
}


def available_programs() -> List[str]:
    """The registry names buildable in this process (the CLI's default):
    the mesh program drops out without a two-rank process group."""
    return [n for n in PROGRAMS if _REQUIRES.get(n, lambda: True)()]


def build_programs(names: Optional[Sequence[str]] = None, *,
                   hidden: int = HIDDEN, device="cuda"
                   ) -> List[BuiltProgram]:
    from repro_torch.runtime import resolve_device
    dev = resolve_device(device)
    if names is None:
        names = available_programs()
    unknown = [n for n in names if n not in PROGRAMS]
    if unknown:
        raise KeyError(f"unknown program(s) {unknown}; "
                       f"registry: {list(PROGRAMS)}")
    return [PROGRAMS[n](hidden, dev) for n in names]


def _leaves(tree):
    from repro_torch.core.exchange import tree_flatten
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def run_program(prog: BuiltProgram, chunks: int = 2, k: int = CHUNK
                ) -> ProgramRun:
    """Run ``chunks`` chunks of ``k`` rounds of ``prog``, each under a
    recorder (on the card also under ``obs.no_implicit_transfers``, which
    makes any synchronization with the host an error where it happens).
    The program's initial carry is taken, not copied."""
    from repro_torch import obs
    from repro_torch.core import trajectory as TJ
    from repro_torch.utils.trace import Recorder
    carry, prog.carry = prog.carry, None
    big = max(_leaves(carry.params), key=lambda t: t.untyped_storage().nbytes())
    size = big.untyped_storage().nbytes()
    n_big = sum(t.untyped_storage().nbytes() == size
                for t in _leaves(carry.params))
    del big
    held = [carry]      # the chunk's run_chunk is the carry's only holder
    del carry
    runs: List[ChunkRun] = []
    for _ in range(chunks):
        with Recorder() as rec:
            starts, live, ptrs = [], [], []

            def observed(c, _body=prog.body):
                starts.append(rec._index)
                live.append(sum(n == size for n in rec._tracked.values()))
                new, out = _body(c)
                ptrs.append(max(_leaves(new.params),
                                key=lambda t: t.numel()).data_ptr())
                return new, out

            post = getattr(prog.body, "chunk_epilogue", None)
            if post is not None:
                observed.chunk_epilogue = post
            rec.track(held[0].params)
            with obs.no_implicit_transfers(device=prog.device):
                carry, out = TJ.run_chunk(observed, held.pop(), k)
            held.append(carry)
            del carry
        runs.append(ChunkRun(rec, out, starts, live, ptrs))
    return ProgramRun(prog, runs, size, n_big)
