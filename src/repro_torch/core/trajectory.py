"""The trajectory as a Python loop over rounds — the port of the
reference's ``repro.core.trajectory`` (``make_round_body`` on the static,
the dynamic and the fleet paths, the telemetry instrumentation,
``run_per_round``, ``plan_chunks``, ``auto_chunk``, ``replicate_major``).

Key discipline: ONE explicit ``torch.Generator`` is the carry's
randomness. Each round draws from it in a fixed order: its data, then on
the dynamic path its network round (``NetworkSimulator.round``), then its
noise — on the flat path an int32 noise seed (and, under sampled
participation, its mask), on the worker-tree path the exchange's standard
normals — so the realized stream is a function of the generator's seed
and the round index, never of how rounds are cut into chunks. A chunk of
K rounds is K eager rounds (``run_chunk``), or on the card one replay of
a CUDA graph of them, for an LM K replays of one round's graph
(``ChunkRunner``, the reference's executor, bitwise the eager chunk); its
metrics (and on the dynamic path the rounds'
channels and mixing matrices) come back stacked [K, ...] on the device,
read by the host only at chunk ends.

The fleet (``fleet.FleetEngine``) runs R networks in one round body: its
carry holds the [R, ...] state, the [R, N, d] buffer (or [R, N, ...]
leaves) and, with telemetry, the [R, 4 + A] accountant moments; its
outputs stack [K, R, ...].

A sharded buffer (``repro_torch.shard``) changes the step, not the key
discipline: with a model-sharded ``spec`` the carry holds the padded
buffer (``shard_mesh=None``, the logical mode) or this rank's column
window (a mesh); with ``worker_mesh`` this rank's worker rows. Every rank
of a mesh draws the same data, network and seed from its own generator,
seeded alike, so a sharded trajectory realizes the unsharded stream and
its canonical columns are bitwise the unsharded trajectory's (the logical
mode; the model axis's mesh too), whatever the chunks.

Telemetry (``obs.telemetry.TelemetrySpec``) wraps a body without drawing
from the generator or writing a parameter, so the trajectory with it on
is bitwise the one with it off: the per-round scalars (loss, gradient
norm, consensus on the parameters entering the round) go into each
round's output, and a chunk epilogue that ``run_chunk`` runs after the
chunk's last round adds the channel columns, vectorized over the chunk's
rounds (constants on the static channel), and folds the chunk's epsilon
and RDP moments into ``carry.eps``. On a mesh the consensus is a
collective over the mesh's axis (``_consensus``); nothing else is.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import protocol as protocol_lib
from repro_torch.net.sparse import SparseW, cat_w, stack_w
from repro_torch.net.state import (FIELDS, TracedChannelState, concat_states,
                                   stack_states)
from repro_torch.runtime import (capture_graph, close_before_destroy,
                                 resolve_device)

_INT32_MIN, _INT32_END = -(1 << 31), 1 << 31


class TrajCarry(NamedTuple):
    """Everything a round consumes and rewrites: the generator, the
    parameters (the worker tree, or the flat [N, d] buffer; the fleet's
    [R, ...]), on the dynamic path the network's ``net.NetState``, and
    with epsilon telemetry the accountant moments ``eps`` ([4 + A], the
    fleet's [R, 4 + A]; ``obs.telemetry.init_eps_moments``)."""
    generator: torch.Generator
    params: Any
    net: Any = None
    eps: Any = None


class HostBatches:
    """The ``--no-scan`` data source: each round uploads the host
    batcher's next batch (``data.pipeline.FederatedBatcher.next`` or
    ``LMBatcher.next``) and draws nothing from the generator. On the card the upload goes through
    pinned memory without blocking, so a round under
    ``obs.no_implicit_transfers`` does not wait for the device."""

    def __init__(self, batcher, device="cuda"):
        self.batcher = batcher
        self.device = resolve_device(device)

    def _upload(self, v) -> torch.Tensor:
        t = torch.as_tensor(v)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def draw(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        return {k: self._upload(v) for k, v in self.batcher.next().items()}

    def draw_fleet(self, generator: torch.Generator,
                   replicates: int) -> Dict[str, torch.Tensor]:
        """The fleet's [R, W, B, ...] batch: the batcher's next R batches
        stacked."""
        draws = [self.batcher.next() for _ in range(int(replicates))]
        return {k: self._upload(np.stack([d[k] for d in draws]))
                for k in draws[0]}


def round_seed(generator: torch.Generator, n: int = 1) -> torch.Tensor:
    """``n`` int32 noise seeds, [n] (one a round; the fleet's one a
    replicate), drawn on the generator's device."""
    return torch.randint(_INT32_MIN, _INT32_END, (n,), dtype=torch.int32,
                         generator=generator, device=generator.device)


def make_round_body(cfg, proto, store, spec=None, device="cuda", *,
                    sim=None, fleet=None, telemetry=None, shard_mesh=None,
                    worker_mesh=None, remat: bool = False) -> Callable:
    """``body(carry) -> (carry', out)``: one full DWFL round, its batch
    from ``store`` (data.device.ClassificationStore or LMStore, sampled on
    the device, or ``HostBatches``). The path follows ``spec``: given (an
    exchange.FlatSpec), the fused flat-buffer round over the carry's
    [N, d] buffer laid out by it; ``None``, the worker-tree round over
    the carry's worker tree. With ``sim`` (net.NetworkSimulator) the
    round runs on the dynamic network, advancing the carry's ``net``;
    with ``fleet`` (fleet.FleetEngine) it advances R networks at once:
    the batch is [R, N, B, ...] (``store.draw_fleet``), then
    ``fleet.make_fleet_round`` (the networks' round, then R noise seeds on
    the flat path or the exchange's normals on the tree path).
    ``out`` is {"metrics": {...}}, and on the dynamic path also the
    round's "chan" and "W". ``telemetry`` (obs.telemetry.TelemetrySpec)
    instruments the body (``_maybe_instrument``).

    A ``spec`` with a ``shard.ShardLayout`` runs the model-sharded step
    (``shard.round``): logically on the padded buffer, or over
    ``shard_mesh``'s "model" axis on this rank's window. ``worker_mesh``
    (the dynamic flat path with an unsharded spec and a neighbor-list W)
    runs the worker-sharded step (``shard.worker``) on this rank's rows.
    ``remat`` recomputes the forward in the sharded gradient pass's
    backward. Telemetry on a mesh takes the consensus as a sum of the
    ranks' partial sums (``_consensus``); its other columns need no
    collective."""
    sharded = spec is not None and spec.layout is not None
    if shard_mesh is not None and not sharded:
        raise ValueError("shard_mesh requires a FlatSpec with a ShardLayout")
    if worker_mesh is not None and (sim is None or fleet is not None
                                    or sharded or spec is None):
        raise ValueError("worker_mesh requires the sim path with an "
                         "unsharded flat spec")
    if fleet is not None:
        R = fleet.replicates
        fleet_round = fleet.make_fleet_round(cfg, spec=spec, mesh=shard_mesh,
                                             remat=remat)

        def body(carry: TrajCarry, into=None):
            gen = carry.generator
            batch = store.draw_fleet(gen, R)
            net, params, metrics, chans, Ws = fleet_round(
                gen, carry.net, carry.params, batch, out=into)
            return (TrajCarry(gen, params, net, carry.eps),
                    {"metrics": metrics, "chan": chans, "W": Ws})

        return _marked(
            _maybe_instrument(body, telemetry, proto, device, fleet=fleet,
                              consensus=_consensus(fleet, shard_mesh)),
            cfg, store, fleet_round, shard_mesh)
    if sim is not None:
        if spec is not None:
            if worker_mesh is not None:
                from repro_torch.shard.worker import \
                    make_worker_sharded_dynamic_flat_train_step
                step = make_worker_sharded_dynamic_flat_train_step(
                    cfg, proto, spec, worker_mesh, device=device,
                    remat=remat)
            elif sharded:
                from repro_torch.shard.round import \
                    make_sharded_dynamic_flat_train_step
                step = make_sharded_dynamic_flat_train_step(
                    cfg, proto, spec, mesh=shard_mesh, device=device,
                    remat=remat)
            else:
                step = protocol_lib.make_dynamic_flat_train_step(
                    cfg, proto, spec, device)

            def body(carry: TrajCarry, into=None):
                gen = carry.generator
                batch = store.draw(gen)
                net, chan, _, W = sim.round(gen, carry.net)
                params, metrics = step(
                    carry.params, batch, round_seed(gen), chan, W,
                    **({} if into is None else {"out": into}))
                return (TrajCarry(gen, params, net, carry.eps),
                        {"metrics": metrics, "chan": chan, "W": W})
        else:
            step = protocol_lib.make_dynamic_train_step(cfg, proto, device)

            def body(carry: TrajCarry):
                gen = carry.generator
                batch = store.draw(gen)
                net, chan, _, W = sim.round(gen, carry.net)
                params, metrics = step(carry.params, batch, gen, chan, W)
                return (TrajCarry(gen, params, net, carry.eps),
                        {"metrics": metrics, "chan": chan, "W": W})
    elif spec is not None:
        if sharded:
            from repro_torch.shard.round import make_sharded_flat_train_step
            step = make_sharded_flat_train_step(cfg, proto, spec,
                                                mesh=shard_mesh,
                                                device=device, remat=remat)
        else:
            step = protocol_lib.make_flat_train_step(cfg, proto, spec,
                                                     device)

        def body(carry: TrajCarry):
            batch = store.draw(carry.generator)
            seed = round_seed(carry.generator)
            params, metrics = step(carry.params, batch, seed,
                                   generator=carry.generator)
            return (TrajCarry(carry.generator, params, None, carry.eps),
                    {"metrics": metrics})
    else:
        step = protocol_lib.make_train_step(cfg, proto, device)

        def body(carry: TrajCarry):
            batch = store.draw(carry.generator)
            params, metrics = step(carry.params, batch, carry.generator)
            return (TrajCarry(carry.generator, params, None, carry.eps),
                    {"metrics": metrics})

    return _marked(
        _maybe_instrument(body, telemetry, proto, device,
                          consensus=_consensus(None, shard_mesh,
                                               worker_mesh)),
        cfg, store, step,
        shard_mesh if worker_mesh is None else worker_mesh)


def _marked(body: Callable, cfg, store, step, mesh) -> Callable:
    """``body``, marked for ``ChunkRunner``: ``round_graph`` for an LM's
    (captured one round at a time), ``uncapturable`` for one fed by host
    batches (a graph would replay one upload), ``writes_into`` for one
    that takes ``body(carry, into=t)`` and writes the round's new flat
    buffer into ``t``, which may be ``carry.params`` itself: as its
    ``step`` declares (a neighbor-list round's, whose ``out`` is
    ``ops.dp_mix_round_sparse``'s). ``mesh``, the process-group mesh
    whose collectives the body runs (None without one), is kept as
    ``body.mesh``. A body over a mesh, NCCL or gloo, of any size, is
    captured, its collectives with it."""
    body.round_graph = cfg.family != "mlp"
    body.writes_into = bool(getattr(step, "writes_into", False))
    body.mesh = mesh
    if isinstance(store, HostBatches):
        body.uncapturable = "a body fed by host batches"
    return body


_IN_ROUND = ("loss", "grad_norm", "consensus")


def _consensus(fleet, shard_mesh=None, worker_mesh=None) -> Callable:
    """The round's consensus distance of the parameters a rank holds: the
    whole buffer or tree (no mesh); on a mesh a sum of the ranks' partial
    sums over its "model" or "workers" group
    (``obs.telemetry.consensus_distance``), the fleet's [R_loc] then
    gathered over "replicas" into [R], as its metrics are."""
    from repro_torch.obs import telemetry as tele_lib
    if worker_mesh is not None:
        group = worker_mesh.get_group("workers")
        return lambda p: tele_lib.consensus_distance(p, worker_group=group)
    axis = 0 if fleet is None else 1
    if shard_mesh is None:
        return lambda p: tele_lib.consensus_distance(p, worker_axis=axis)
    group = shard_mesh.get_group("model")
    if fleet is None:
        return lambda p: tele_lib.consensus_distance(p, model_group=group)
    from repro_torch.fleet.engine import _gather_replicas
    return lambda p: _gather_replicas(
        tele_lib.consensus_distance(p, axis, model_group=group), shard_mesh)


def _maybe_instrument(body: Callable, tele, proto, device, *,
                      consensus: Callable, fleet=None) -> Callable:
    """Wrap a round body with read-only telemetry (obs.telemetry).

    Per round, in the body's output: the scalars that read the round's
    transient state — loss and grad_norm (the step's metrics) and the
    consensus distance of the parameters ENTERING the round (the state the
    round's gossip acts on; already live as the gradient pass's input) —
    as ``out["telemetry"]`` [M_in] ([R, M_in] for the fleet). Per chunk,
    in ``chunk_epilogue`` (run by ``run_chunk`` after the chunk's last
    round): the channel columns (SNR, deep fade, participation, epsilon),
    evaluated once over the chunk's stacked channels and Ws, or, on the
    static channel, constants computed here once and broadcast; and the
    chunk's epsilon moments folded into ``carry.eps``. The wrapper draws
    nothing and writes no parameter. ``consensus(params)``: the consensus
    of the parameters the carry holds (``_consensus``; a mesh's
    collective)."""
    if tele is None or (tele.n_fields == 0 and not tele.epsilon):
        return body
    from repro_torch.obs import telemetry as tele_lib

    dev = resolve_device(device)
    needs_chan = (tele.snr_db or tele.deep_fade or tele.participation
                  or tele.epsilon)
    R = None if fleet is None else fleet.replicates
    # the catalogue puts the in-round fields first, so the per-round
    # prefix and the epilogue's channel columns concatenate in field order
    in_fields = tuple(f for f in _IN_ROUND if getattr(tele, f))
    chan_fields = tuple(f for f in tele.fields if f not in in_fields)

    # the RDP order grid on the device, made here: in the epilogue the
    # host-to-device copy would wait for the device
    from repro_torch.core.accounting import ORDER_GRID
    orders = torch.tensor(ORDER_GRID, dtype=torch.float32, device=dev)
    # the static channel: every channel column is the same every round
    static_vals: dict = {}
    static_eps = static_rdp = None
    if needs_chan and proto.channel_model != "dynamic":
        chan = TracedChannelState.from_static(proto.channel(), dev)
        W = torch.as_tensor(proto.mixing_matrix(), dtype=torch.float32,
                            device=dev)
        static_vals = tele_lib.channel_scalars(tele, chan, W)
        if tele.epsilon:
            static_eps = tele_lib.epsilon_round(proto, chan, W)
            static_rdp = tele_lib.rdp_round(proto, chan, W)

    def instrumented(carry: TrajCarry, **kw):
        vals = {}
        if tele.consensus:
            # before the body, which may write the parameters in place
            # (``into``)
            vals["consensus"] = consensus(carry.params)
        new_carry, out = body(carry, **kw)
        if not in_fields:
            return new_carry, out
        if tele.loss:
            vals["loss"] = out["metrics"]["loss"]
        if tele.grad_norm:
            vals["grad_norm"] = out["metrics"]["grad_norm"]
        cols = [vals[f].float() for f in in_fields]
        return new_carry, dict(out, telemetry=torch.stack(cols, dim=-1))

    def chunk_epilogue(carry: TrajCarry, ys: dict):
        # no collective here, on a mesh too: every rank draws the same
        # network (channel and W), so each evaluates the same channel
        # columns, epsilon, RDP ledger and carry.eps; loss and grad_norm
        # came whole out of the step's metrics
        k = ys["metrics"]["loss"].shape[0]
        lead = (k,) if R is None else (k, R)
        parts = [ys["telemetry"]] if in_fields else []
        eps = rdp = None
        acc = carry.eps
        # a [4 + A] carry also folds the per-order RDP ledger
        wide = acc is not None and acc.shape[-1] > 4
        if needs_chan:
            if "chan" not in ys:                       # static: constants
                vals = {f: v.expand(lead) for f, v in static_vals.items()}
                if static_eps is not None:
                    eps = static_eps.expand(lead)
                    if wide:
                        rdp = static_rdp.expand(lead + static_rdp.shape)
            else:
                chans, Ws = ys["chan"], ys["W"]
                vals = tele_lib.channel_scalars(tele, chans, Ws)
                if tele.epsilon:
                    eps = tele_lib.epsilon_round(proto, chans, Ws)
                    if wide:
                        rdp = tele_lib.rdp_round(proto, chans, Ws, orders)
            if eps is not None:
                vals["epsilon"] = eps
            parts.extend(vals[f].float()[..., None] for f in chan_fields)
        if parts:
            ys = dict(ys, telemetry=torch.cat(parts, dim=-1))
        if acc is not None and eps is not None:
            upd = tele_lib._moment_update(eps)
            if wide:
                upd = torch.cat([upd, rdp.float()], dim=-1)
            carry = carry._replace(eps=acc + upd.sum(0))
        return carry, ys

    instrumented.chunk_epilogue = chunk_epilogue
    return instrumented


def _stack(outs: List[dict]) -> dict:
    """Rounds' outputs stacked [k, ...]: the metrics, the per-round
    telemetry and, on the dynamic path, the channels and the Ws (dense,
    or a stacked SparseW)."""
    out = {"metrics": {n: torch.stack([o["metrics"][n] for o in outs])
                       for n in outs[0]["metrics"]}}
    if "telemetry" in outs[0]:
        out["telemetry"] = torch.stack([o["telemetry"] for o in outs])
    if "chan" in outs[0]:
        out["chan"] = stack_states([o["chan"] for o in outs])
        out["W"] = stack_w([o["W"] for o in outs])
    return out


def run_chunk(body: Callable, carry: TrajCarry, k: int, into=None
              ) -> Tuple[TrajCarry, Any]:
    """Advance ``k`` rounds eagerly; the outputs come back stacked [k, ...]
    on the parameters' device, after the body's chunk epilogue (telemetry)
    where it has one. After the first round nothing here holds the carry
    passed in (``analysis.donation`` checks a caller that drops it).
    ``into`` (a ``writes_into`` body's): every round writes its new
    parameters into it, in place where it is the carry's."""
    if k < 1:
        raise ValueError(f"chunk length must be >= 1, got {k}")
    kw = {} if into is None else {"into": into}
    outs = []
    for _ in range(int(k)):
        carry, out = body(carry, **kw)
        outs.append(out)
    post = getattr(body, "chunk_epilogue", None)
    out = _stack(outs)
    return (carry, out) if post is None else post(carry, out)


def _map(fn: Callable, tree):
    """``fn`` applied to every tensor of a carry's or an output's tree
    (dicts, lists, tuples, NamedTuples and dataclasses such as
    ``net.NetState``, ``TracedChannelState`` and ``SparseW``); other
    leaves are kept."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def tree_tensors(tree) -> List[torch.Tensor]:
    """The tensors of a carry's or an output's tree, in a fixed order."""
    found: List[torch.Tensor] = []
    _map(found.append, tree)
    return found


def _state(carry: TrajCarry) -> tuple:
    """What a round rewrites besides the generator: (params, net, eps)."""
    return carry.params, carry.net, carry.eps


def copy_tree(tree):
    """A tree of copies: its tensors cloned, other leaves kept."""
    return _map(torch.clone, tree)


def copy_carry(carry: TrajCarry) -> TrajCarry:
    """A carry of copies: its tensors cloned, its generator a new one in
    the same state (a carry to keep while ``ChunkRunner`` consumes the
    original)."""
    gen = torch.Generator(device=carry.generator.device)
    gen.set_state(carry.generator.get_state())
    return TrajCarry(gen, *copy_tree(_state(carry)))


class _Captured(NamedTuple):
    graph: Any                   # torch.cuda.CUDAGraph
    out: Any                     # the chunk's outputs, in the graph's pool


class ChunkRunner:
    """The reference's ``ChunkRunner``: ``run(carry, k)`` advances ``k``
    rounds of ``body`` and returns (carry', out), out's leaves stacked
    [k, ...]; ``program(k)`` is the eager k-round program (``run_chunk``'s
    loop and the body's chunk epilogue); ``trace_counts()`` is {k:
    captures of that length}, which ``obs.RetraceWatchdog`` watches.

    The carry's device decides how a chunk runs:

    * on the CPU, ``program(k)`` eagerly (the plain version);
    * on a card, one CUDA graph a chunk length, replayed. The runner's
      first chunk runs eagerly: it builds and loads the kernel libraries
      and lets CUDA and cuBLAS set themselves up, which no capture may do.
      It is a real chunk of the trajectory (nothing is drawn or computed
      for the warm-up alone). Every later chunk is a replay of its
      length's graph, captured at the length's first such chunk (two or
      three lengths a run: ``plan_chunks`` cuts at eval rounds).
    * an LM's body (``make_round_body`` marks it ``round_graph``): one
      CUDA graph of one round, replayed k times a chunk, as the
      reference's ``lax.scan`` compiles the body once and loops; the
      chunk epilogue then runs eagerly over the k rounds' stacked
      outputs, as ``run_chunk`` runs it. A graph of k rounds holds each
      of its rounds' new carry in its pool: at olmo-1b's full depth on
      two workers a 2-round capture ran out of the card's memory where
      one round's fits beside eager's peak. The other bodies keep a
      graph a chunk length: on dwfl-paper's rounds (0.7-90 ms) one
      round's graph replayed k times, its outputs copied out a round,
      was slower in turns, by up to 15% (PERF 6).

    The graphs read and rewrite one set of static buffers (the carry's
    parameters, network state and epsilon moments): each graph ends by
    writing the chunk's new values into them, so replays chain without a
    copy. A ``writes_into`` body's rounds (a neighbor-list flat round's,
    a worker-axis one's too) write their new parameters into the static
    buffer in place, every round of the graph: no write-back of the
    [N, d] buffer, and no second one in the graph's pool. With ``donate`` the carry passed in is consumed: the runner
    adopts its tensors as those buffers (it copies a carry whose tensors
    are not theirs into them: after a checkpoint's resume, or a rebinding
    by the caller), and the carry returned holds them, to be overwritten by
    the next chunk; without it the runner copies in and hands back copies.
    The outputs returned are the caller's own, copied out of the graph's
    pool. The generator stays the caller's: the graphs draw from one of
    the runner's (``CUDAGraph.register_generator_state``), set to the
    caller's state before a replay, whose state the caller's takes after
    it; a replay advances it as the k eager rounds would, so the realized
    stream does not depend on how rounds are cut into chunks or which
    chunks are replays.

    A replay runs no Python, so the kernel wrappers' launch counts grow
    only in the eager chunk and while a length is captured; what a replay
    launches is read from a profiler trace of it. A capture that fails
    raises, naming ROADMAP A7b; nothing falls back to the eager loop on
    the card. A carry of other shapes than the buffers' (it would need a
    second capture of each length) raises ``obs.RetraceError``. A body
    over a process-group mesh is captured with its collectives (NCCL's:
    each group's communicator is started by the mesh's first collective,
    and the eager first chunk runs every one before a capture; over
    several ranks every rank captures the same chunks in the same order,
    ``runtime.capture_graph``), held bitwise. A graph of NCCL
    collectives keeps their communicator, whose destroy waits for it
    forever: a runner over an NCCL mesh (``body.mesh``) frees its graphs
    when it is closed, at the end of a ``with`` block, and before any
    process group is destroyed (``runtime.close_before_destroy``). A
    body fed by host batches is refused when the runner is built
    (``make_round_body`` marks it ``uncapturable``)."""

    def __init__(self, body: Callable, donate: bool = True):
        why = getattr(body, "uncapturable", None)
        if why:
            raise ValueError(f"ChunkRunner does not capture {why} "
                             f"(ROADMAP A7b): run it with run_chunk")
        self._body = body
        self._round_graph = bool(getattr(body, "round_graph", False))
        self._donate = bool(donate)
        self._warm = False
        self._graphs: Dict[int, _Captured] = {}
        self._static = None          # (params, net, eps) the graphs rewrite
        self._shapes = None          # their (shape, dtype, device)s
        self._gen = self._stream = self._pool = None
        mesh = getattr(body, "mesh", None)
        if mesh is not None and mesh.device_type == "cuda":
            close_before_destroy(self)

    def close(self) -> None:
        """Free the graphs and their pool (the carry returned keeps its
        buffers); a later chunk captures anew."""
        self._graphs.clear()
        self._pool = None

    def __enter__(self) -> "ChunkRunner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def trace_counts(self) -> Dict[int, int]:
        # a length is captured once: a carry that would need a second
        # capture raises in _bind
        return {k: 1 for k in self._graphs}

    def program(self, k: int) -> Callable:
        k = int(k)
        if k < 1:
            raise ValueError(f"chunk length must be >= 1, got {k}")
        return functools.partial(run_chunk, self._body, k=k)

    def run(self, carry: TrajCarry, k: int) -> Tuple[TrajCarry, Any]:
        program = self.program(k)
        k = int(k)
        if tree_tensors(_state(carry))[0].device.type != "cuda":
            return program(carry)
        if not self._warm:
            self._warm = True
            return program(carry)
        self._bind(carry)
        n = 1 if self._round_graph else k
        entry = self._graphs.get(n)
        if entry is None:
            entry = self._capture(carry.generator, n)
        return self._replay(entry, carry.generator, k // n)

    def _bind(self, carry: TrajCarry) -> None:
        """Make the static buffers hold the carry's values."""
        from repro_torch.obs.guard import RetraceError
        state = _state(carry)
        shapes = _map(lambda t: (tuple(t.shape), t.dtype, t.device), state)
        if self._static is None:
            self._shapes = shapes
            own = ((lambda t: t if t.is_contiguous() else t.contiguous())
                   if self._donate else torch.clone)
            self._static = _map(own, state)
            return
        if shapes != self._shapes:
            raise RetraceError("ChunkRunner: a carry of other shapes than "
                               "its graphs' buffers (each length would be "
                               "captured a second time)")
        for s, t in zip(tree_tensors(self._static), tree_tensors(state)):
            if s is not t:
                s.copy_(t)

    def _capture(self, generator: torch.Generator, k: int) -> _Captured:
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                f"ChunkRunner: torch {torch.__version__} has no "
                f"CUDAGraph.register_generator_state, so a graph cannot "
                f"draw from the carry's generator (ROADMAP A7b)")
        if self._gen is None:
            self._gen = torch.Generator(device=generator.device)
            self._stream = torch.cuda.Stream(generator.device)
        carry = TrajCarry(self._gen, *self._static)
        # a writes_into body's rounds write the static parameters in place
        kw = ({"into": self._static[0]}
              if getattr(self._body, "writes_into", False) else {})
        # a round graph holds the body alone; its chunk epilogue runs
        # after the replays
        program = (functools.partial(self._body, **kw) if self._round_graph
                   else functools.partial(run_chunk, self._body, k=k, **kw))

        def chunk():
            new, out = program(carry)
            for s, t in zip(tree_tensors(self._static),
                            tree_tensors(_state(new))):
                if s is not t:
                    s.copy_(t)
            return out

        graph, out = capture_graph(
            chunk, self._stream, self._pool,
            what=f"ChunkRunner's {k}-round chunk", generators=(self._gen,))
        if self._pool is None:
            self._pool = graph.pool()
        entry = self._graphs[k] = _Captured(graph, out)
        return entry

    def _replay(self, entry: _Captured, generator: torch.Generator,
                times: int) -> Tuple[TrajCarry, Any]:
        self._gen.set_state(generator.get_state())
        outs = []
        for _ in range(times):
            entry.graph.replay()
            outs.append(_map(torch.clone, entry.out))
        generator.set_state(self._gen.get_state())
        state = (self._static if self._donate
                 else _map(torch.clone, self._static))
        carry = TrajCarry(generator, *state)
        if not self._round_graph:
            return carry, outs[0]
        post = getattr(self._body, "chunk_epilogue", None)
        out = _stack(outs)
        return (carry, out) if post is None else post(carry, out)


def run_per_round(body: Callable, carry: TrajCarry, k: int
                  ) -> Tuple[TrajCarry, Any]:
    """The per-round executor of ``--no-scan``: the same body, each round's
    metrics copied to the host as it ends (a synchronization per round),
    stacked [k, ...] on the CPU afterwards. The parameters it produces
    are those of ``run_chunk`` over the same rounds. It refuses an
    instrumented body: telemetry rides the chunked trajectory."""
    if getattr(body, "chunk_epilogue", None) is not None:
        raise ValueError("telemetry requires the chunked trajectory "
                         "(run_chunk); the per-round executor refuses it")
    outs = []
    for _ in range(int(k)):
        carry, out = body(carry)
        outs.append(dict(out, metrics={n: v.cpu() for n, v
                                        in out["metrics"].items()}))
    return carry, _stack(outs)


def concat_chunks(chunks: List[dict]) -> dict:
    """The chunks' stacked "chan" and "W" joined into one [T, ...]
    trajectory (the fleet's [T, R, ...])."""
    return {"chan": concat_states([c["chan"] for c in chunks]),
            "W": cat_w([c["W"] for c in chunks])}


def replicate_major(stacked):
    """A fleet log is round-major ([T, R, ...] after ``concat_chunks``);
    the batched accounting (``privacy.epsilon_trajectory_batched``,
    ``fleet.fleet_epsilon_report``) takes replicate-major [R, T, ...]. A
    tensor, a SparseW, a TracedChannelState or a dict of them."""
    if torch.is_tensor(stacked):
        return stacked.transpose(0, 1)
    if isinstance(stacked, SparseW):
        return stacked.map(lambda a: a.transpose(0, 1))
    if isinstance(stacked, TracedChannelState):
        return dataclasses.replace(stacked, **{
            f: getattr(stacked, f).transpose(0, 1) for f in FIELDS})
    if isinstance(stacked, dict):
        return {k: replicate_major(v) for k, v in stacked.items()}
    raise TypeError(f"replicate_major takes a tensor, a SparseW, a "
                    f"TracedChannelState or a dict of them, got "
                    f"{type(stacked).__name__}")


def plan_chunks(total: int, k: int, eval_every: int
                ) -> List[Tuple[int, bool]]:
    """Partition ``total`` rounds into chunks of at most ``k``, cutting at
    every eval boundary. Returns [(length, do_eval), ...] where
    ``do_eval`` marks chunks whose LAST round t satisfies
    t % eval_every == 0 (t counted from 0)."""
    if total < 1:
        return []
    if k < 1:
        raise ValueError(f"chunk length must be >= 1, got {k}")
    out: List[Tuple[int, bool]] = []
    done = 0
    while done < total:
        if eval_every > 0:
            # next eval cut strictly after `done`: round t = multiple of
            # eval_every with t + 1 > done, cut after it (at t + 1)
            t_next = (done // eval_every) * eval_every
            if t_next + 1 <= done:
                t_next += eval_every
            cut = min(t_next + 1, total)
        else:
            cut = total
        n = min(k, cut - done)
        done += n
        out.append((n, eval_every > 0 and (done - 1) % eval_every == 0))
    return out


def auto_chunk(eval_every: int, coherence_rounds: Optional[int] = None,
               cap: int = 512) -> int:
    """Default chunk length: one coherence block when defined, else one
    eval interval — never longer than an eval interval, at most ``cap``."""
    k = eval_every if eval_every > 0 else cap
    if coherence_rounds and 0 < coherence_rounds <= cap:
        k = coherence_rounds
    if eval_every > 0:
        k = min(k, eval_every)
    return max(1, min(int(k), cap))
