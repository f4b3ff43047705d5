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
K rounds is K eager rounds; its metrics (and on the dynamic path the
rounds' channels and mixing matrices) come back stacked [K, ...] on the
device, read by the host only at chunk ends.

The fleet (``fleet.FleetEngine``) runs R networks in one round body: its
carry holds the [R, ...] state, the [R, N, d] buffer (or [R, N, ...]
leaves) and, with telemetry, the [R, 4 + A] accountant moments; its
outputs stack [K, R, ...].

Telemetry (``obs.telemetry.TelemetrySpec``) wraps a body without drawing
from the generator or writing a parameter, so the trajectory with it on
is bitwise the one with it off: the per-round scalars (loss, gradient
norm, consensus on the parameters entering the round) go into each
round's output, and a chunk epilogue that ``run_chunk`` runs after the
chunk's last round adds the channel columns, vectorized over the chunk's
rounds (constants on the static channel), and folds the chunk's epsilon
and RDP moments into ``carry.eps``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import protocol as protocol_lib
from repro_torch.net.sparse import cat_w, stack_w
from repro_torch.net.state import (FIELDS, TracedChannelState, concat_states,
                                   stack_states)
from repro_torch.runtime import resolve_device

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
    batcher's next batch (``data.pipeline.FederatedBatcher.next``) and
    draws nothing from the generator. On the card the upload goes through
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
                    sim=None, fleet=None, telemetry=None) -> Callable:
    """``body(carry) -> (carry', out)``: one full DWFL round, its batch
    from ``store`` (data.device.ClassificationStore, sampled on the
    device, or ``HostBatches``). The path follows ``spec``: given (an
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
    instruments the body (``_maybe_instrument``)."""
    if fleet is not None:
        R = fleet.replicates
        fleet_round = fleet.make_fleet_round(cfg, spec=spec)

        def body(carry: TrajCarry):
            gen = carry.generator
            batch = store.draw_fleet(gen, R)
            net, params, metrics, chans, Ws = fleet_round(
                gen, carry.net, carry.params, batch)
            return (TrajCarry(gen, params, net, carry.eps),
                    {"metrics": metrics, "chan": chans, "W": Ws})

        return _maybe_instrument(body, telemetry, proto, device, fleet=fleet)
    if sim is not None:
        if spec is not None:
            step = protocol_lib.make_dynamic_flat_train_step(cfg, proto,
                                                             spec, device)

            def body(carry: TrajCarry):
                gen = carry.generator
                batch = store.draw(gen)
                net, chan, _, W = sim.round(gen, carry.net)
                params, metrics = step(carry.params, batch, round_seed(gen),
                                       chan, W)
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
        step = protocol_lib.make_flat_train_step(cfg, proto, spec, device)

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

    return _maybe_instrument(body, telemetry, proto, device)


_IN_ROUND = ("loss", "grad_norm", "consensus")


def _maybe_instrument(body: Callable, tele, proto, device, *,
                      fleet=None) -> Callable:
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
    nothing and writes no parameter."""
    if tele is None or (tele.n_fields == 0 and not tele.epsilon):
        return body
    from repro_torch.obs import telemetry as tele_lib

    dev = resolve_device(device)
    needs_chan = (tele.snr_db or tele.deep_fade or tele.participation
                  or tele.epsilon)
    R = None if fleet is None else fleet.replicates
    worker_axis = 0 if R is None else 1
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

    def instrumented(carry: TrajCarry):
        new_carry, out = body(carry)
        if not in_fields:
            return new_carry, out
        vals = {}
        if tele.loss:
            vals["loss"] = out["metrics"]["loss"]
        if tele.grad_norm:
            vals["grad_norm"] = out["metrics"]["grad_norm"]
        if tele.consensus:
            vals["consensus"] = tele_lib.consensus_distance(
                carry.params, worker_axis=worker_axis)
        cols = [vals[f].float() for f in in_fields]
        return new_carry, dict(out, telemetry=torch.stack(cols, dim=-1))

    def chunk_epilogue(carry: TrajCarry, ys: dict):
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


def run_chunk(body: Callable, carry: TrajCarry, k: int
              ) -> Tuple[TrajCarry, Any]:
    """Advance ``k`` rounds; the outputs come back stacked [k, ...] on the
    parameters' device, after the body's chunk epilogue (telemetry) where
    it has one."""
    if k < 1:
        raise ValueError(f"chunk length must be >= 1, got {k}")
    outs = []
    for _ in range(int(k)):
        carry, out = body(carry)
        outs.append(out)
    post = getattr(body, "chunk_epilogue", None)
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
    tensor, a TracedChannelState or a dict of them."""
    if torch.is_tensor(stacked):
        return stacked.transpose(0, 1)
    if isinstance(stacked, TracedChannelState):
        return dataclasses.replace(stacked, **{
            f: getattr(stacked, f).transpose(0, 1) for f in FIELDS})
    if isinstance(stacked, dict):
        return {k: replicate_major(v) for k, v in stacked.items()}
    raise TypeError(f"replicate_major takes a tensor, a TracedChannelState "
                    f"or a dict of them, got {type(stacked).__name__}")


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
