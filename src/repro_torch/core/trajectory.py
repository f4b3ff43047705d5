"""The trajectory as a Python loop over rounds — the port of the
reference's ``repro.core.trajectory`` (``make_round_body`` on the static
and the dynamic paths, ``run_per_round``, ``plan_chunks``,
``auto_chunk``).

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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import protocol as protocol_lib
from repro_torch.net.sparse import cat_w, stack_w
from repro_torch.net.state import concat_states, stack_states
from repro_torch.runtime import resolve_device

_INT32_MIN, _INT32_END = -(1 << 31), 1 << 31


class TrajCarry(NamedTuple):
    """Everything a round consumes and rewrites: the generator, the
    parameters (the worker tree, or the flat [N, d] buffer) and, on the
    dynamic path, the network's ``net.NetState``."""
    generator: torch.Generator
    params: Any
    net: Any = None


class HostBatches:
    """The ``--no-scan`` data source: each round uploads the host
    batcher's next batch (``data.pipeline.FederatedBatcher.next``) and
    draws nothing from the generator."""

    def __init__(self, batcher, device="cuda"):
        self.batcher = batcher
        self.device = resolve_device(device)

    def draw(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in self.batcher.next().items()}


def round_seed(generator: torch.Generator) -> torch.Tensor:
    """One int32 noise seed, [1], drawn on the generator's device."""
    return torch.randint(_INT32_MIN, _INT32_END, (1,), dtype=torch.int32,
                         generator=generator, device=generator.device)


def make_round_body(cfg, proto, store, spec=None, device="cuda", *,
                    sim=None) -> Callable:
    """``body(carry) -> (carry', out)``: one full DWFL round, its batch
    from ``store`` (data.device.ClassificationStore, sampled on the
    device, or ``HostBatches``). The path follows ``spec``: given (an
    exchange.FlatSpec), the fused flat-buffer round over the carry's
    [N, d] buffer laid out by it; ``None``, the worker-tree round over
    the carry's worker tree. With ``sim`` (net.NetworkSimulator) the
    round runs on the dynamic network, advancing the carry's ``net``.
    ``out`` is {"metrics": {...}}, and on the dynamic path also the
    round's "chan" and "W"."""
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
                return (TrajCarry(gen, params, net),
                        {"metrics": metrics, "chan": chan, "W": W})
        else:
            step = protocol_lib.make_dynamic_train_step(cfg, proto, device)

            def body(carry: TrajCarry):
                gen = carry.generator
                batch = store.draw(gen)
                net, chan, _, W = sim.round(gen, carry.net)
                params, metrics = step(carry.params, batch, gen, chan, W)
                return (TrajCarry(gen, params, net),
                        {"metrics": metrics, "chan": chan, "W": W})
    elif spec is not None:
        step = protocol_lib.make_flat_train_step(cfg, proto, spec, device)

        def body(carry: TrajCarry):
            batch = store.draw(carry.generator)
            seed = round_seed(carry.generator)
            params, metrics = step(carry.params, batch, seed,
                                   generator=carry.generator)
            return TrajCarry(carry.generator, params), {"metrics": metrics}
    else:
        step = protocol_lib.make_train_step(cfg, proto, device)

        def body(carry: TrajCarry):
            batch = store.draw(carry.generator)
            params, metrics = step(carry.params, batch, carry.generator)
            return TrajCarry(carry.generator, params), {"metrics": metrics}

    return body


def _stack(outs: List[dict]) -> dict:
    """Rounds' outputs stacked [k, ...]: the metrics and, on the dynamic
    path, the channels and the Ws (dense, or a stacked SparseW)."""
    out = {"metrics": {n: torch.stack([o["metrics"][n] for o in outs])
                       for n in outs[0]["metrics"]}}
    if "chan" in outs[0]:
        out["chan"] = stack_states([o["chan"] for o in outs])
        out["W"] = stack_w([o["W"] for o in outs])
    return out


def run_chunk(body: Callable, carry: TrajCarry, k: int
              ) -> Tuple[TrajCarry, Any]:
    """Advance ``k`` rounds; the outputs come back stacked [k, ...] on the
    parameters' device."""
    if k < 1:
        raise ValueError(f"chunk length must be >= 1, got {k}")
    outs = []
    for _ in range(int(k)):
        carry, out = body(carry)
        outs.append(out)
    return carry, _stack(outs)


def run_per_round(body: Callable, carry: TrajCarry, k: int
                  ) -> Tuple[TrajCarry, Any]:
    """The per-round executor of ``--no-scan``: the same body, each round's
    metrics copied to the host as it ends (a synchronization per round),
    stacked [k, ...] on the CPU afterwards. The parameters it produces
    are those of ``run_chunk`` over the same rounds."""
    outs = []
    for _ in range(int(k)):
        carry, out = body(carry)
        outs.append(dict(out, metrics={n: v.cpu() for n, v
                                        in out["metrics"].items()}))
    return carry, _stack(outs)


def concat_chunks(chunks: List[dict]) -> dict:
    """The chunks' stacked "chan" and "W" joined into one [T, ...]
    trajectory."""
    return {"chan": concat_states([c["chan"] for c in chunks]),
            "W": cat_w([c["W"] for c in chunks])}


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
