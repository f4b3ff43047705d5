"""Protocol configuration and the DWFL train steps — the reference's
``repro.core.protocol``.

``make_train_step`` is the worker-tree round: per-worker clipped gradients
over worker-stacked parameter trees -> the local SGD step of every leaf
(with ``use_pallas`` one launch of the hand-written dp_perturb kernel
over all the leaves, ``sgd_update_leaves``)
-> the scheme's exchange (dwfl on the complete graph, a ring or torus, or
under sampled participation; gossip, orthogonal, centralized), with its
noise drawn per leaf -> metrics. ``make_flat_train_step`` is the
flat-buffer round: the same gradients on the persistent flat [N, d]
buffer -> one fused dp_mix round (local step, counter-hash DP noise,
mixing, self-correction and AWGN). ``make_dynamic_train_step`` and
``make_dynamic_flat_train_step`` are the same two rounds on the dynamic
network (``repro_torch.net``): the round's channel and W are arguments,
so one step serves every realization. ``make_fleet_flat_train_step``
and ``make_fleet_train_step`` run those two rounds over R networks at
once ([R, ...] leaves; the reference vmaps the dynamic steps): the
gradient pass takes the R N workers as one batch, the flat round's mix is
one dp_mix launch for all R, the tree round's local step one
``sgd_update_leaves`` launch. All route the scheme through
``exchange.resolve_spec``.

Per-worker gradients need no vmap: the per-worker losses
(``models.model.worker_losses``: the classifier's workers at once through
batched matrix products over the worker-stacked leaves, an LM's one
worker at a time on its rows of the leaves) are summed before one
``autograd.grad``, and the gradient of the SUM has, in worker i's slice of
each leaf, worker i's own gradient (that slice enters only loss i).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import accounting, privacy
from repro_torch.core import exchange as exchange_lib
from repro_torch.core.channel import ChannelConfig, ChannelState
from repro_torch.kernels.dp_mix import ops as mix_ops
from repro_torch.kernels.dp_perturb import ops as dp_ops
from repro_torch.models import model as M
from repro_torch.runtime import resolve_device


@dataclass(frozen=True)
class ProtocolConfig:
    scheme: str = "dwfl"          # dwfl | gossip | orthogonal | centralized
    n_workers: int = 16
    gamma: float = 0.05           # step size
    eta: float = 0.5              # averaging rate
    clip: float = 1.0             # g_max (gradient L2 clip)
    delta: float = 1e-5
    p_dbm: float = 60.0
    sigma: float = 1.0
    sigma_m: float = 1.0
    fading: str = "rayleigh"
    seed: int = 0
    target_epsilon: float = 0.0   # >0: calibrate sigma to this per-round eps
    noise_policy: str = "surplus"
    use_pallas: bool = False      # worker tree: local step by the dp_perturb
                                  # kernel (sgd_update_leaves)
    fuse_exchange: bool = False   # worker tree: bucket the leaves into one
                                  # flat leaf for the exchange (dwfl/gossip)
    flat_buffer: bool = False     # train on the persistent flat [N, d]
                                  # buffer (make_flat_train_step)
    topology: str = "complete"    # gossip topology: complete (the
                                  # paper) | ring | torus (core.topology)
    topology_k: int = 1           # ring: neighbors per side
    participation: float = 1.0    # per-round transmit rate q (< 1: sampled
                                  # participation, amplification)
    channel_model: str = "static" # static (the paper's one-shot channel) |
                                  # dynamic (repro_torch.net, per round)
    scenario: str = "static_paper"  # net.scenarios preset (dynamic only)
    coherence_rounds: int = 0     # > 0: the scenario's fading block length
    graph_fallback: bool = False  # bridge radius-isolated workers to their
                                  # nearest active neighbor
    sparse_neighbors: int = 0     # > 0: degree cap k of the dynamic round's
                                  # neighbor-list W (net.sparse.SparseW) and
                                  # its O(N k) mix (exchange "dynamic_sparse")
    accountant: str = "composition"  # the trajectory ledger of the sigma
                                  # calibration and the report headline:
                                  # composition (advanced) | rdp
    target_total_epsilon: float = 0.0  # > 0: calibrate sigma against the
                                  # whole ``horizon``-round budget under
                                  # ``accountant`` (not with target_epsilon)
    horizon: int = 0              # T of the total budget
    replicates: int = 1           # the fleet's R (fleet.FleetEngine)

    def mixing_matrix(self) -> np.ndarray:
        from repro_torch.core import topology
        return topology.make(self.topology, self.n_workers,
                             k=self.topology_k)

    def channel(self) -> ChannelState:
        chan = ChannelConfig(
            n_workers=self.n_workers, p_dbm=self.p_dbm, sigma=self.sigma,
            sigma_m=self.sigma_m, fading=self.fading, seed=self.seed,
            noise_policy=self.noise_policy,
        ).realize()
        if self.target_epsilon > 0:
            # scheme-aware: "the same epsilon" is the scheme's OWN worst
            # budget; the orthogonal per-link budget and a ring's or
            # torus's per-receiver budget need more noise than the
            # complete graph's at equal sigma (Remark 4.1)
            if self.scheme == "orthogonal":
                sig = privacy.sigma_for_epsilon_orthogonal(
                    self.target_epsilon, self.gamma, self.clip, chan,
                    self.delta)
            elif self.scheme == "dwfl" and self.topology != "complete":
                sig = privacy.sigma_for_epsilon_topology(
                    self.target_epsilon, self.gamma, self.clip, chan,
                    self.delta, self.mixing_matrix())
            else:
                sig = privacy.sigma_for_epsilon(
                    self.target_epsilon, self.gamma, self.clip, chan,
                    self.delta)
            chan = chan.with_sigma(max(sig, 1e-12))
        if self.target_total_epsilon > 0:
            if self.target_epsilon > 0:
                raise ValueError("target_epsilon (per-round) and "
                                 "target_total_epsilon (horizon) are "
                                 "mutually exclusive")
            if self.horizon < 1:
                raise ValueError("target_total_epsilon needs horizon >= 1 "
                                 "(the planned number of rounds)")
            if self.scheme == "orthogonal":
                raise ValueError("total-budget calibration covers the "
                                 "mixing-family schemes only")
            W = (None if self.topology == "complete"
                 else self.mixing_matrix())
            sig = accounting.sigma_for_total_epsilon(
                self.target_total_epsilon, self.gamma, self.clip, chan,
                self.delta, self.horizon, accountant=self.accountant, W=W)
            chan = chan.with_sigma(max(sig, 1e-12))
        return chan

    def simulator(self, device="cuda"):
        """The NetworkSimulator of channel_model="dynamic": the scenario's
        radio environment with this protocol's power, noise and
        calibration."""
        from repro_torch.net import NetworkSimulator, get_scenario
        if self.channel_model != "dynamic":
            raise ValueError("simulator() requires channel_model='dynamic'")
        return NetworkSimulator(
            get_scenario(self.scenario), self.n_workers,
            p_dbm=self.p_dbm, sigma=self.sigma, sigma_m=self.sigma_m,
            noise_policy=self.noise_policy,
            coherence_rounds=self.coherence_rounds,
            target_epsilon=self.target_epsilon, gamma=self.gamma,
            clip=self.clip, delta=self.delta,
            sparse_k=self.sparse_neighbors,
            graph_fallback=self.graph_fallback,
            target_total_epsilon=self.target_total_epsilon,
            horizon=self.horizon, accountant=self.accountant, device=device)

    def plan(self, chan, device="cuda", W=None) -> exchange_lib.MixPlan:
        """The fused flat round's MixPlan for this scheme (W: the round's
        mixing matrix on the dynamic network, its participation mask when
        sampled)."""
        return _flat_spec(self, self.channel_model == "dynamic").plan(
            self, chan, device, W)


def _flat_spec(proto: ProtocolConfig, dynamic: bool
               ) -> exchange_lib.ExchangeSpec:
    spec = exchange_lib.resolve_spec(proto, dynamic=dynamic)
    if not spec.fuse_ok:
        raise ValueError(
            f"flat-buffer training supports the mixing-family exchanges "
            f"only (dwfl/gossip); spec {spec.name!r} has no fused plan")
    return spec


def sample_participation(generator: torch.Generator, n_workers: int,
                         q: float) -> torch.Tensor:
    """Bool [N] transmit mask at rate q with a randomized guaranteed pair:
    the exchange needs >= 2 transmitters, and a pair drawn uniformly
    without replacement spreads the extra transmissions evenly, so every
    worker's realized rate is ``effective_participation(q, N)``. On the
    generator's device."""
    dev = generator.device
    mask = torch.rand((n_workers,), generator=generator, device=dev) < q
    pair = torch.argsort(torch.rand((n_workers,), generator=generator,
                                    device=dev))[:2]
    return mask.scatter(0, pair, True)


def effective_participation(q: float, n_workers: int) -> float:
    """The per-round transmit rate under the guaranteed pair, the same for
    every worker: q + (1 - q) 2/N. The amplification bound uses this, not
    the nominal q."""
    if q >= 1.0:
        return 1.0
    return q + (1.0 - q) * 2.0 / n_workers


def init_worker_params(generator: torch.Generator, cfg: ModelConfig,
                       n_workers: int, device="cuda"):
    """Every worker starts from the same random point: one init, copied
    into [N, ...] leaves (materialized, each worker its own memory)."""
    params = M.init_params(generator, cfg, device=resolve_device(device))
    return exchange_lib.tree_map(
        lambda l: l.expand((n_workers,) + tuple(l.shape)).contiguous(),
        params)


def epsilon_report(proto: ProtocolConfig, chan, T: Optional[int] = None,
                   Ws=None) -> dict:
    """Privacy report. Static channel: per-round budgets of the scheme
    actually run (the orthogonal per-link budget, a ring's or torus's
    per-receiver one, Theorem 4.1's otherwise), amplified when the round
    samples, and with ``T`` the T-round totals under both accountants at
    the configured delta. Dynamic channel: ``chan`` is the stacked
    trajectory ([T, ...], ``net.stack_states``) and ``Ws`` its [T, N, N]
    mixing matrices (or a stacked SparseW) — each receiver is credited with the masking noise of
    the workers it heard — and the report carries the per-round worst
    budgets and their composition under both accountants."""
    if proto.channel_model == "dynamic":
        eps_tn = privacy.epsilon_trajectory(
            proto.gamma, proto.clip, chan, proto.delta, Ws).cpu().numpy()
        per_round = eps_tn.max(axis=1)                     # worst receiver
        ea, da = privacy.compose_heterogeneous(per_round, proto.delta)
        both = accounting.compose_trajectory(per_round, proto.delta,
                                             delta_ref=proto.delta)
        return {
            "epsilon_per_round": per_round,
            "epsilon_worst": float(per_round.max()),
            "epsilon_mean": float(per_round.mean()),
            "epsilon_trajectory_composed": ea,
            "delta_trajectory_composed": da,
            "epsilon_advanced": float(both["epsilon_advanced"]),
            "epsilon_rdp": float(both["epsilon_rdp"]),
            "epsilon_total": float(both["epsilon"]),
            "rdp_order": float(both["rdp_order"]),
            "accountant_gap": float(both["gap_ratio"]),
            "delta_total": float(both["delta"]),
            "accountant": proto.accountant,
            "saturated": bool(both["saturated"]),
            "sigma": chan.sigma.cpu().numpy(),
            "rounds": int(per_round.shape[0]),
        }
    eps = privacy.epsilon_dwfl(proto.gamma, proto.clip, chan, proto.delta)
    eps_orth = privacy.epsilon_orthogonal(proto.gamma, proto.clip, chan,
                                          proto.delta)
    if proto.scheme == "orthogonal":
        eps_scheme = eps_orth
    elif proto.scheme == "dwfl" and proto.topology != "complete":
        eps_scheme = privacy.epsilon_dwfl_topology(
            proto.gamma, proto.clip, chan, proto.delta, proto.mixing_matrix())
    else:
        eps_scheme = eps
    rep = {
        "epsilon_per_worker": eps_scheme,
        "epsilon_worst": float(eps_scheme.max()),
        "epsilon_complete_graph_worst": float(eps.max()),
        "epsilon_orthogonal_worst": float(eps_orth.max()),
        "sigma": chan.cfg.sigma,
    }
    # T-round composition starts from the budget of the scheme run;
    # amplification only where the round samples (the complete-graph dwfl
    # round: the others transmit every round), at the worst-case realized
    # rate of the randomized guaranteed pair
    e_round, d_round = float(eps_scheme.max()), proto.delta
    samples = (proto.participation < 1.0 and proto.scheme == "dwfl"
               and proto.topology == "complete")
    if samples:
        q_eff = effective_participation(proto.participation, proto.n_workers)
        rep["participation_nominal"] = proto.participation
        rep["participation_effective"] = q_eff
        e_round, d_round = privacy.epsilon_sampled(e_round, d_round, q_eff)
        rep["epsilon_sampled"] = e_round
    if T:
        ea, da = privacy.compose_advanced(e_round, d_round, T)
        rep["epsilon_T_advanced"], rep["delta_T_advanced"] = ea, da
        # both accountants at the configured total delta (the delta-split
        # rule); the RDP ledger with sampling is the subsampled-Gaussian
        # moments at the worst-case effective rate
        d_r, d_p = accounting.split_delta(proto.delta, T)
        rho_r = accounting.rho_from_epsilon(float(eps_scheme.max()),
                                            proto.delta)
        if samples:
            rdp_round = accounting.rdp_subsampled_gaussian(rho_r, q_eff)
            e_split, d_split = privacy.epsilon_sampled(
                accounting.rescale_epsilon_delta(
                    float(eps_scheme.max()), proto.delta, d_r),
                d_r, q_eff)
        else:
            rdp_round = np.asarray(accounting.ORDER_GRID) * rho_r
            e_split, d_split = accounting.rescale_epsilon_delta(
                float(eps_scheme.max()), proto.delta, d_r), d_r
        ea_split, _ = privacy.compose_advanced(e_split, d_split, T, d_p)
        er, order = accounting.rdp_to_epsilon(T * rdp_round, proto.delta)
        rep["epsilon_T_advanced_split"] = ea_split
        rep["epsilon_T_rdp"] = er
        rep["epsilon_T_total"] = min(er, ea_split)
        rep["rdp_order"] = order
        rep["accountant_gap"] = ea_split / max(er, 1e-300)
        rep["delta_T_total"] = proto.delta
        rep["accountant"] = proto.accountant
        rep["saturated"] = ea_split >= privacy.EPS_SATURATION
    return rep


def _make_local_pass(cfg: ModelConfig, proto: ProtocolConfig):
    """The worker-tree local pass: (local_grads, local_step).

    local_grads(worker_params, batch) -> (losses [N], clipped grads tree,
    norms [N]); local_step(worker_params, grads) -> p - gamma g per leaf."""
    gamma = proto.gamma

    def local_grads(worker_params, batch):
        leaves, structure = exchange_lib.tree_flatten(worker_params)
        with torch.enable_grad():
            ps = [l.detach().requires_grad_(True) for l in leaves]
            losses = M.worker_losses(
                exchange_lib.tree_unflatten(structure, ps), batch, cfg)
            gs = torch.autograd.grad(losses.sum(), ps)
        g, gnorms = privacy.clip_gradient_tree(
            exchange_lib.tree_unflatten(structure, list(gs)), proto.clip)
        return losses.detach(), g, gnorms

    def local_step(worker_params, grads):
        if proto.use_pallas:
            # every leaf in one launch of the dp_perturb kernel
            ps, structure = exchange_lib.tree_flatten(worker_params)
            gs, _ = exchange_lib.tree_flatten(grads)
            return exchange_lib.tree_unflatten(
                structure, dp_ops.sgd_update_leaves(ps, gs, gamma))
        return exchange_lib.tree_map(
            lambda p, g: (p.float() - gamma * g.float()).to(p.dtype),
            worker_params, grads)

    return local_grads, local_step


def _bucket(X, lead_axes: int = 1):
    """Worker tree -> ({"flat": [N, d] float32}, unravel): the per-round
    fuse_exchange bucketing (the fleet's [R, N, d]: lead_axes 2)."""
    spec = exchange_lib.FlatSpec(X, lead_axes)
    return {"flat": spec.flatten(X)}, spec.unravel


def _metrics(losses, gnorms, X):
    leaves, _ = exchange_lib.tree_flatten(X)
    return {"loss": losses.mean(), "grad_norm": gnorms.mean(),
            "param_norm": torch.sqrt(sum(torch.sum(x.float() ** 2)
                                         for x in leaves))}


def _round_plan(proto: ProtocolConfig, spec: exchange_lib.ExchangeSpec,
                dev) -> Callable:
    """``plan_of(generator, mask)``: a static round's MixPlan. Built once
    here, with the channel; under sampled participation each round draws
    its mask from ``generator`` (unless ``mask`` is given) and only the
    mask's terms are rebuilt, on the device."""
    chan = proto.channel()
    if spec.name != "sampled":
        plan = spec.plan(proto, chan, dev)
        return lambda generator, mask: plan
    base = exchange_lib.plan_complete(proto, chan, dev)

    def plan_of(generator, mask):
        if mask is None:
            if generator is None:
                raise ValueError("a sampled round needs its participation "
                                 "mask or a generator to draw it from")
            mask = sample_participation(generator, proto.n_workers,
                                        proto.participation)
        return exchange_lib.resample(base, mask)

    return plan_of


def _exchange(X, spec, plan, proto, generator, normals, lead_axes=1,
              axis=None):
    """The worker-tree exchange of a round: bucketed into one flat leaf
    with ``fuse_exchange``, its normals drawn from ``generator`` unless
    given (``axis``: the collective route's process group)."""
    unravel = None
    if proto.fuse_exchange and spec.fuse_ok:
        X, unravel = _bucket(X, lead_axes)
    if normals is None and plan.noisy:
        normals = exchange_lib.draw_normals(X, generator,
                                            shared_m=spec.shared_m)
    X = spec.run(X, normals, plan, proto, axis=axis)
    return X if unravel is None else unravel(X["flat"])


def make_train_step(cfg: ModelConfig, proto: ProtocolConfig,
                    device="cuda", axis=None) -> Callable:
    """The static-channel worker-tree round:

        step(worker_params, batch, generator, normals=None, mask=None)
            -> (worker_params', metrics)

    worker_params: a tree of [N, ...] leaves; batch leaves [N, B, ...].
    After the gradients the round draws from ``generator``, in this
    order, its participation mask (sampled participation only) and its
    noise (``exchange.draw_normals``), unless ``mask`` (bool [N]) or
    ``normals`` ({"n", "m"} trees of standard normals in that layout) is
    given. The channel and the scheme's plan are realized once, here.

    ``axis``: a process group of one worker a rank (leaves [1, ...]), the
    reference's collective path: the complete-graph dwfl round is then
    ``exchange.resolve_spec``'s collective route (an ``all_reduce``); each
    rank draws its own worker's noise from its ``generator``.
    """
    dev = resolve_device(device)
    spec = exchange_lib.resolve_spec(proto, axis)
    plan_of = _round_plan(proto, spec, dev)
    local_grads, local_step = _make_local_pass(cfg, proto)

    def step(worker_params, batch, generator, normals=None, mask=None):
        losses, grads, gnorms = local_grads(worker_params, batch)
        X = local_step(worker_params, grads)
        del grads  # one tree the model's size less through the exchange
        if proto.n_workers < 2:
            # no peers to exchange with: a plain local SGD round
            return X, _metrics(losses, gnorms, X)
        X = _exchange(X, spec, plan_of(generator, mask), proto, generator,
                      normals, axis=axis)
        return X, _metrics(losses, gnorms, X)

    return step


def make_dynamic_train_step(cfg: ModelConfig, proto: ProtocolConfig,
                            device="cuda") -> Callable:
    """The worker-tree round on the dynamic network (channel_model=
    "dynamic", dwfl only):

        step(worker_params, batch, generator, chan, W, normals=None)
            -> (worker_params', metrics)

    ``chan`` (net.TracedChannelState) and ``W`` [N, N] are the round's,
    from ``NetworkSimulator.round``: arguments, so one step serves every
    fading block, geometry and churn draw. The noise is drawn from
    ``generator`` after the gradients unless ``normals`` is given; with
    ``use_pallas`` the local step is one dp_perturb launch."""
    dev = resolve_device(device)
    spec = exchange_lib.resolve_spec(proto, dynamic=True)
    local_grads, local_step = _make_local_pass(cfg, proto)

    def step(worker_params, batch, generator, chan, W, normals=None):
        losses, grads, gnorms = local_grads(worker_params, batch)
        X = local_step(worker_params, grads)
        del grads  # one tree the model's size less through the exchange
        if proto.n_workers < 2:
            return X, _metrics(losses, gnorms, X)
        X = _exchange(X, spec, spec.plan(proto, chan, dev, W), proto,
                      generator, normals)
        return X, _metrics(losses, gnorms, X)

    return step


def make_flat_local_pass(cfg: ModelConfig, proto: ProtocolConfig,
                         spec: exchange_lib.FlatSpec,
                         remat: bool = False) -> Callable:
    """flat [N, width], batch -> (losses [N], clipped grads [N, d], norms
    [N]): the gradients of the canonical d columns.

    The gradients are taken per leaf, of views of the buffer, and raveled
    once: through the views of one [N, d] tensor, autograd would make a
    zero-padded [N, d] gradient for every leaf and add them up. ``remat``
    recomputes the workers' forward in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` around
    each worker's forward; here the workers' forward is one batched pass):
    activation memory for a second forward, the same gradients. The
    forward draws nothing, so the recomputation keeps no RNG state
    (``preserve_rng_state=False``: reading the card's default generator
    fails inside a CUDA graph's capture)."""
    def local_grads(flat, batch):
        with torch.enable_grad():
            leaves, structure = exchange_lib.tree_flatten(
                spec.unravel(flat.detach()))
            ps = [l.detach().requires_grad_(True) for l in leaves]
            forward = lambda *xs: M.worker_losses(
                exchange_lib.tree_unflatten(structure, list(xs)), batch, cfg)
            if remat:
                from torch.utils.checkpoint import checkpoint
                losses = checkpoint(forward, *ps, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                losses = forward(*ps)
            gs = torch.autograd.grad(losses.sum(), ps)
        g = spec.ravel(exchange_lib.tree_unflatten(structure, list(gs)))
        del gs
        g, gnorms = privacy.clip_gradient_tree(g, proto.clip)
        return losses.detach(), g, gnorms
    return local_grads


def _flat_metrics(losses, gnorms, flat):
    return {"loss": losses.mean(), "grad_norm": gnorms.mean(),
            "param_norm": torch.sqrt(torch.sum(flat.float() ** 2))}


def make_flat_train_step(cfg: ModelConfig, proto: ProtocolConfig,
                         spec: exchange_lib.FlatSpec, device="cuda"
                         ) -> Callable:
    """The static-channel flat-buffer round:

        step(flat, batch, seed, generator=None, mask=None)
            -> (flat', metrics)                         # flat: [N, d] f32

    ``seed`` is the round's int32 noise seed (an int or an int32 tensor on
    the device — the reference's ``seed_from_key(k_n)``). Under sampled
    participation the round's mask is ``mask`` or drawn from
    ``generator``. The channel and the mix plan are realized once, here.
    """
    dev = resolve_device(device)
    plan_of = _round_plan(proto, _flat_spec(proto, dynamic=False), dev)
    local_grads = make_flat_local_pass(cfg, proto, spec)
    gamma, eta = proto.gamma, proto.eta

    def step(flat, batch, seed, generator=None, mask=None):
        losses, g, gnorms = local_grads(flat, batch)
        if proto.n_workers < 2:
            flat = flat - gamma * g
        else:
            flat = mix_ops.dp_mix_round_plan(flat, g, seed,
                                             plan_of(generator, mask),
                                             gamma=gamma, eta=eta)
        return flat, _flat_metrics(losses, gnorms, flat)

    return step


def make_dynamic_flat_train_step(cfg: ModelConfig, proto: ProtocolConfig,
                                 spec: exchange_lib.FlatSpec, device="cuda"
                                 ) -> Callable:
    """The flat-buffer round on the dynamic network:

        step(flat, batch, seed, chan, W, out=None) -> (flat', metrics)

    ``chan``/``W`` are the round's (``NetworkSimulator.round``); the plan
    (``exchange.plan_dynamic``: W, listen = 0 for a worker with no
    neighbor, m_scale = 1/(c deg)) is built from them on the device and
    the dp_mix kernel takes every channel quantity as an operand, so the
    round never waits for the host. ``out`` (a neighbor-list W's round
    only, which ``step.writes_into`` declares; it may be ``flat``): the
    tensor flat' is written into (``ops.dp_mix_round_sparse``)."""
    dev = resolve_device(device)
    mix = _flat_spec(proto, dynamic=True)
    local_grads = make_flat_local_pass(cfg, proto, spec)
    gamma, eta = proto.gamma, proto.eta

    def step(flat, batch, seed, chan, W, out=None):
        losses, g, gnorms = local_grads(flat, batch)
        if proto.n_workers < 2:
            flat = _into(flat - gamma * g, out)
        else:
            flat = mix_ops.dp_mix_round_plan(
                flat, g, seed, mix.plan(proto, chan, dev, W),
                gamma=gamma, eta=eta, out=out)
        return flat, _flat_metrics(losses, gnorms, flat)

    # the steps that take ``out`` say so (``trajectory._marked``)
    step.writes_into = proto.sparse_neighbors > 0
    return step


def _into(new, out):
    """``new``, or ``out`` holding its values."""
    return new if out is None else out.copy_(new)


def _fold(tree, R: int, N: int):
    """[R, N, ...] leaves -> [R N, ...] (the fleet's workers as one
    batch), and back with ``_unfold``."""
    return exchange_lib.tree_map(lambda l: l.reshape((R * N,) + l.shape[2:]),
                                 tree)


def _unfold(tree, R: int, N: int):
    return exchange_lib.tree_map(lambda l: l.reshape((R, N) + l.shape[1:]),
                                 tree)


def _fleet_metrics(losses, gnorms, leaves, R: int, N: int) -> dict:
    """Per replicate [R]: mean loss and gradient norm over its workers,
    the norm of its parameters."""
    sq = sum(torch.sum(x.float().reshape(R, -1) ** 2, dim=1) for x in leaves)
    return {"loss": losses.reshape(R, N).mean(-1),
            "grad_norm": gnorms.reshape(R, N).mean(-1),
            "param_norm": torch.sqrt(sq)}


def make_fleet_flat_train_step(cfg: ModelConfig, proto: ProtocolConfig,
                               spec: exchange_lib.FlatSpec, device="cuda"
                               ) -> Callable:
    """The dynamic flat round of R networks at once:

        step(flat, batch, seeds, chans, Ws, out=None) -> (flat', metrics)

    flat [R, N, d] float32 (``out`` as ``make_dynamic_flat_train_step``'s); batch leaves [R, N, B, ...]; seeds int32 [R],
    one a replicate (each replicate's noise counters from 0); chans the
    networks' stacked channel ([R, ...] leaves) and Ws [R, N, N] (with
    ``sparse_neighbors``, a SparseW of [R, N, k] leaves), from one
    ``NetworkSimulator.round`` of a stacked state; metrics [R] each.
    Replicate r is ``make_dynamic_flat_train_step``'s round on replicate
    r's operands (up to the order of the gradient pass's products). The
    gradients of the R N workers come from one pass, the stacked plan
    (``exchange.plan_dynamic`` or ``plan_dynamic_sparse``) from one call,
    and the mix is one dp_mix call for all R (one launch dense; one
    dp_mix_prep and one dp_mix_gather through neighbor lists)."""
    dev = resolve_device(device)
    mix = _flat_spec(proto, dynamic=True)
    local_grads = make_flat_local_pass(cfg, proto, spec)
    gamma, eta = proto.gamma, proto.eta

    def step(flat, batch, seeds, chans, Ws, out=None):
        R, N, d = flat.shape
        losses, g, gnorms = local_grads(flat.reshape(R * N, d),
                                        _fold(batch, R, N))
        g = g.reshape(R, N, d)
        if proto.n_workers < 2:
            flat = _into(flat - gamma * g, out)
        else:
            flat = mix_ops.dp_mix_round_plan(
                flat, g, seeds, mix.plan(proto, chans, dev, Ws),
                gamma=gamma, eta=eta, out=out)
        return flat, _fleet_metrics(losses, gnorms, [flat], R, N)

    step.writes_into = proto.sparse_neighbors > 0
    return step


def make_fleet_train_step(cfg: ModelConfig, proto: ProtocolConfig,
                          device="cuda") -> Callable:
    """The dynamic worker-tree round of R networks at once:

        step(worker_params, batch, generator, chans, Ws, normals=None)
            -> (worker_params', metrics)

    worker_params leaves [R, N, ...], the rest as
    ``make_fleet_flat_train_step``'s. The gradients of the R N workers
    come from one pass; the local step takes the [R, N, ...] leaves as
    they are (with ``use_pallas`` one ``sgd_update_leaves`` launch a
    round); the exchange mixes each replicate by its own W in batched
    products (through a stacked neighbor list, by its own row gathers),
    its normals drawn from ``generator`` over the [R, N, ...] leaves
    unless given."""
    dev = resolve_device(device)
    spec = exchange_lib.resolve_spec(proto, dynamic=True)
    local_grads, local_step = _make_local_pass(cfg, proto)

    def step(worker_params, batch, generator, chans, Ws, normals=None):
        leaves, _ = exchange_lib.tree_flatten(worker_params)
        R, N = leaves[0].shape[:2]
        losses, grads, gnorms = local_grads(_fold(worker_params, R, N),
                                            _fold(batch, R, N))
        X = local_step(worker_params, _unfold(grads, R, N))
        del grads  # one tree the model's size less through the exchange
        if proto.n_workers >= 2:
            X = _exchange(X, spec, spec.plan(proto, chans, dev, Ws), proto,
                          generator, normals, lead_axes=2)
        return X, _fleet_metrics(losses, gnorms,
                                 exchange_lib.tree_flatten(X)[0], R, N)

    return step


def make_eval_fn(cfg: ModelConfig) -> Callable:
    """Per-worker eval over worker-stacked parameters: (mean loss, mean
    accuracy) over the workers, the reference's. The classifier's loss and
    accuracy against "y"; an LM's training loss (with the MoE's aux term)
    and its accuracy against the batch's "labels", else its next-token
    accuracy on "tokens". Both are NaN for a batch with neither "y",
    "labels" nor "tokens", where they are undefined — not a 0.0 that reads
    as a broken model."""
    @torch.no_grad()
    def evaluate(worker_params, batch):
        if cfg.family == "mlp":
            logits, _ = M.forward(worker_params, batch, cfg)
            labels = batch.get("y", batch.get("labels"))
            if labels is None:
                return _nan(logits.device)
            loss = M.cross_entropy(logits, labels).mean()
            return loss, (logits.argmax(-1) == labels).float().mean()
        if "labels" not in batch and "tokens" not in batch:
            return _nan(next(iter(batch.values())).device)
        n = next(iter(batch.values())).shape[0]
        losses, accs = [], []
        for i, p in enumerate(M.transformer.unstack(worker_params, n)):
            b = {k: v[i] for k, v in batch.items()}
            loss, logits = M.lm_loss_and_logits(p, b, cfg)
            if "labels" in b:
                hit = logits.argmax(-1) == b["labels"]
            else:
                hit = logits[:, :-1].argmax(-1) == b["tokens"][:, 1:]
            losses.append(loss)
            accs.append(hit.float().mean())
        return torch.stack(losses).mean(), torch.stack(accs).mean()
    return evaluate


def _nan(device):
    nan = torch.tensor(float("nan"), device=device)
    return nan, nan
