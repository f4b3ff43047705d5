"""Protocol configuration and the two static DWFL train steps — the static
paths of the reference's ``repro.core.protocol``.

``make_train_step`` is the worker-tree round: per-worker clipped gradients
over worker-stacked parameter trees -> the local SGD step of every leaf
(with ``use_pallas`` one launch of the hand-written dp_perturb kernel
over all the leaves, ``sgd_update_leaves``)
-> the scheme's exchange (dwfl, gossip, orthogonal, centralized), with
its noise drawn per leaf -> metrics. ``make_flat_train_step`` is the
flat-buffer round: the same gradients on the persistent flat [N, d]
buffer -> one fused dp_mix round (local step, counter-hash DP noise,
mixing, self-correction and AWGN). Both route the scheme through
``exchange.resolve_spec``.

Per-worker gradients need no vmap: every worker's forward runs at once
through batched matrix products over the worker-stacked leaves, and the
gradient of the SUM of the per-worker losses has, in worker i's slice of
each leaf, worker i's own gradient (that slice enters only loss i).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import exchange as exchange_lib
from repro_torch.core import privacy
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
    topology: str = "complete"    # only the paper's complete graph is
                                  # ported (ROADMAP A4)
    participation: float = 1.0    # only full participation is ported (A4)

    def require_complete_graph(self) -> None:
        """The ring/torus calibration and budget of a dwfl run
        (``sigma_for_epsilon_topology``, ``epsilon_dwfl_topology``) are not
        ported: refuse rather than quote the complete-graph formulas,
        which understate that budget."""
        if self.scheme == "dwfl" and self.topology != "complete":
            raise NotImplementedError(
                f"the privacy calibration and budget of topology "
                f"{self.topology!r} are not ported yet (ROADMAP A4)")

    def channel(self) -> ChannelState:
        self.require_complete_graph()
        chan = ChannelConfig(
            n_workers=self.n_workers, p_dbm=self.p_dbm, sigma=self.sigma,
            sigma_m=self.sigma_m, fading=self.fading, seed=self.seed,
            noise_policy=self.noise_policy,
        ).realize()
        if self.target_epsilon > 0:
            # scheme-aware: "the same epsilon" is the scheme's OWN worst
            # budget; the orthogonal per-link budget needs far more noise
            # than the DWFL aggregate at equal sigma (Remark 4.1)
            calibrate = (privacy.sigma_for_epsilon_orthogonal
                         if self.scheme == "orthogonal"
                         else privacy.sigma_for_epsilon)
            sig = calibrate(self.target_epsilon, self.gamma, self.clip, chan,
                            self.delta)
            chan = chan.with_sigma(max(sig, 1e-12))
        return chan

    def plan(self, chan: ChannelState, device="cuda") -> exchange_lib.MixPlan:
        """The fused flat round's MixPlan for this scheme."""
        spec = exchange_lib.resolve_spec(self)
        if not spec.fuse_ok:
            raise ValueError(
                f"flat-buffer training supports the mixing-family exchanges "
                f"only (dwfl/gossip); spec {spec.name!r} has no fused plan")
        return spec.plan(self, chan, device)


def init_worker_params(generator: torch.Generator, cfg: ModelConfig,
                       n_workers: int, device="cuda"):
    """Every worker starts from the same random point: one init, copied
    into [N, ...] leaves (materialized, each worker its own memory)."""
    params = M.init_params(generator, cfg, device=resolve_device(device))
    return exchange_lib.tree_map(
        lambda l: l.expand((n_workers,) + tuple(l.shape)).contiguous(),
        params)


def epsilon_report(proto: ProtocolConfig, chan: ChannelState) -> dict:
    """Static-channel privacy report: per-round budgets. The headline
    (``epsilon_per_worker``/``epsilon_worst``) is the budget of the scheme
    actually run — the orthogonal per-link budget for an orthogonal run,
    Theorem 4.1's per-receiver budget otherwise. A dwfl run on a
    topology other than the complete graph raises (ROADMAP A4)."""
    proto.require_complete_graph()
    eps = privacy.epsilon_dwfl(proto.gamma, proto.clip, chan, proto.delta)
    eps_orth = privacy.epsilon_orthogonal(proto.gamma, proto.clip, chan,
                                          proto.delta)
    eps_scheme = eps_orth if proto.scheme == "orthogonal" else eps
    return {
        "epsilon_per_worker": eps_scheme,
        "epsilon_worst": float(eps_scheme.max()),
        "epsilon_complete_graph_worst": float(eps.max()),
        "epsilon_orthogonal_worst": float(eps_orth.max()),
        "sigma": chan.cfg.sigma,
    }


def _make_local_pass(cfg: ModelConfig, proto: ProtocolConfig):
    """The worker-tree local pass: (local_grads, local_step).

    local_grads(worker_params, batch) -> (losses [N], clipped grads tree,
    norms [N]); local_step(worker_params, grads) -> p - gamma g per leaf."""
    gamma = proto.gamma

    def local_grads(worker_params, batch):
        leaves, structure = exchange_lib.tree_flatten(worker_params)
        with torch.enable_grad():
            ps = [l.detach().requires_grad_(True) for l in leaves]
            losses = M.loss_fn(exchange_lib.tree_unflatten(structure, ps),
                               batch, cfg)
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


def _bucket(X):
    """Worker tree -> ({"flat": [N, d] float32}, unravel): the per-round
    fuse_exchange bucketing."""
    unravel, _ = exchange_lib.worker_unravelers(X)
    return {"flat": exchange_lib.flatten_worker_tree(X)}, unravel


def _metrics(losses, gnorms, X):
    leaves, _ = exchange_lib.tree_flatten(X)
    return {"loss": losses.mean(), "grad_norm": gnorms.mean(),
            "param_norm": torch.sqrt(sum(torch.sum(x.float() ** 2)
                                         for x in leaves))}


def make_train_step(cfg: ModelConfig, proto: ProtocolConfig,
                    device="cuda") -> Callable:
    """The static-channel worker-tree round:

        step(worker_params, batch, generator, normals=None)
            -> (worker_params', metrics)

    worker_params: a tree of [N, ...] leaves; batch leaves [N, B, ...].
    The round's noise is drawn from ``generator`` after the gradients
    (``exchange.draw_normals``), unless ``normals`` ({"n", "m"} trees of
    standard normals in that layout) is given. The channel and the
    scheme's plan are realized once, here.
    """
    dev = resolve_device(device)
    spec = exchange_lib.resolve_spec(proto)
    plan = spec.plan(proto, proto.channel(), dev)
    local_grads, local_step = _make_local_pass(cfg, proto)

    def step(worker_params, batch, generator, normals=None):
        losses, grads, gnorms = local_grads(worker_params, batch)
        X = local_step(worker_params, grads)
        if proto.n_workers < 2:
            # no peers to exchange with: a plain local SGD round
            return X, _metrics(losses, gnorms, X)
        unravel = None
        if proto.fuse_exchange and spec.fuse_ok:
            X, unravel = _bucket(X)
        if normals is None and plan.noisy:
            normals = exchange_lib.draw_normals(X, generator,
                                                shared_m=spec.shared_m)
        X = spec.run(X, normals, plan, proto)
        if unravel is not None:
            X = unravel(X["flat"])
        return X, _metrics(losses, gnorms, X)

    return step


def make_flat_local_pass(cfg: ModelConfig, proto: ProtocolConfig,
                         spec: exchange_lib.FlatSpec) -> Callable:
    """flat [N, d], batch -> (losses [N], clipped grads [N, d], norms [N])."""
    def local_grads(flat, batch):
        with torch.enable_grad():
            f = flat.detach().requires_grad_(True)
            losses = M.loss_fn(spec.unravel(f), batch, cfg)
            (g,) = torch.autograd.grad(losses.sum(), f)
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

        step(flat, batch, seed) -> (flat', metrics)     # flat: [N, d] f32

    ``seed`` is the round's int32 noise seed (an int or an int32 tensor on
    the device — the reference's ``seed_from_key(k_n)``). The channel and
    the mix plan are realized once, here.
    """
    dev = resolve_device(device)
    plan = proto.plan(proto.channel(), dev)
    local_grads = make_flat_local_pass(cfg, proto, spec)
    gamma, eta = proto.gamma, proto.eta

    def step(flat, batch, seed):
        losses, g, gnorms = local_grads(flat, batch)
        if proto.n_workers < 2:
            flat = flat - gamma * g
        else:
            flat = mix_ops.dp_mix_round_plan(flat, g, seed, plan,
                                             gamma=gamma, eta=eta)
        return flat, _flat_metrics(losses, gnorms, flat)

    return step


def make_eval_fn(cfg: ModelConfig) -> Callable:
    """Per-worker eval over worker-stacked parameters: (mean loss, mean
    accuracy). Both are NaN for a batch without labels, where the
    classifier's loss and accuracy are undefined — not a 0.0 that reads
    as a broken model."""
    @torch.no_grad()
    def evaluate(worker_params, batch):
        logits, _ = M.forward(worker_params, batch, cfg)
        labels = batch.get("y", batch.get("labels"))
        if labels is None:
            nan = torch.tensor(float("nan"), device=logits.device)
            return nan, nan
        loss = M.cross_entropy(logits, labels).mean()
        return loss, (logits.argmax(-1) == labels).float().mean()
    return evaluate
