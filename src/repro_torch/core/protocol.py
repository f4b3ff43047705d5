"""Protocol configuration and the flat-buffer DWFL train step — the static
path of the reference's ``repro.core.protocol``.

``make_flat_train_step`` composes: per-worker clipped gradients on the
persistent flat [N, d] buffer -> one fused dp_mix round (local SGD step,
counter-hash DP noise, mixing, self-correction and AWGN) -> metrics.

Per-worker gradients need no vmap: the buffer is unraveled into
worker-stacked views, every worker's forward runs at once through batched
matrix products, and the gradient of the SUM of the per-worker losses
with respect to the buffer has, in row i, worker i's own gradient (row i
enters only loss i).
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
from repro_torch.models import model as M
from repro_torch.runtime import resolve_device


@dataclass(frozen=True)
class ProtocolConfig:
    scheme: str = "dwfl"          # dwfl (the paper) | gossip (sigma = sigma_m = 0)
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

    def channel(self) -> ChannelState:
        chan = ChannelConfig(
            n_workers=self.n_workers, p_dbm=self.p_dbm, sigma=self.sigma,
            sigma_m=self.sigma_m, fading=self.fading, seed=self.seed,
            noise_policy=self.noise_policy,
        ).realize()
        if self.target_epsilon > 0:
            sig = privacy.sigma_for_epsilon(
                self.target_epsilon, self.gamma, self.clip, chan, self.delta)
            chan = chan.with_sigma(max(sig, 1e-12))
        return chan

    def plan(self, chan: ChannelState, device="cuda") -> exchange_lib.MixPlan:
        """The fused round's MixPlan for this scheme."""
        if self.scheme == "dwfl":
            return exchange_lib.plan_complete(self, chan, device)
        if self.scheme == "gossip":
            return exchange_lib.plan_gossip(self, chan, device)
        raise NotImplementedError(f"scheme {self.scheme!r} is not ported yet "
                                  f"(ROADMAP A8)")


def init_worker_params(generator: torch.Generator, cfg: ModelConfig,
                       n_workers: int, device="cuda"):
    """Every worker starts from the same random point: one init, stacked
    to [N, ...] leaves (views of one copy)."""
    params = M.init_params(generator, cfg, device=resolve_device(device))
    leaves, structure = exchange_lib.tree_flatten(params)
    return exchange_lib.tree_unflatten(
        structure, [l.expand((n_workers,) + tuple(l.shape)) for l in leaves])


def epsilon_report(proto: ProtocolConfig, chan: ChannelState) -> dict:
    """Static-channel privacy report: per-round budgets of the scheme run
    and of the orthogonal baseline (Thm 4.1 / Remark 4.1)."""
    eps = privacy.epsilon_dwfl(proto.gamma, proto.clip, chan, proto.delta)
    eps_orth = privacy.epsilon_orthogonal(proto.gamma, proto.clip, chan,
                                          proto.delta)
    return {
        "epsilon_per_worker": eps,
        "epsilon_worst": float(eps.max()),
        "epsilon_orthogonal_worst": float(eps_orth.max()),
        "sigma": chan.cfg.sigma,
    }


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
