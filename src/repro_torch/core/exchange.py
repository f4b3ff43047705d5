"""The mixing-matrix exchange engine and the flat parameter buffer — the
port of the reference's ``repro.core.exchange``.

Every exchange of the mixing family is the one receiver-side update

    x_i <- x_i + eta * listen_i * [ sum_k W_ik (x_k + n_k / c) + m_scale_i * m_i
                                    - x_i - self_i * n_i / c ]

(``mix_exchange``, over worker-stacked leaves [N, ...]). A ``MixPlan``
carries its W and per-receiver vectors as device tensors and feeds both
the worker-tree round (``run_mix``) and the fused flat round
(``repro_torch.kernels.dp_mix.ops.dp_mix_round_plan``):

    ===========  ======================================  =================
    scheme       W                                       self / m / listen
    ===========  ======================================  =================
    dwfl         ((1) - I)/(N-1)  (``plan_complete``)    1 / m/(c(N-1)) / 1
    ring/torus   core.topology W  (``plan_topology``)    1 / m/(c deg)  / 1
    dynamic      the round's net W  (``plan_dynamic``)   1 / m/(c deg)  / deg > 0
    dyn. sparse  its neighbor list (``plan_dynamic_sparse``)  the same
    sampled      p_k(1-d_ik)/max(n_tx-p_i, 1)            p / m/(c den)  / 1
    gossip       complete, sigma = sigma_m = 0           1 / 0          / 1
    orthogonal   complete, c = 1, gain-inverted noise    0 / link AWGN  / 1
    centralized  (1)/N, eta = 1, shared PS AWGN          0 / m/(cN)     / 1
    ===========  ======================================  =================

A plan is built once per train-step factory where it is static, and per
round from the round's W (dynamic) or participation mask (sampled), on
the device: the dynamic plan reads a ``net.TracedChannelState``'s tensors
as they are, with no host round trip. ``resolve_spec`` routes a
ProtocolConfig to its ``ExchangeSpec``; only the mixing family
(``fuse_ok``) may run as the fused flat round. A neighbor-list W
(``net.sparse.SparseW``) mixes by k row gathers (``mix_exchange_sparse``;
``run_mix`` dispatches on it). The collective round (ROADMAP A14) is not
ported yet.

Randomness: a round's exchange consumes standard normals as a tree
({"n": ..., "m": ...}, ``draw_normals``), drawn from an explicit
``torch.Generator`` or passed in — the tests pass the reference's
realized ``jax.random`` normals, which are not re-derived here.

``FlatSpec`` ravels a parameter tree into the persistent [N, d] float32
buffer in the reference's order (jax's ``tree_flatten``: dict keys
sorted, so each layer is b then w).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Union

import numpy as np
import torch

from repro_torch.runtime import resolve_device


def mix_noise_amp(chan, device="cuda") -> torch.Tensor:
    """Per-worker DP-noise amplitude |h_k| sqrt(beta_k P_k) sigma, [N]: of
    the static ChannelState, or of a round's TracedChannelState, whose
    tensors it takes as they are on their device ([R, N] for a stack of
    networks)."""
    dev = resolve_device(device)
    if torch.is_tensor(chan.noise_scale):
        return (chan.noise_scale * chan.dp_sigma.unsqueeze(-1)).to(dev)
    return (torch.as_tensor(np.asarray(chan.noise_scale), dtype=torch.float32,
                            device=dev)
            * torch.tensor(chan.dp_sigma, dtype=torch.float32, device=dev))


def _scalar(v, dev) -> torch.Tensor:
    """A channel scalar (a float, or a 0-d tensor of a traced channel) as
    a float32 tensor on ``dev``; a tensor already there is not copied."""
    return torch.as_tensor(v, dtype=torch.float32, device=dev)


def complete_W(N: int, device="cuda") -> torch.Tensor:
    """The paper's W = (ones - I) / (N - 1)."""
    dev = resolve_device(device)
    return (torch.ones((N, N), device=dev)
            - torch.eye(N, device=dev)) / (N - 1)


def masked_complete_W(mask: torch.Tensor) -> torch.Tensor:
    """The complete graph on the active workers: each active worker
    averages the other active ones (the paper's W when all are), an
    inactive worker gets the identity row. Symmetric, doubly stochastic
    for >= 2 active workers; on the mask's device. A mask [R, N] (a stack
    of networks) gives [R, N, N]."""
    p = mask.to(torch.float32)
    n = p.shape[-1]
    n_act = torch.clamp_min(p.sum(-1), 2.0)[..., None, None]
    off = (p[..., :, None] * p[..., None, :]
           * (1.0 - torch.eye(n, device=p.device)))
    W = off / (n_act - 1.0)
    return W + torch.diag_embed(1.0 - W.sum(-1))


def sampled_W(participate: torch.Tensor):
    """Mixing under per-round participation (amplification by
    subsampling): receiver i averages the transmitters it hears, W_ik =
    p_k (1 - d_ik) / max(n_tx - p_i, 1). Returns (W, p, denom): ``p`` is
    also the self-correction mask (a worker subtracts its own noise only
    in rounds it sent), ``denom`` scales the receiver AWGN."""
    p = participate.to(torch.float32)
    N = p.shape[0]
    n_tx = torch.clamp_min(p.sum(), 2.0)
    denom = torch.clamp_min(n_tx - p, 1.0)
    W = (p[None, :] * (1.0 - torch.eye(N, device=p.device))) / denom[:, None]
    return W, p, denom


Vector = Union[torch.Tensor, float]      # [N] tensor, or one number for all


@dataclass(frozen=True)
class MixPlan:
    """Everything a round of one scheme needs beyond (params, grads)."""
    W: Any                                   # [N, N], or a SparseW
    c: torch.Tensor                          # alignment constant
    amp: torch.Tensor                        # [N] DP-noise amplitude
    sigma_m: torch.Tensor                    # receiver AWGN std
    self_scale: Optional[Vector] = None
    m_scale: Optional[Vector] = None
    listen: Optional[Vector] = None
    noisy: bool = True


def plan_complete(proto, chan, device="cuda", W=None) -> MixPlan:
    dev = resolve_device(device)
    N = chan.n_workers
    c = torch.tensor(chan.c, dtype=torch.float32, device=dev)
    return MixPlan(W=complete_W(N, dev), c=c, amp=mix_noise_amp(chan, dev),
                   sigma_m=torch.tensor(chan.awgn_sigma, dtype=torch.float32,
                                        device=dev),
                   m_scale=torch.full((N,), 1.0, device=dev)
                   / float(chan.c * (N - 1)))


def plan_gossip(proto, chan, device="cuda", W=None) -> MixPlan:
    dev = resolve_device(device)
    N = chan.n_workers
    return MixPlan(W=complete_W(N, dev),
                   c=torch.tensor(chan.c, dtype=torch.float32, device=dev),
                   amp=torch.zeros((N,), device=dev),
                   sigma_m=torch.zeros((), device=dev),
                   m_scale=torch.zeros((N,), device=dev), noisy=False)


def _deg_scale(W: torch.Tensor, c) -> torch.Tensor:
    """m_scale_i = 1/(c deg_i): the receiver AWGN over the neighborhood
    size (deg counts the positive entries of the row, diagonal too)."""
    deg = (W > 0).sum(1).to(torch.float32)
    return 1.0 / (c * torch.clamp_min(deg, 1.0))


def plan_topology(proto, chan, device="cuda", W=None) -> MixPlan:
    """A static gossip topology: ``proto.mixing_matrix()`` unless W is
    given."""
    dev = resolve_device(device)
    W = torch.as_tensor(proto.mixing_matrix() if W is None else W,
                        dtype=torch.float32, device=dev)
    return MixPlan(W=W, c=_scalar(chan.c, dev), amp=mix_noise_amp(chan, dev),
                   sigma_m=_scalar(chan.awgn_sigma, dev),
                   m_scale=_deg_scale(W, chan.c))


def plan_dynamic(proto, chan, device="cuda", W=None) -> MixPlan:
    """A round of the dynamic network from its W (``net``): a worker with
    no active neighbor (churned out, or isolated by the interference
    graph; its W row is e_i) takes no update this round — it hears
    neither the superposition nor its AWGN (listen = 0). A stack of R
    networks (W [R, N, N], the channel's leaves [R, ...]) gives the stack
    of their plans: W [R, N, N], c and sigma_m [R], the vectors [R, N]."""
    dev = resolve_device(device)
    if W is None:
        raise ValueError("the dynamic plan needs the round's mixing matrix")
    W = W.to(device=dev, dtype=torch.float32)
    off_deg = ((W > 0) & ~torch.eye(W.shape[-1], dtype=torch.bool,
                                     device=dev)).sum(-1)
    deg = torch.clamp_min(off_deg.to(torch.float32), 1.0)
    c = _scalar(chan.c, dev)
    return MixPlan(W=W, c=c, amp=mix_noise_amp(chan, dev),
                   sigma_m=_scalar(chan.awgn_sigma, dev),
                   m_scale=1.0 / (c.unsqueeze(-1) * deg),
                   listen=(off_deg > 0).to(torch.float32))


def plan_dynamic_sparse(proto, chan, device="cuda", W=None) -> MixPlan:
    """``plan_dynamic`` for a round's neighbor list (``net.sparse.SparseW``):
    the plan carries the SparseW as its W, and its listen and m_scale are
    the dense plan's (the off-degree counts the same integers as
    sum((W > 0) & ~eye, 1))."""
    dev = resolve_device(device)
    if W is None:
        raise ValueError("the dynamic plan needs the round's mixing matrix")
    sw = W.to(dev)
    off_deg = sw.off_degree()
    c = _scalar(chan.c, dev)
    return MixPlan(W=sw, c=c, amp=mix_noise_amp(chan, dev),
                   sigma_m=_scalar(chan.awgn_sigma, dev),
                   m_scale=1.0 / (c * torch.clamp_min(off_deg, 1.0)),
                   listen=(off_deg > 0).to(torch.float32))


def resample(plan: MixPlan, mask: torch.Tensor) -> MixPlan:
    """``plan``'s channel terms on a round's participation mask: the
    sampled W, ``self_scale`` = the mask, m_scale = 1/(c denom)."""
    W, p, denom = sampled_W(mask.to(plan.W.device))
    return dataclasses.replace(plan, W=W, self_scale=p,
                               m_scale=1.0 / (plan.c * denom))


def plan_sampled(proto, chan, device="cuda", W=None) -> MixPlan:
    """Per-round participation; W here is the round's bool [N] transmit
    mask (``protocol.sample_participation``)."""
    if W is None:
        raise ValueError("the sampled plan needs the round's participation "
                         "mask")
    return resample(plan_complete(proto, chan, device), W)


# Floor for the inverted per-link gain |h_j| sqrt(alpha_j P_j) of the
# orthogonal baseline: a deep-fade draw would send the inverted AWGN std to
# infinity. The clamp caps any single link's noise inflation at 40 dB
# (power) below the best link.
ORTHOGONAL_GAIN_FLOOR = 1e-2


def plan_orthogonal(proto, chan, device="cuda", W=None) -> MixPlan:
    """The orthogonal (pairwise, digital-style) baseline in engine terms:
    complete-graph W over gain-inverted signals (noise already at
    parameter scale, so c = 1), no self-correction; ``amp`` is the
    sender's noise std after gain inversion and ``sigma_m`` the per-link
    AWGN std averaged over the N - 1 links."""
    dev = resolve_device(device)
    N = chan.n_workers
    inv_gain = (np.sqrt(chan.beta / np.maximum(chan.alpha, 1e-9))
                * chan.dp_sigma)
    gain = chan.h * np.sqrt(chan.alpha * chan.P)
    gain = np.maximum(gain, max(ORTHOGONAL_GAIN_FLOOR * float(np.max(gain)),
                                1e-30))
    link_std = chan.awgn_sigma / gain
    mean_m_std = float(np.sqrt(np.mean(link_std ** 2) / (N - 1)))
    return MixPlan(W=complete_W(N, dev),
                   c=torch.ones((), device=dev),
                   amp=torch.as_tensor(inv_gain, dtype=torch.float32,
                                       device=dev),
                   sigma_m=torch.tensor(mean_m_std, dtype=torch.float32,
                                        device=dev),
                   self_scale=0.0)


def plan_centralized(proto, chan, device="cuda", W=None) -> MixPlan:
    """The centralized parameter-server baseline: every worker transmits
    over the MAC to the server, which broadcasts the average — W = (1)/N
    (self included), eta = 1, no self-correction, one AWGN draw at the
    server shared by every receiver, scaled by 1/(cN)."""
    dev = resolve_device(device)
    N = chan.n_workers
    return MixPlan(W=torch.ones((N, N), device=dev) / N,
                   c=torch.tensor(chan.c, dtype=torch.float32, device=dev),
                   amp=mix_noise_amp(chan, dev),
                   sigma_m=torch.tensor(chan.awgn_sigma, dtype=torch.float32,
                                        device=dev),
                   self_scale=0.0, m_scale=1.0 / (chan.c * N))


# ---------------------------------------------------------------------------
# parameter trees (nested dicts and lists of tensors)
# ---------------------------------------------------------------------------


def tree_flatten(tree):
    """(leaves, structure) in jax's order: dict keys sorted."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([l for ls, _ in parts for l in ls],
                ("dict", keys, [s for _, s in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(t) for t in tree]
        return ([l for ls, _ in parts for l in ls],
                (type(tree).__name__, None, [s for _, s in parts]))
    return [tree], None


def _build(s, it):
    if s is None:
        return next(it)
    kind, keys, subs = s
    children = [_build(c, it) for c in subs]
    if kind == "dict":
        return dict(zip(keys, children))
    return children if kind == "list" else tuple(children)


def tree_unflatten(structure, leaves: List[Any]):
    """The tree of ``structure`` with ``leaves`` in order. (A recursive
    closure here would be a reference cycle holding the leaves until the
    cyclic collector runs: gigabytes of gradients on a large buffer.)"""
    return _build(structure, iter(leaves))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    leaves, structure = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(structure, [fn(*ls) for ls in zip(leaves, *others)])


class FlatSpec:
    """Flatten/unravel contract of the unsharded flat buffer.

    Built from a template tree (only shapes and dtypes are read) with
    ``lead_axes`` leading batch axes (1: worker-stacked [N, ...] leaves).
    ``flatten(X)`` -> [lead..., d] float32; ``unravel(flat)`` -> the
    worker-stacked tree as views of ``flat`` (autograd flows through
    them); ``unravel_row(v)`` -> one worker's tree from a [d] row.
    """

    def __init__(self, template, lead_axes: int = 1):
        leaves, self._structure = tree_flatten(template)
        self._shapes = [tuple(l.shape) for l in leaves]
        self._dtypes = [l.dtype for l in leaves]
        self._sizes = [int(np.prod(s[lead_axes:])) for s in self._shapes]
        self.lead_axes = int(lead_axes)
        self.d = int(sum(self._sizes))

    def flatten(self, X) -> torch.Tensor:
        """Each leaf's trailing (per-worker) axes raveled: a tree with the
        template's leading axes, or with any others in their place (the
        fleet's [R N] as one axis), -> [lead..., d] float32."""
        leaves, _ = tree_flatten(X)
        return torch.cat(
            [l.reshape(l.shape[:l.ndim - len(s) + self.lead_axes] + (-1,))
             .float() for l, s in zip(leaves, self._shapes)], dim=-1)

    def _split(self, flat, lead):
        out, off = [], 0
        for s, dt, n in zip(self._shapes, self._dtypes, self._sizes):
            out.append(flat[..., off:off + n]
                       .reshape(lead + s[self.lead_axes:]).to(dt))
            off += n
        return tree_unflatten(self._structure, out)

    def unravel(self, flat):
        return self._split(flat, tuple(flat.shape[:-1]))

    def unravel_row(self, v):
        return self._split(v, ())


def flatten_worker_tree(X) -> torch.Tensor:
    """FlatSpec(X).flatten(X): the worker-stacked tree as [N, d] float32."""
    return FlatSpec(X).flatten(X)


def worker_unravelers(template):
    """The (unravel, unravel_row) pair of FlatSpec(template)."""
    spec = FlatSpec(template)
    return spec.unravel, spec.unravel_row


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------


def draw_normals(X, generator: torch.Generator, *, shared_m: bool = False
                 ) -> dict:
    """The standard normals of one noisy exchange over the worker tree X:
    {"n": tree, "m": tree}, float32 on the generator's device, drawn in a
    fixed order — every leaf's n field in tree order, then every leaf's
    m field. With ``shared_m`` an m field is [1, ...], one draw that every
    receiver shares (the centralized server's AWGN)."""
    leaves, structure = tree_flatten(X)
    draw = lambda shape: torch.randn(shape, generator=generator,
                                     device=generator.device)
    n = [draw(tuple(x.shape)) for x in leaves]
    m = [draw((1,) + tuple(x.shape[1:]) if shared_m else tuple(x.shape))
         for x in leaves]
    return {"n": tree_unflatten(structure, n),
            "m": tree_unflatten(structure, m)}


def _col(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-worker [N] vector (the fleet's [R, N]) as [N, 1, ...] ([R,
    N, 1, ...]) against an ndim leaf."""
    return v.reshape(tuple(v.shape) + (1,) * (ndim - v.ndim))


def dp_noise(G, X, amp: torch.Tensor):
    """n_k = amp_k G_k per leaf, in the leaf's dtype: ``amp`` [N] is the
    per-worker DP-noise amplitude |h_k| sqrt(beta_k P_k) sigma
    (``mix_noise_amp``), G the standard normals (a tree like X)."""
    return tree_map(lambda g, x: (_col(amp, x.ndim) * g).to(x.dtype), G, X)


def channel_noise(G, X, sigma_m):
    """m_i = sigma_m G_i per receiver and entry, in the leaf's dtype
    (sigma_m a number, a 0-d tensor, or the fleet's [R])."""
    return tree_map(lambda g, x: (_vec(sigma_m, x.ndim) * g).to(x.dtype),
                    G, X)


# ---------------------------------------------------------------------------
# the primitive and the scheme runners
# ---------------------------------------------------------------------------


def _vec(v, ndim: int):
    """A per-receiver vector [N] (the fleet's [R, N], or [R] per
    replicate) as [N, 1, ...] against an ndim leaf; numbers and 0-d
    tensors pass through (they broadcast as they are)."""
    if v is None or not torch.is_tensor(v) or v.ndim == 0:
        return v
    return v.float().reshape(tuple(v.shape) + (1,) * (ndim - v.ndim))


def mix_exchange(X, noise_n, noise_m, c, eta: float, W, *, self_scale=None,
                 m_scale=None, listen=None):
    """One mixing-matrix exchange over worker-stacked leaves:

        x_i <- x_i + eta listen_i [ sum_k W_ik (x_k + n_k/c) + m_scale_i m_i
                                    - x_i - self_scale_i n_i/c ]

    ``self_scale``/``listen`` default to 1, ``m_scale`` to 1 (noise_m
    pre-scaled). All arithmetic is float32; leaves keep their dtype. A
    stack of R networks (the fleet) takes W [R, N, N], leaves [R, N,
    ...], c [R] and the vectors [R, N]: a batched product."""
    lead = tuple(W.shape[:-2])

    def one(x, n, m):
        xf = x.float()
        nf = n.float() / _vec(c, x.ndim)
        z = xf + nf
        if lead:
            mixed = torch.matmul(W.float(), z.reshape(
                lead + (z.shape[len(lead)], -1))).reshape(z.shape)
        else:
            mixed = torch.tensordot(W.float(), z, dims=1)
        selfs = _vec(self_scale, x.ndim)
        upd = mixed - xf - (nf if selfs is None else selfs * nf)
        if m is not None:
            mf = m.float()
            ms = _vec(m_scale, m.ndim)
            upd = upd + (mf if ms is None else ms * mf)
        li = _vec(listen, x.ndim)
        if li is not None:
            upd = li * upd
        return (xf + eta * upd).to(x.dtype)

    return tree_map(one, X, noise_n, noise_m)


def mix_exchange_sparse(X, noise_n, noise_m, c, eta: float, sw, *,
                        self_scale=None, m_scale=None, listen=None):
    """``mix_exchange`` through a neighbor list (``net.sparse.SparseW``):
    the [N, N] contraction becomes k row gathers of z = x + n/c,

        mix_i = self_w_i z_i + sum_s w_is z_{idx_is}      (slot order)

    O(N k) a leaf entry; the same update otherwise."""
    N = sw.n_workers

    def one(x, n, m):
        xf = x.float()
        nf = n.float() / c
        z = xf + nf
        col = lambda v: v.reshape((N,) + (1,) * (x.ndim - 1))
        mixed = col(sw.self_w.float()) * z
        for s in range(sw.k):
            mixed = mixed + col(sw.w[:, s]) * z[sw.idx[:, s].long()]
        selfs = _vec(self_scale, x.ndim)
        upd = mixed - xf - (nf if selfs is None else selfs * nf)
        if m is not None:
            mf = m.float()
            ms = _vec(m_scale, m.ndim)
            upd = upd + (mf if ms is None else ms * mf)
        li = _vec(listen, x.ndim)
        if li is not None:
            upd = li * upd
        return (xf + eta * upd).to(x.dtype)

    return tree_map(one, X, noise_n, noise_m)


def run_mix(X, noise_n, noise_m, eta: float, plan: MixPlan):
    """The exchange with a plan's W and vectors: ``mix_exchange`` for a
    dense W, ``mix_exchange_sparse`` for a neighbor list."""
    from repro_torch.net.sparse import SparseW
    mix = mix_exchange_sparse if isinstance(plan.W, SparseW) else mix_exchange
    return mix(X, noise_n, noise_m, plan.c, eta, plan.W,
               self_scale=plan.self_scale, m_scale=plan.m_scale,
               listen=plan.listen)


def run_orthogonal(X, G, plan: MixPlan, eta: float):
    """The orthogonal baseline (``plan_orthogonal``): each link carries ONE
    sender's signal, masked by that sender's own noise only, plus per-link
    AWGN, whose mean over the N - 1 links is drawn directly (statistically
    the same, without the [N, N, ...] tensor). G: {"n", "m"} normals."""
    n = tree_map(lambda g, x: _col(plan.amp, x.ndim) * g, G["n"], X)
    m = tree_map(lambda g: plan.sigma_m * g, G["m"])
    return mix_exchange(X, n, m, plan.c, eta, plan.W,
                        self_scale=plan.self_scale)


def run_centralized(X, noise_n, G_m, plan: MixPlan):
    """The centralized server baseline (``plan_centralized``): G_m holds
    one [1, ...] standard-normal field per leaf, the server's AWGN that
    every receiver hears."""
    m = tree_map(lambda g: plan.sigma_m * g, G_m)
    return mix_exchange(X, noise_n, m, plan.c, 1.0, plan.W,
                        self_scale=plan.self_scale, m_scale=plan.m_scale)


def _run_noisy(X, G, plan: MixPlan, proto):
    n = dp_noise(G["n"], X, plan.amp)
    m = channel_noise(G["m"], X, plan.sigma_m)
    return run_mix(X, n, m, proto.eta, plan)


def _run_gossip(X, G, plan: MixPlan, proto):
    zero = tree_map(torch.zeros_like, X)
    return run_mix(X, zero, zero, proto.eta, plan)


def _run_orthogonal_spec(X, G, plan: MixPlan, proto):
    return run_orthogonal(X, G, plan, proto.eta)


def _run_centralized_spec(X, G, plan: MixPlan, proto):
    return run_centralized(X, dp_noise(G["n"], X, plan.amp), G["m"], plan)


# ---------------------------------------------------------------------------
# ExchangeSpec and the routing table
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ExchangeSpec:
    """One exchange variant: ``plan(proto, chan, device, W=None)`` builds
    its MixPlan (W: the round's mixing matrix for "dynamic", its
    participation mask for "sampled", an override of the topology's W for
    "topology"), ``run(X, G, plan, proto)`` runs a round on the worker
    tree X with standard normals G (``draw_normals``; unused when the
    plan is not noisy). ``fuse_ok``: the pure mixing family, which treats
    every parameter entry alike, so the tree may be bucketed into one
    flat leaf and the fused dp_mix round may run it; the baselines keep
    their per-leaf noise layout. ``shared_m``: m is one [1, ...] draw per
    leaf, shared by every receiver."""
    name: str
    run: Callable
    plan: Callable
    fuse_ok: bool = True
    shared_m: bool = False


SPECS = {
    "complete": ExchangeSpec("complete", _run_noisy, plan_complete),
    "gossip": ExchangeSpec("gossip", _run_gossip, plan_gossip),
    "topology": ExchangeSpec("topology", _run_noisy, plan_topology),
    "dynamic": ExchangeSpec("dynamic", _run_noisy, plan_dynamic),
    "dynamic_sparse": ExchangeSpec("dynamic_sparse", _run_noisy,
                                   plan_dynamic_sparse),
    "sampled": ExchangeSpec("sampled", _run_noisy, plan_sampled),
    "orthogonal": ExchangeSpec("orthogonal", _run_orthogonal_spec,
                               plan_orthogonal, fuse_ok=False),
    "centralized": ExchangeSpec("centralized", _run_centralized_spec,
                                plan_centralized, fuse_ok=False,
                                shared_m=True),
}


def resolve_spec(proto, axis: Optional[str] = None,
                 dynamic: bool = False) -> ExchangeSpec:
    """Scheme -> ExchangeSpec: the one routing table of the static and the
    dynamic train steps, flat and worker-tree. Only dwfl has dynamic
    semantics (the baselines compare on the static channel). What the
    reference routes elsewhere raises, naming the ROADMAP item that ports
    it."""
    if axis is not None:
        raise NotImplementedError("the collective (shard_map) exchange is "
                                  "not ported yet (ROADMAP A14)")
    if dynamic:
        if proto.scheme != "dwfl":
            raise ValueError(f"dynamic channel model requires scheme='dwfl', "
                             f"got {proto.scheme!r}")
        # sparse_neighbors > 0: the round's W is a neighbor list, mixed
        # O(N k)
        if getattr(proto, "sparse_neighbors", 0):
            return SPECS["dynamic_sparse"]
        return SPECS["dynamic"]
    if proto.scheme in ("gossip", "orthogonal", "centralized"):
        return SPECS[proto.scheme]
    if proto.scheme == "dwfl":
        if proto.topology != "complete":
            return SPECS["topology"]
        if proto.participation < 1.0:
            return SPECS["sampled"]
        return SPECS["complete"]
    raise ValueError(proto.scheme)
