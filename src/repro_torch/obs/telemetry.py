"""Per-round telemetry — the on-device half of ``repro_torch.obs``, the
port of the reference's ``repro.obs.telemetry``.

``TelemetrySpec`` selects per-round scalars that the trajectory computes
on the device and hands back as one stacked ``[K, M]`` tensor a chunk
(the fleet: ``[K, R, M]``), read by the host once at the chunk's end:

    loss, grad_norm    the round metrics the step already computes
    consensus          RMS distance of the workers' parameters from their
                       mean, on the parameters ENTERING the round
    snr_db             realized receiver SNR of the aligned aggregate
                       (mean over listening receivers, dB)
    deep_fade          share of workers whose |h|^2 is below
                       ``deep_fade_rel_db`` of the round's median |h|^2
    participation      share of workers that hear at least one neighbor
    epsilon            the worst receiver's per-round epsilon (Theorem 4.1
                       on the round's realized channel and neighborhoods)

With ``epsilon`` on, the carry accumulates the accountant moments
``[sum eps, sum eps^2, sum eps (e^eps - 1), T, sum eps(alpha_1..A)]``
(``init_eps_moments``, ``accumulate_eps``), which
``core.privacy.compose_from_moments`` turns into the trajectory's budget
under either accountant.

Telemetry draws nothing from the generator and writes no parameter: a
trajectory with it on is bitwise the trajectory with it off. Every
function takes leaves with leading axes (a chunk's rounds, the fleet's
replicates) and reduces over the trailing worker axis only. On a
process-group mesh (``shard``) only the consensus needs the other ranks:
``consensus_distance`` sums their partial sums; every rank draws the same
network, so the channel columns and epsilon are its own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import accounting
from repro_torch.runtime import resolve_device

# ordered catalogue: (name, needs_channel) — the column layout is the
# subsequence of enabled names in THIS order
_CATALOGUE: Tuple[Tuple[str, bool], ...] = (
    ("loss", False),
    ("grad_norm", False),
    ("consensus", False),
    ("snr_db", True),
    ("deep_fade", True),
    ("participation", True),
    ("epsilon", True),
)


@dataclass(frozen=True)
class TelemetrySpec:
    """A selection of per-round telemetry scalars (frozen, hashable).

    ``deep_fade_rel_db``: a worker is in a deep fade when its power gain
    |h|^2 is below this many dB of the round's median |h|^2."""
    loss: bool = True
    grad_norm: bool = True
    consensus: bool = True
    snr_db: bool = True
    deep_fade: bool = True
    participation: bool = True
    epsilon: bool = True
    deep_fade_rel_db: float = -20.0

    @property
    def fields(self) -> Tuple[str, ...]:
        """Ordered names of the enabled scalars: the columns of the
        [K, M] telemetry tensor."""
        return tuple(n for n, _ in _CATALOGUE if getattr(self, n))

    @property
    def n_fields(self) -> int:
        return len(self.fields)

    def unpack(self, arr) -> Dict[str, torch.Tensor]:
        """[..., M] telemetry tensor -> {name: [...] column}."""
        names = self.fields
        if arr.shape[-1] != len(names):
            raise ValueError(f"telemetry array has {arr.shape[-1]} columns "
                             f"for {len(names)} enabled fields {names}")
        return {n: arr[..., i] for i, n in enumerate(names)}

    def pack(self, values: Dict[str, torch.Tensor]) -> torch.Tensor:
        """{name: scalar-or-[R]} -> [M] (or [R, M]) tensor, field order."""
        cols = [torch.as_tensor(values[n], dtype=torch.float32)
                for n in self.fields]
        return torch.stack(cols, dim=-1)


def consensus_distance(params, worker_axis: int = 0, *, model_group=None,
                       worker_group=None) -> torch.Tensor:
    """RMS consensus distance sqrt(mean_n ||x_n - xbar||^2) over the worker
    axis of every leaf (worker_axis=0: [W, ...] leaves, a scalar;
    worker_axis=1: the fleet's [R, W, ...] leaves, [R]). A tree of leaves
    or the flat buffer (one leaf) alike.

    By the shifted-data identity with worker 0's row as the shift r,

        mean_n ||x_n - xbar||^2 = mean_n ||x_n - r||^2 - ||xbar - r||^2,

    one subtracting pass. The shift lies inside the worker cloud, so near
    consensus the two terms do not cancel catastrophically, as the r = 0
    sum-of-squares form would.

    On a process-group mesh each rank holds part of the buffer, and the
    result is a sum of the ranks' partial sums, as ``param_norm`` is:

    * ``model_group`` (the "model" axis): this rank's column window of
      every worker. Its partial n ||.||^2 by the identity above, then one
      ``all_reduce`` (sum) over the group, then the root. A layout's zero
      padding columns add 0.
    * ``worker_group`` (the "workers" axis): this rank's rows, the group's
      ranks in row order. r is worker 0's row, on the group's rank 0: one
      ``broadcast`` of r, then one ``all_reduce`` of [sum_n (x_n - r),
      sum_n ||x_n - r||^2], d + 1 floats (2 x 3.4 MB a round at d =
      855,050).

    On one rank the collectives leave every value as it is, so the result
    is bitwise the unsharded call's. None of them waits for the host."""
    import torch.distributed as dist
    from repro_torch.core.exchange import tree_flatten
    leaves, _ = tree_flatten(params)
    sq = None
    n_workers = None
    for x in leaves:
        x = x.float()
        n_workers = x.shape[worker_axis]
        shift = x.narrow(worker_axis, 0, 1)
        if worker_group is not None:
            n_workers *= dist.get_world_size(worker_group)
            shift = shift.clone()          # a view of the rank's rows
            dist.broadcast(shift, src=dist.get_global_rank(worker_group, 0),
                           group=worker_group)
        y = x - shift
        red = tuple(range(worker_axis, x.ndim))
        s1 = torch.sum(y * y, dim=red)
        col = torch.sum(y, dim=worker_axis)
        if worker_group is not None:
            both = torch.cat([col.reshape(-1), s1.reshape(-1)])
            dist.all_reduce(both, group=worker_group)
            col = both[:col.numel()].reshape(col.shape)
            s1 = both[col.numel():].reshape(s1.shape)
        v = col / n_workers
        d2 = (s1 * (1.0 / n_workers) - torch.sum(v * v, dim=red[:-1])) \
            * n_workers
        sq = d2 if sq is None else sq + d2
    if model_group is not None:
        dist.all_reduce(sq, group=model_group)
    return torch.sqrt(torch.clamp_min(sq, 0.0) * (1.0 / n_workers))


def _degree_and_neighbor_sum(W, n: int, v):
    """(off-degree [..., N] float32, sum_{k in N(i)} v_k [..., N]) of a
    round's mixing matrix: dense, None (the complete graph), or a
    ``net.sparse.SparseW``, read O(N k) without an [N, N] tensor."""
    from repro_torch.net.sparse import SparseW
    if isinstance(W, SparseW):
        rows = v.unsqueeze(-2).expand(*W.idx.shape[:-1], v.shape[-1])
        heard = torch.gather(rows, -1, W.idx.long())
        valid = W.valid().to(torch.float32)
        return W.off_degree(), (valid * heard).sum(-1)
    eye = torch.eye(n, dtype=torch.bool, device=v.device)
    if W is None:
        adj = (~eye).to(torch.float32).expand(v.shape[:-1] + (n, n))
    else:
        adj = ((W > 0) & ~eye).to(torch.float32)
    return adj.sum(-1), (adj @ v.unsqueeze(-1)).squeeze(-1)


def _median(x: torch.Tensor) -> torch.Tensor:
    """The median over the last axis as ``jnp.median`` takes it: the
    midpoint (lo + hi) * 0.5 of the two middle values of the sort (one
    value twice at odd length). ``torch.median`` returns the lower one."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def _share(flags: torch.Tensor) -> torch.Tensor:
    """The share of true flags over the last axis, as XLA's mean takes it:
    the sum times 1/n in float32 (5/6 is 0.83333337 this way, not the
    correctly rounded 0.8333333)."""
    return flags.float().sum(-1) * (1.0 / flags.shape[-1])


def channel_scalars(spec: TelemetrySpec, chan, W=None
                    ) -> Dict[str, torch.Tensor]:
    """The channel-derived telemetry scalars of a round — or of stacked
    rounds: ``chan`` (a ``net.TracedChannelState``, or a static one as
    tensors) with leaves [..., N], ``W`` its [..., N, N] mixing matrix
    (None: the complete graph; a SparseW read O(N k)). Returns the scalars
    ``spec`` enables, each [...], ``epsilon`` excluded (``epsilon_round``)."""
    out: Dict[str, torch.Tensor] = {}
    n = chan.n_workers
    s2 = chan.noise_scale.float() ** 2
    if spec.snr_db or spec.participation:
        n_i, mask_sum = _degree_and_neighbor_sum(
            W, n, s2 * chan.sigma.unsqueeze(-1) ** 2)
        listening = n_i > 0
    if spec.deep_fade:
        h2 = chan.h.float() ** 2
        floor = 10.0 ** (spec.deep_fade_rel_db / 10.0) * _median(h2)
        out["deep_fade"] = _share(h2 < floor.unsqueeze(-1))
    if spec.participation:
        out["participation"] = _share(listening)
    if spec.snr_db:
        # the aligned aggregate at receiver i: n_i neighbors, each of
        # amplitude c, masked by their DP noise and the receiver's AWGN
        sig = (n_i * chan.c.unsqueeze(-1)) ** 2
        noise = mask_sum + chan.sigma_m.unsqueeze(-1) ** 2
        snr = torch.where(listening, sig / noise, torch.nan)
        out["snr_db"] = 10.0 * torch.log10(torch.nanmean(snr, dim=-1)
                                           + 1e-30)
    return out


def epsilon_round(proto, chan, W=None) -> torch.Tensor:
    """The worst receiver's per-round epsilon on the round's realized
    channel and neighborhoods (Theorem 4.1), [...] over leading axes."""
    from repro_torch.core import privacy
    return privacy.epsilon_dwfl_traced(proto.gamma, proto.clip, chan,
                                       proto.delta, W).amax(-1)


def rdp_round(proto, chan, W=None, orders=None) -> torch.Tensor:
    """The worst receiver's per-round RDP vector [..., A] on the
    accounting order grid — the Renyi companion of ``epsilon_round``
    (``orders``: the grid on the channel's device, made once)."""
    return accounting.rdp_dwfl_traced(proto.gamma, proto.clip, chan, W,
                                      orders)


def init_eps_moments(replicates: Optional[int] = None,
                     n_orders: Optional[int] = None,
                     device="cuda") -> torch.Tensor:
    """Zeroed accountant accumulator: [sum eps, sum eps^2, sum eps (e^eps
    - 1), T | sum eps(alpha_1..A)], [4 + A] float32, or [R, 4 + A] for the
    fleet, on ``device``. ``n_orders`` defaults to the accounting order
    grid; 0 gives the composition-only [4]."""
    a = accounting.N_ORDERS if n_orders is None else int(n_orders)
    shape = (4 + a,) if replicates is None else (int(replicates), 4 + a)
    return torch.zeros(shape, dtype=torch.float32,
                       device=resolve_device(device))


def _moment_update(eps: torch.Tensor) -> torch.Tensor:
    e = eps.float()
    return torch.stack([e, e ** 2, e * torch.expm1(e), torch.ones_like(e)],
                       dim=-1)


def accumulate_eps(acc: torch.Tensor, eps, rdp=None) -> torch.Tensor:
    """One round's accountant update (eps a scalar or [R]; acc [4+A] or
    [R, 4+A]). ``rdp``, the round's per-order RDP vector ([A] or [R, A],
    ``rdp_round``), is required exactly when the accumulator carries the
    RDP ledger."""
    upd = _moment_update(torch.as_tensor(eps, device=acc.device))
    if acc.shape[-1] == 4:
        if rdp is not None:
            raise ValueError("rdp update passed to a legacy [4] "
                             "accumulator — widen it with "
                             "init_eps_moments()")
        return acc + upd
    if rdp is None:
        raise ValueError(f"accumulator shape {tuple(acc.shape)} carries an "
                         f"RDP ledger; pass rdp= (see rdp_round)")
    return acc + torch.cat([upd, torch.as_tensor(rdp, dtype=torch.float32,
                                                 device=acc.device)], dim=-1)
