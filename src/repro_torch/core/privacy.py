"""Differential privacy of the DWFL round (Sec. IV-A) — the reference's
``repro.core.privacy``: Theorem 4.1's per-receiver budget and Remark 4.1's
O(1/sqrt(N - 1)) bound on it, the orthogonal scheme's per-link budget,
the budget and sigma calibration on a gossip topology, the per-round
budgets of a time-varying channel (on the device, from a round's
``net.TracedChannelState`` and W), composition over T rounds, and the
per-worker gradient clip, and the fleet's replicated trajectories
(``epsilon_trajectory_batched``).
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from repro_torch.core import accounting
from repro_torch.core.channel import ChannelState
from repro_torch.core.exchange import tree_flatten, tree_unflatten
from repro_torch.utils import trace


# Composition saturates here: per-round budgets past ~700 overflow
# e^eps - 1 in float64, and a composed total at or beyond this value means
# the privacy is gone; it is quoted as exactly EPS_SATURATION, with a
# warning, not as inf.
EPS_SATURATION = 1e6
_EXPM1_MAX = 700.0


def gaussian_mechanism_sigma(sensitivity: float, epsilon: float,
                             delta: float) -> float:
    """The sigma of an (epsilon, delta)-DP Gaussian mechanism of
    sensitivity Delta: the classic sqrt(2 ln(1.25/delta)) Delta / epsilon
    for epsilon <= 1, the exact analytic calibration beyond, where the
    classic constant certifies nothing."""
    if epsilon <= 0:
        raise ValueError(f"epsilon must be > 0, got {epsilon}")
    if epsilon > accounting.CLASSIC_EPS_MAX:
        return accounting.analytic_gaussian_sigma(sensitivity, epsilon, delta)
    return math.sqrt(2.0 * math.log(1.25 / delta)) * sensitivity / epsilon


def l2_sensitivity(gamma: float, g_max: float, chan: ChannelState) -> float:
    """Changing one worker's data moves the aggregate by at most
    2 c gamma g_max."""
    return 2.0 * gamma * g_max * chan.c


def epsilon_dwfl(gamma: float, g_max: float, chan: ChannelState,
                 delta: float) -> np.ndarray:
    """Theorem 4.1, Eqt. (11): per-receiver budget epsilon_i."""
    num = 2.0 * gamma * g_max * chan.c
    den = chan.aggregate_noise_std
    return num / den * math.sqrt(2.0 * math.log(1.25 / delta))


def epsilon_dwfl_bound(gamma: float, g_max: float, chan: ChannelState,
                       delta: float) -> np.ndarray:
    """Remark 4.1 upper bound on epsilon_i: the explicit O(1/sqrt(N - 1))
    form, masking noise of the weakest other worker only."""
    N = chan.n_workers
    s2 = (chan.noise_scale ** 2) * chan.cfg.sigma ** 2
    min_others = np.array([np.delete(s2, i).min() for i in range(N)])
    num = 2.0 * gamma * g_max * chan.c
    den = np.sqrt(min_others * 1.0 + chan.cfg.sigma_m ** 2)
    return (num / den / math.sqrt(N - 1)
            * math.sqrt(2.0 * math.log(1.25 / delta)))


def epsilon_orthogonal(gamma: float, g_max: float, chan: ChannelState,
                       delta: float) -> np.ndarray:
    """Remark 4.1: per-link budget of the orthogonal (pairwise) scheme,
    masked by the sender's own noise only."""
    num = 2.0 * gamma * g_max * np.sqrt(chan.h ** 2 * chan.P)
    den = np.sqrt((chan.noise_scale ** 2) * chan.cfg.sigma ** 2 + chan.cfg.sigma_m ** 2)
    return num / den * math.sqrt(2.0 * math.log(1.25 / delta))


def sigma_for_epsilon(epsilon: float, gamma: float, g_max: float,
                      chan: ChannelState, delta: float) -> float:
    """The DP noise std sigma that makes the WORST receiver's budget
    equal epsilon (Eqt. 11 solved for sigma)."""
    agg_req = (2.0 * gamma * g_max * chan.c
               * accounting.noise_multiplier(epsilon, delta))
    s2 = chan.noise_scale ** 2
    min_sum = (s2.sum() - s2).min()
    need = agg_req ** 2 - chan.cfg.sigma_m ** 2
    if need <= 0:
        return 0.0  # channel noise alone already provides epsilon
    return math.sqrt(need / min_sum)


def sigma_for_epsilon_orthogonal(epsilon: float, gamma: float, g_max: float,
                                 chan: ChannelState, delta: float) -> float:
    """The sigma that makes the WORST per-link budget of the orthogonal
    scheme (Remark 4.1) equal epsilon: each link is masked by one sender's
    noise only, so the same epsilon needs far more noise than DWFL's."""
    nm2 = accounting.noise_multiplier(epsilon, delta) ** 2
    num2 = (2.0 * gamma * g_max) ** 2 * (chan.h ** 2 * chan.P) * nm2   # [N]
    s2 = chan.noise_scale ** 2                                         # [N]
    need = (num2 - chan.cfg.sigma_m ** 2) / s2
    worst = float(np.max(need))
    if worst <= 0:
        return 0.0  # per-link AWGN alone already provides epsilon
    return math.sqrt(worst)


def sigma_for_epsilon_topology(epsilon: float, gamma: float, g_max: float,
                               chan: ChannelState, delta: float, W) -> float:
    """The sigma that makes the worst receiver's budget on gossip topology
    W (``epsilon_dwfl_topology``) equal epsilon: receiver i is masked by
    its deg(i) neighbors' noises only, so a ring or torus needs more noise
    than the complete graph's calibration gives."""
    adj = (np.asarray(W) > 0).astype(float)
    np.fill_diagonal(adj, 0.0)
    mask_sum = adj @ chan.noise_scale ** 2
    listening = adj.sum(1) > 0
    if not listening.any():
        return 0.0                            # nobody receives anything
    agg_req = (2.0 * gamma * g_max * chan.c
               * accounting.noise_multiplier(epsilon, delta))
    need = agg_req ** 2 - chan.cfg.sigma_m ** 2
    if need <= 0:
        return 0.0
    return math.sqrt(need / float(mask_sum[listening].min()))


def epsilon_dwfl_topology(gamma: float, g_max: float, chan: ChannelState,
                          delta: float, W) -> np.ndarray:
    """Theorem 4.1 on gossip topology W: receiver i's aggregate is masked
    by its neighbors' noises only — O(1/sqrt(deg(i))), between the
    complete graph's 1/sqrt(N) and the orthogonal scheme's constant."""
    adj = (np.asarray(W) > 0).astype(float)
    s2 = (chan.noise_scale ** 2) * chan.cfg.sigma ** 2
    agg = np.sqrt(adj @ s2 + chan.cfg.sigma_m ** 2)
    num = 2.0 * gamma * g_max * chan.c
    return num / agg * math.sqrt(2.0 * math.log(1.25 / delta))


# ---------------------------------------------------------------------------
# per-round budgets of a time-varying channel, on the device
# ---------------------------------------------------------------------------


def _rx(v):
    """A per-round scalar ([] or [T]) against per-receiver [..., N]."""
    return v.unsqueeze(-1) if torch.is_tensor(v) else v


def _masking_sums(chan, W=None):
    """Per receiver, the DP-noise masking power sum_{k in N(i), k != i}
    s_k^2 (without sigma^2), and whether it listens. W None: the complete
    graph. With the round's dense W, a receiver is masked by its active
    off-diagonal neighbors only: churned-out workers have zero rows and
    columns, and a worker with no neighbor hears nothing. Leaves may carry
    a leading round axis ([T, N], W [T, N, N]). W may be a neighbor list
    (``net.sparse.SparseW``, [T, N, k] leaves when stacked): the sum then
    gathers each receiver's realized neighbors' s^2, O(N k)."""
    from repro_torch.net.sparse import SparseW
    s2 = chan.noise_scale ** 2
    if W is None:
        return s2.sum(-1, keepdim=True) - s2, torch.ones_like(s2, dtype=torch.bool)
    if isinstance(W, SparseW):
        rows = s2.unsqueeze(-2).expand(*W.idx.shape[:-1], s2.shape[-1])
        heard = torch.gather(rows, -1, W.idx.long())
        return ((W.valid().to(s2.dtype) * heard).sum(-1),
                W.off_degree() > 0)
    n = s2.shape[-1]
    adj = ((W > 0) & ~torch.eye(n, dtype=torch.bool, device=W.device)
           ).to(s2.dtype)
    return (adj @ s2.unsqueeze(-1)).squeeze(-1), adj.sum(-1) > 0


def epsilon_dwfl_traced(gamma: float, g_max: float, chan, delta: float,
                        W=None) -> torch.Tensor:
    """Theorem 4.1 on a round's traced channel, [N] on its device (or
    [T, N] for a stacked trajectory): with the round's W, each receiver
    is masked by the workers it hears; one that hears nobody has
    epsilon 0."""
    num = 2.0 * gamma * g_max * _rx(chan.c)
    mask_sum, listening = _masking_sums(chan, W)
    agg = torch.sqrt(mask_sum * _rx(chan.sigma) ** 2 + _rx(chan.sigma_m) ** 2)
    eps = num / agg * math.sqrt(2.0 * math.log(1.25 / delta))
    return torch.where(listening, eps, 0.0)


def sigma_for_epsilon_traced(epsilon: float, gamma: float, g_max: float,
                             chan, delta: float, W=None) -> torch.Tensor:
    """Eqt. (11) solved for sigma on the device for the worst listening
    receiver of a round (epsilon and delta host floats, so the guarded
    constant is computed on the host once). Under a dynamic channel this
    runs every round: sigma becomes the trajectory, epsilon stays at the
    target."""
    agg_req = (2.0 * gamma * g_max * chan.c
               * accounting.noise_multiplier(epsilon, delta))
    mask_sum, listening = _masking_sums(chan, W)
    min_sum = torch.where(listening, mask_sum, math.inf).amin(-1)
    min_sum = torch.where(torch.isfinite(min_sum), min_sum, 1.0)
    need = agg_req ** 2 - chan.sigma_m ** 2
    return torch.sqrt(torch.clamp_min(need, 0.0)
                      / torch.clamp_min(min_sum, 1e-30))


def epsilon_trajectory(gamma: float, g_max: float, chans, delta: float,
                       Ws=None) -> torch.Tensor:
    """Per-round, per-receiver budgets [T, N] over a stacked trajectory
    (``net.stack_states``; ``Ws`` the matching [T, N, N] mixing matrices
    or a SparseW of [T, N, k] leaves — pass them whenever the scenario has
    limited range or churn, or the complete-graph formula over-counts the
    masking noise). One batched evaluation, no loop over rounds."""
    return epsilon_dwfl_traced(gamma, g_max, chans, delta, Ws)


def epsilon_trajectory_batched(gamma: float, g_max: float, chans,
                               delta: float, Ws=None) -> torch.Tensor:
    """The fleet's form of ``epsilon_trajectory``: ``chans`` with [R, T,
    ...] leaves (R networks, e.g. ``fleet.FleetEngine.trajectory`` or
    ``trajectory.replicate_major`` of a fleet log) and ``Ws`` the matching
    [R, T, N, N] mixing matrices. Returns [R, T, N] in one evaluation over
    both leading axes, no loop over replicates."""
    return epsilon_dwfl_traced(gamma, g_max, chans, delta, Ws)


# ---------------------------------------------------------------------------
# composition over T rounds (host, float64)
# ---------------------------------------------------------------------------


def _saturate(eps, stacklevel: int):
    sat = ~np.isfinite(eps) | (eps >= EPS_SATURATION)
    if np.any(sat):
        warnings.warn(
            f"composed epsilon saturated at {EPS_SATURATION:g} "
            f"(per-round budget overflow — privacy is exhausted)",
            RuntimeWarning, stacklevel=stacklevel + 1)
        eps = np.where(sat, EPS_SATURATION, eps)
    return eps


def compose_heterogeneous(eps_rounds, delta_round: float,
                          delta_prime: float = 1e-6):
    """Advanced composition of per-round-varying budgets (Dwork-Roth Thm
    3.20, heterogeneous form): eps = sqrt(2 ln(1/delta') sum eps_t^2)
    + sum eps_t (e^eps_t - 1), delta = T delta + delta'."""
    eps, delta = compose_heterogeneous_batched(
        np.asarray(eps_rounds, np.float64).reshape(-1), delta_round,
        delta_prime)
    return float(eps), float(delta)


def compose_heterogeneous_batched(eps_rounds, delta_round: float,
                                  delta_prime: float = 1e-6):
    """compose_heterogeneous along the last axis of [..., T]; a total at or
    past EPS_SATURATION is quoted as EPS_SATURATION, with a warning."""
    e = np.asarray(eps_rounds, np.float64)
    T = e.shape[-1]
    with np.errstate(over="ignore"):
        lin = np.sum(e * np.expm1(np.minimum(e, _EXPM1_MAX)), axis=-1)
        eps = (np.sqrt(2.0 * math.log(1.0 / delta_prime)
                       * np.sum(e ** 2, axis=-1)) + lin)
    eps = _saturate(eps, 2)
    delta = np.broadcast_to(
        np.float64(T * delta_round + delta_prime), eps.shape).copy()
    return eps, delta


def compose_from_moments(moments, delta_round: float,
                         delta_prime: float = 1e-6,
                         accountant: str = "composition", orders=None):
    """The trajectory budget from the moment accumulator [..., 4] =
    [sum eps, sum eps^2, sum eps (e^eps - 1), T], or [..., 4 + A] with the
    per-order RDP ledger appended. "composition": advanced composition,
    delta = T delta_round + delta'; "rdp": the CKS conversion of the
    ledger at that same delta (needs the wide layout); "min": the smaller
    of the two. Returns (eps [...], delta [...])."""
    m = np.asarray(moments, np.float64)
    a = len(accounting.ORDER_GRID if orders is None else orders)
    if m.shape[-1] not in (4, 4 + a):
        raise ValueError(f"moments last axis must be 4 "
                         f"[sum eps, sum eps^2, sum eps(e^eps-1), T] or "
                         f"{4 + a} (with the [{a}] RDP-order ledger), got "
                         f"shape {m.shape}")
    delta = m[..., 3] * delta_round + delta_prime

    def _composition():
        return _saturate(np.sqrt(2.0 * math.log(1.0 / delta_prime)
                                 * m[..., 1]) + m[..., 2], 3)

    def _rdp():
        if m.shape[-1] == 4:
            raise ValueError("accountant='rdp' needs the [..., 4+A] moment "
                             "layout")
        eps, _ = accounting.rdp_to_epsilon(m[..., 4:], delta, orders)
        return np.asarray(eps, np.float64)

    if accountant == "composition":
        eps = _composition()
    elif accountant == "rdp":
        eps = _rdp()
    elif accountant == "min":
        eps = np.minimum(_composition(), _rdp())
    else:
        raise ValueError(f"accountant must be 'composition', 'rdp' or "
                         f"'min', got {accountant!r}")
    if eps.ndim == 0:
        return float(eps), float(delta)
    return eps, delta


def epsilon_sampled(eps_round: float, delta_round: float, q: float):
    """Amplification by worker subsampling at rate q:
    eps' = ln(1 + q (e^eps - 1)), delta' = q delta."""
    return (math.log1p(q * math.expm1(min(eps_round, _EXPM1_MAX))),
            q * delta_round)


def compose_naive(eps_round: float, delta_round: float, T: int):
    return T * eps_round, T * delta_round


def compose_advanced(eps_round: float, delta_round: float, T: int,
                     delta_prime: float = 1e-6):
    """Dwork-Roth advanced composition (Thm 3.20), saturating at
    EPS_SATURATION with a warning instead of overflowing to inf."""
    eps = (math.sqrt(2.0 * T * math.log(1.0 / delta_prime)) * eps_round
           + T * eps_round * math.expm1(min(eps_round, _EXPM1_MAX)))
    if not math.isfinite(eps) or eps >= EPS_SATURATION:
        warnings.warn(
            f"composed epsilon saturated at {EPS_SATURATION:g} "
            f"(per-round budget overflow — privacy is exhausted)",
            RuntimeWarning, stacklevel=2)
        eps = EPS_SATURATION
    return eps, T * delta_round + delta_prime


# row_sum_squares's stages on the card: K columns, then the rows' M1
# blocks of K, then their M2 partial sums
_SUMSQ_K, _SUMSQ_M2 = 1024, 32


def row_sum_squares(x: torch.Tensor) -> torch.Tensor:
    """[R, n] -> [R]: each row's sum of squares in float32, each row's
    value the same bits whatever R.

    On the card a single reduction over n picks its block shape, and so
    its summation order, from the number of rows R below 16: a row block
    of 5 workers would round a worker's norm unlike the 10 of the whole
    population (the model axis on a mesh against the logical mode). So
    the squares are summed in three reductions, each wide enough (K
    columns, then M1 blocks, with at least 32 R outputs) or short enough
    (the last, M2 = 32 partial sums) that PyTorch's block shape does not
    follow R; the squares of the tail past n are zeros. On the CPU a
    row's order does not depend on R: one reduction.

    The meta device takes the card's ops. On the CPU an open recorder
    (``utils.trace``) counts the card's ops too, replayed on a meta copy
    of x, and not the CPU's own: a round then counts what the card
    issues on every device."""
    R = x.shape[0]
    x = x.reshape(R, -1)
    if x.device.type != "cpu":
        return _staged_row_sum_squares(x)
    if trace.active() is not None:
        with trace.uncounted():
            xm = torch.empty(x.shape, dtype=x.dtype, device="meta")
        _staged_row_sum_squares(xm)
    with trace.uncounted():
        return torch.sum(x.float() ** 2, dim=1)


def _staged_row_sum_squares(x: torch.Tensor) -> torch.Tensor:
    """row_sum_squares's three reductions of the card, over [R, n] x."""
    R, n = x.shape
    m1 = max(1, -(-n // (_SUMSQ_K * _SUMSQ_M2)))
    sq = torch.empty((R, _SUMSQ_M2 * m1 * _SUMSQ_K), device=x.device)
    torch.square(x.float(), out=sq[:, :n])
    sq[:, n:].fill_(0)      # one op on every device (``= 0`` is not)
    s = sq.view(R, _SUMSQ_M2 * m1, _SUMSQ_K).sum(-1)
    return s.view(R, _SUMSQ_M2, m1).sum(-1).sum(-1)


def clip_gradient_tree(grads, g_max: float):
    """L2-clip each worker's gradient to norm <= g_max. ``grads`` is the
    flat [N, d] buffer or a worker-stacked tree of [N, ...] leaves; a
    worker's norm runs over all its leaves. A worker whose norm is not
    finite (an overflowed backward pass) gets a zero gradient, and so does
    any non-finite entry. Returns (clipped, norms [N]) with ``clipped`` in
    the form and dtypes of ``grads``, the norm 0 where it was not
    finite."""
    leaves, structure = tree_flatten(grads)
    norm = torch.sqrt(sum(row_sum_squares(g) for g in leaves))
    finite = torch.isfinite(norm)
    scale = torch.where(finite,
                        torch.clamp_max(g_max / torch.clamp_min(norm, 1e-12), 1.0),
                        torch.zeros_like(norm))

    def one(g):
        col = (g.shape[0],) + (1,) * (g.ndim - 1)
        keep = finite.reshape(col) & torch.isfinite(g)
        return torch.where(keep, g * scale.reshape(col), 0.0).to(g.dtype)

    return (tree_unflatten(structure, [one(g) for g in leaves]),
            torch.where(finite, norm, torch.zeros_like(norm)))
