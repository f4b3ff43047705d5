"""Worker geometry: placement, log-distance path loss, random-waypoint
mobility and unit-disk interference graphs — the port of the reference's
``repro.net.geometry``. Everything that runs in a round is tensor math on
the device over [N] and [N, 2] state.

  * Path gain: g_k = g0 (max(d_k, d0)/d0)^(-n), d_k worker k's distance to
    the centroid (the paper's MAC has one scalar gain per worker, and the
    centroid stands for the plane every superposition crosses); it scales
    the fading amplitude as sqrt(g_k).
  * Interference graph: workers within ``comm_radius`` hear each other;
    Metropolis-Hastings weights make it a doubly-stochastic W.
  * Mobility: random waypoint, a fresh waypoint and speed on arrival.

  * Neighbor-list graph (``sparse_metropolis``): the mutual-kNN ∩
    unit-disk graph at a degree cap k, built in row blocks
    (``_block_topk``) so no [N, N] tensor is made, as a ``sparse.SparseW``.

The draws come from the caller's ``torch.Generator`` (the port's own,
checked in distribution).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.net.sparse import SparseW, top_k_stable


@dataclass(frozen=True)
class GeometryConfig:
    area: float = 1000.0          # side of the square region [m]
    placement: str = "uniform"    # uniform | cluster
    n_clusters: int = 4
    cluster_std: float = 60.0     # [m] spread around each cluster center
    pl_exponent: float = 0.0      # path-loss exponent n (0 = off)
    ref_distance: float = 1.0     # d0 [m]
    ref_gain_db: float = 0.0      # 10 log10 g0, the power gain at d0
    mobility: str = "static"      # static | waypoint
    speed_min: float = 0.0        # [m/round]
    speed_max: float = 0.0
    comm_radius: float = 0.0      # unit-disk radius [m]; 0 = complete graph
    normalize_gain: bool = True   # divide out the geometric-mean gain: the
                                  # absolute link budget is the protocol's
                                  # p_dbm; geometry gives the spread


@dataclass(frozen=True)
class GeometryState:
    pos: torch.Tensor        # [N, 2]
    waypoint: torch.Tensor   # [N, 2]
    speed: torch.Tensor      # [N] meters per round


def _uniform(generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def _draw_speed(cfg: GeometryConfig, generator, shape) -> torch.Tensor:
    return _uniform(generator, shape, cfg.speed_min,
                    max(cfg.speed_max, cfg.speed_min + 1e-9))


def init_geometry(cfg: GeometryConfig, generator: torch.Generator,
                  n_workers: int, lead: tuple = ()) -> GeometryState:
    """``lead``: leading axes of a stack of networks (the fleet's (R,))."""
    if cfg.placement == "cluster":
        centers = _uniform(generator, lead + (cfg.n_clusters, 2),
                           0.2 * cfg.area, 0.8 * cfg.area)
        assign = torch.randint(0, cfg.n_clusters, lead + (n_workers,),
                               generator=generator, device=generator.device)
        jitter = cfg.cluster_std * torch.randn(
            lead + (n_workers, 2), generator=generator,
            device=generator.device)
        home = torch.gather(centers, -2,
                            assign[..., None].expand(assign.shape + (2,)))
        pos = torch.clamp(home + jitter, 0.0, cfg.area)
    elif cfg.placement == "uniform":
        pos = _uniform(generator, lead + (n_workers, 2), 0.0, cfg.area)
    else:
        raise ValueError(cfg.placement)
    waypoint = _uniform(generator, lead + (n_workers, 2), 0.0, cfg.area)
    return GeometryState(pos=pos, waypoint=waypoint,
                         speed=_draw_speed(cfg, generator, lead + (n_workers,)))


def advance(cfg: GeometryConfig, generator: torch.Generator,
            state: GeometryState) -> GeometryState:
    """One round of random-waypoint motion (none when static)."""
    if cfg.mobility == "static" or cfg.speed_max <= 0.0:
        return state
    delta = state.waypoint - state.pos
    dist = torch.sqrt((delta * delta).sum(-1))
    arrive = dist <= state.speed                     # reaches it this round
    step = torch.where(dist[..., None] > 1e-9,
                       delta / torch.clamp_min(dist[..., None], 1e-9)
                       * state.speed[..., None], 0.0)
    pos = torch.where(arrive[..., None], state.waypoint, state.pos + step)
    new_way = _uniform(generator, tuple(state.waypoint.shape), 0.0, cfg.area)
    new_spd = _draw_speed(cfg, generator, tuple(state.speed.shape))
    return GeometryState(
        pos=pos, waypoint=torch.where(arrive[..., None], new_way,
                                      state.waypoint),
        speed=torch.where(arrive, new_spd, state.speed))


def path_gain(cfg: GeometryConfig, pos: torch.Tensor) -> torch.Tensor:
    """Each worker's linear power gain by log-distance path loss to the
    centroid, g0 (max(d, d0)/d0)^(-n); g0 everywhere when n = 0."""
    g0 = 10.0 ** (cfg.ref_gain_db / 10.0)
    if cfg.pl_exponent <= 0.0:
        return torch.full(pos.shape[:-1], g0, device=pos.device)
    off = pos - pos.mean(-2, keepdim=True)
    d = torch.clamp_min(torch.sqrt((off * off).sum(-1)), cfg.ref_distance)
    g = g0 * (d / cfg.ref_distance) ** (-cfg.pl_exponent)
    if cfg.normalize_gain:
        # geometric mean 1
        g = g / torch.exp(torch.log(g).mean(-1, keepdim=True))
    return g.to(torch.float32)


def adjacency(cfg: GeometryConfig, pos: torch.Tensor, mask=None,
              fallback: bool = False) -> torch.Tensor:
    """The unit-disk interference graph, float [..., N, N], symmetric,
    zero diagonal; comm_radius <= 0 is the complete graph. ``mask`` [...,
    N] takes churned-out workers out (they neither send nor listen).
    ``fallback`` bridges each radius-isolated active worker to its nearest
    active neighbor (both ways), so a sparse draw does not silently train
    identity rows. Leading axes are a stack of networks."""
    n = pos.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    if cfg.comm_radius <= 0.0:
        adj = torch.ones(pos.shape[:-2] + (n, n), device=pos.device)
        d2 = None
    else:
        d2 = ((pos[..., :, None, :] - pos[..., None, :, :]) ** 2).sum(-1)
        adj = (d2 <= cfg.comm_radius ** 2).to(torch.float32)
    adj = adj * (~eye).to(torch.float32)
    if mask is None:
        active = torch.ones(pos.shape[:-1], dtype=torch.bool,
                            device=pos.device)
    else:
        active = mask > 0
        p = active.to(torch.float32)
        adj = adj * p[..., :, None] * p[..., None, :]
    if fallback and d2 is not None:
        blocked = eye | ~active[..., None, :] | ~active[..., :, None]
        d2m = torch.where(blocked, torch.inf, d2)
        nearest = torch.argmin(d2m, dim=-1)
        need = (active & (adj.sum(-1) <= 0)
                & torch.isfinite(d2m.amin(-1)))
        cols = torch.arange(n, device=pos.device)
        fb = ((cols == nearest[..., :, None]) & need[..., :, None]
              ).to(torch.float32)
        adj = torch.maximum(adj, torch.maximum(fb, fb.transpose(-1, -2)))
    return adj


def metropolis_weights(adj: torch.Tensor) -> torch.Tensor:
    """The symmetric doubly-stochastic W of a graph by Metropolis-Hastings
    weights, W_ij = A_ij / (1 + max(deg_i, deg_j)), W_ii = 1 - sum_j W_ij;
    an isolated worker gets the identity row. Leading axes are a stack of
    graphs."""
    deg = (adj > 0).sum(-1).to(torch.float32)
    pair = 1.0 + torch.maximum(deg[..., :, None], deg[..., None, :])
    W = torch.where(adj > 0, adj / pair, 0.0)
    return W + torch.diag_embed(1.0 - W.sum(-1))


def _block_topk(pos: torch.Tensor, k: int, *, radius: float, mask=None,
                block: int = 0):
    """Each worker's k nearest neighbors (active, and within ``radius``
    when it is > 0), over row blocks so the largest transient is
    [block, N], never [N, N]. Returns (idx [N, k] int32, valid [N, k]
    bool); an invalid slot's index is arbitrary. Ties go to the lower
    index, as ``lax.top_k`` breaks them (``sparse.top_k_stable``)."""
    n = pos.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"degree cap k={k} must be in [1, N={n}]")
    r2 = radius ** 2 if radius > 0.0 else None
    active = None if mask is None else torch.as_tensor(mask) > 0
    cols = torch.arange(n, dtype=torch.int32, device=pos.device)

    def rows_topk(rows):                       # rows: [B] int32
        d2 = ((pos[rows][:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        bad = rows[:, None] == cols[None, :]
        if r2 is not None:
            bad = bad | (d2 > r2)
        if active is not None:
            bad = bad | ~active[None, :] | ~active[rows][:, None]
        vals, idx = top_k_stable(torch.where(bad, -torch.inf, -d2), k)
        return idx.to(torch.int32), torch.isfinite(vals)

    if block <= 0 or block >= n:
        return rows_topk(cols)
    # the reference's lax.map over blocks: the last block's rows past N - 1
    # are clipped to it, computed, and cut off
    step = torch.arange(block, dtype=torch.int32, device=pos.device)
    parts = [rows_topk(torch.clamp(s + step, 0, n - 1))
             for s in range(0, n, block)]
    return (torch.cat([p[0] for p in parts])[:n],
            torch.cat([p[1] for p in parts])[:n])


def sparse_metropolis(cfg: GeometryConfig, pos: torch.Tensor, k: int,
                      mask=None, *, fallback: bool = False,
                      block: int = 0) -> SparseW:
    """The capped neighbor-list W: the mutual-kNN ∩ unit-disk graph (an
    edge is kept iff each end ranks the other among its k nearest
    in-radius active neighbors: symmetric, degree <= k) with the dense
    path's Metropolis-Hastings weights. comm_radius <= 0 is the pure
    mutual-kNN graph; with k >= the largest disk degree it is the disk
    graph.

    ``fallback`` gives each active worker whose row came out empty one
    listen-only edge to its nearest active neighbor (ignoring the radius);
    the partner's list is not reopened, so that edge is one-way. ``block``
    bounds the distance transient to [block, N] rows. Tensor math on the
    device, no host round trip."""
    n = pos.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=pos.device)[:, None]
    idx, valid = _block_topk(pos, k, radius=cfg.comm_radius, mask=mask,
                             block=block)
    idx = torch.where(valid, idx, rows)
    li = idx.long()
    cand, vc = idx[li], valid[li]                       # [N, k, k]
    adj = valid & ((cand == rows[:, :, None]) & vc).any(-1)
    if fallback:
        nn_idx, nn_ok = _block_topk(pos, 1, radius=0.0, mask=mask,
                                    block=block)
        active = (torch.ones((n,), dtype=torch.bool, device=pos.device)
                  if mask is None else torch.as_tensor(mask) > 0)
        need = active & ~adj.any(-1) & nn_ok[:, 0]
        idx = torch.cat([torch.where(need, nn_idx[:, 0], idx[:, 0])[:, None],
                         idx[:, 1:]], dim=1)
        adj = torch.cat([(adj[:, 0] | need)[:, None], adj[:, 1:]], dim=1)
        li = idx.long()
    deg = adj.sum(-1).to(torch.float32)
    pair = 1.0 + torch.maximum(deg[:, None], deg[li])
    w = torch.where(adj, 1.0 / pair, 0.0).to(torch.float32)
    # 1 - sum w, slot by slot in slot order
    total = w[:, 0]
    for s in range(1, k):
        total = total + w[:, s]
    return SparseW(idx=torch.where(adj, idx, rows), w=w, self_w=1.0 - total)


def connectivity_fraction(adj) -> float:
    """The share of workers in the largest connected component (a host
    diagnostic)."""
    A = np.asarray(adj.cpu() if torch.is_tensor(adj) else adj) > 0
    n = A.shape[0]
    seen = np.zeros(n, bool)
    best = 0
    for s in range(n):
        if seen[s]:
            continue
        stack, comp = [s], 0
        seen[s] = True
        while stack:
            i = stack.pop()
            comp += 1
            for j in np.nonzero(A[i] & ~seen)[0]:
                seen[j] = True
                stack.append(j)
        best = max(best, comp)
    return best / n
