"""DWFL, Algorithm 1 — the exchanges of the reference's ``repro.core.dwfl``
over worker-stacked trees ([N, ...] leaves), each a named wrapper over the
mixing engine (``repro_torch.core.exchange``): the paper's complete graph,
the orthogonal and centralized baselines, a gossip topology, a round of
the dynamic network (dense W or neighbor list) and sampled participation;
the Eqt. (8) matrix-form oracle; and the per-worker collective forms, one
worker a rank of a ``torch.distributed`` process group: the superposition
as an ``all_reduce`` (``exchange_dwfl_collective``, the reference's
``psum``) and the orthogonal baseline's N - 1 ring steps
(``exchange_orthogonal_ring``, its ``ppermute``s).

Interpretation (the reference's, DESIGN.md): the self-correction term of
Eqt. (7) contains the receiver's own channel noise m_i, which a real
worker cannot know; worker i subtracts its own scaled DP noise n_i and m_i
stays in the received aggregate.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import exchange as engine
from repro_torch.core.channel import ChannelState


def _device(X):
    return engine.tree_flatten(X)[0][0].device


def exchange_dwfl(X, noise_n, noise_m, chan: ChannelState, eta: float):
    """One DWFL exchange (Alg. 1 lines 6-9), Eqt. (5)-(7): the complete-
    graph instance W = ((1) - I)/(N - 1) of the engine,

        x_i <- x_i + eta [ sum_{k != i} (x_k + n_k/c)/(N-1) + m_i/(c(N-1))
                           - x_i - n_i/c ]
    """
    return engine.run_mix(X, noise_n, noise_m, eta,
                          engine.plan_complete(None, chan, _device(X)))


def exchange_orthogonal(X, G, chan: ChannelState, eta: float):
    """The orthogonal (pairwise) baseline (exchange.run_orthogonal); G:
    the {"n", "m"} standard normals."""
    return engine.run_orthogonal(
        X, G, engine.plan_orthogonal(None, chan, _device(X)), eta)


def exchange_centralized(X, noise_n, G_m, chan: ChannelState):
    """The centralized server baseline (exchange.run_centralized); G_m:
    one [1, ...] standard-normal field per leaf."""
    return engine.run_centralized(
        X, noise_n, G_m, engine.plan_centralized(None, chan, _device(X)))


def exchange_dwfl_topology(X, noise_n, noise_m, chan: ChannelState,
                           eta: float, W):
    """DWFL over a doubly-stochastic gossip topology W (worker i's
    superposition covers its radio neighborhood; core.topology): the
    engine with ``plan_topology``'s W and m_scale = 1/(c deg). The complete
    graph gives ``exchange_dwfl``."""
    return engine.run_mix(X, noise_n, noise_m, eta,
                          engine.plan_topology(None, chan, _device(X), W=W))


def exchange_dwfl_dynamic(X, noise_n, noise_m, chan, eta: float, W):
    """DWFL over a round of the dynamic network: its channel (a
    ``net.TracedChannelState``) and W, dense [N, N] or a neighbor list
    (``net.sparse.SparseW``, mixed by row gathers). A worker with no active
    neighbor takes no update (the plan's listen = 0)."""
    from repro_torch.net.sparse import SparseW
    plan = (engine.plan_dynamic_sparse if isinstance(W, SparseW)
            else engine.plan_dynamic)
    return engine.run_mix(X, noise_n, noise_m, eta,
                          plan(None, chan, _device(X), W=W))


def exchange_dwfl_sampled(X, noise_n, noise_m, chan: ChannelState,
                          eta: float, participate):
    """DWFL under per-round participation (amplification by subsampling):
    ``participate`` bool [N] is the round's transmit set. A receiver
    averages the transmitters it hears, W_ik = p_k (1 - d_ik) /
    max(n_tx - p_i, 1); everyone mixes, and subtracts its own DP noise only
    in a round it sent (self_scale = p)."""
    W, p, denom = engine.sampled_W(participate.to(_device(X)))
    return engine.mix_exchange(X, noise_n, noise_m, chan.c, eta, W,
                               self_scale=p, m_scale=1.0 / (chan.c * denom))


def matrix_form_reference(X_flat, G_flat, noise_n_flat, noise_m_flat,
                          chan: ChannelState, gamma: float, eta: float,
                          W=None) -> np.ndarray:
    """Global-view update, Eqt. (8): X <- (X - gamma G) Psi + Phi (Psi - I),
    in float64 numpy. X_flat, G_flat, noise_*: [N, d]. Column k of
    receiver i's Phi is n_k/c + m_i/(deg_i c) for k != i and n_i/c for
    k = i. ``W`` (any doubly-stochastic [N, N]) defaults to the paper's
    complete graph; deg_i counts receiver i's positive W entries."""
    N = chan.n_workers
    c = chan.c
    Wmat = ((np.ones((N, N)) - np.eye(N)) / (N - 1) if W is None
            else np.asarray(W, np.float64))
    deg = np.maximum((Wmat > 0).sum(1), 1)
    Psi = (1 - eta) * np.eye(N) + eta * Wmat
    X1 = (np.asarray(X_flat, np.float64)
          - gamma * np.asarray(G_flat, np.float64))
    out = Psi @ X1
    n = np.asarray(noise_n_flat, np.float64)
    m = np.asarray(noise_m_flat, np.float64)
    res = np.zeros_like(out)
    for i in range(N):
        res[i] = out[i] + eta * ((Wmat[i] @ n) / c + m[i] / (deg[i] * c)
                                 - n[i] / c)
    return res


# ---------------------------------------------------------------------------
# one worker a rank: the collectives
# ---------------------------------------------------------------------------


def collective_mix(x_local, n_local, m_local, c, n_workers: int, eta: float,
                   group=None):
    """The complete-graph update of one worker from its own leaves: it
    transmits c x + n, the channel superposes every worker's transmission
    (an ``all_reduce`` over ``group``), the worker removes its own and
    hears the AWGN m:

        v  = sum_k (c x_k + n_k) - (c x + n) + m
        x <- x + (eta / c) (v / (N - 1) - c x - n)

    the reference's order; leaves keep their dtype."""
    import torch.distributed as dist

    def one(x, n, m):
        xf, nf = x.float(), n.float()
        tx = c * xf + nf
        rx = tx.clone()
        dist.all_reduce(rx, op=dist.ReduceOp.SUM, group=group)
        v = rx - tx + m.float()
        x_new = xf + (eta / c) * (v / (n_workers - 1) - c * xf - nf)
        return x_new.to(x.dtype)

    return engine.tree_map(one, x_local, n_local, m_local)


def exchange_dwfl_collective(x_local, n_local, m_local, chan: ChannelState,
                             eta: float, axis=None):
    """One DWFL exchange with one worker a rank of the process group
    ``axis`` (None: the default group): each rank holds its own leaves,
    its DP noise ``n_local`` and its AWGN ``m_local``; the superposition
    is an ``all_reduce``, the analogue of simultaneous analog
    transmission. Equal to ``exchange_dwfl`` on the stacked leaves up to
    the order of the sum."""
    return collective_mix(x_local, n_local, m_local, chan.c, chan.n_workers,
                          eta, axis)


def exchange_orthogonal_ring(x_local, chan: ChannelState, eta: float,
                             axis=None, generator=None):
    """The orthogonal baseline with one worker a rank: N - 1 ring steps,
    each passing one sender's parameters to the next rank, so every
    worker hears every other once, N - 1 times the link traffic of the
    one superposition (the paper's bandwidth argument). With
    ``generator`` each received copy carries the link's AWGN (std
    ``chan.awgn_sigma``), drawn in step order; without, none."""
    import torch.distributed as dist
    group = dist.group.WORLD if axis is None else axis
    N = chan.n_workers
    rank = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (rank + 1) % N)
    prv = dist.get_global_rank(group, (rank - 1) % N)

    def one(x):
        xf = x.float()
        acc = torch.zeros_like(xf)
        cur = xf.contiguous()
        for _ in range(N - 1):
            recv = torch.empty_like(cur)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, cur, nxt, group),
                    dist.P2POp(dist.irecv, recv, prv, group)]):
                req.wait()
            cur = recv
            if generator is not None:
                recv = recv + chan.awgn_sigma * torch.randn(
                    recv.shape, generator=generator, device=recv.device)
            acc = acc + recv
        return (xf + eta * (acc / (N - 1) - xf)).to(x.dtype)

    return engine.tree_map(one, x_local)
