"""The fused DWFL round in plain PyTorch: ``dp_mix_plain``, the twin of
the reference's ``dp_mix_fused_jnp`` (repro/kernels/dp_mix/dp_mix.py) with
the ``_round_math`` arithmetic (``dp_mix_plain_stack`` for a stack of
rounds, the twin of the kernel's replicate axis), and
``dp_mix_sparse_plain``, the twin of its ``dp_mix_sparse_jnp``
(``_sparse_round_math``: the mix through a padded neighbor list), in its
two halves ``dp_mix_prep_plain`` and ``dp_mix_gather_plain`` (and
``dp_mix_sparse_plain_stack`` for a stack of rounds), which a
worker shard runs on its rows (the reference's
``shard.worker.worker_window_round``).

They are what ``ops.dp_mix_round`` and ``ops.dp_mix_round_sparse`` run for
a tensor on the CPU, and what the CUDA kernels (``csrc/dp_mix.cu``) are
held against on the card. The noise is the counter-hash stream of
``repro_torch.kernels.noise``, so both draw the reference's normals from
the same seed, and the same fields as each other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import noise


def dp_mix_plain(p, g, seed, col0, scal, amp, selfs, mscale, listen, W, *,
                 gamma: float, eta: float, noisy: bool,
                 counter_width: int) -> torch.Tensor:
    """p, g: [N, D] (any float dtype); seed, col0: int32 [1]; scal = [c,
    sigma_m]; amp, selfs, mscale, listen: [N] float32; W: [N, N] float32.
    Noise counters use ``counter_width`` as the row stride and ``col0`` as
    the window's global column offset. Computes in float32 and returns
    the input dtype. The noisy branch is the reference's one block product

        [W | W - diag(self) | diag(m_scale * sigma_m)] @ [x; n/c; Gm]
    """
    N, D = p.shape
    x = p.float() - gamma * g.float()
    col = lambda v: v.reshape(N, 1)
    if noisy:
        g_n, g_m = noise.normal_pair_hash(
            (N, D), counter_width, col0.reshape(-1)[0], seed.reshape(-1)[0],
            device=p.device)
        c, sigma_m = scal[0], scal[1]
        nf = (col(amp) / c) * g_n
        eye = torch.eye(N, dtype=torch.float32, device=p.device)
        blocks = torch.cat([W, W - eye * col(selfs),
                            eye * (col(mscale) * sigma_m)], dim=1)
        upd = blocks @ torch.cat([x, nf, g_m], dim=0)
    else:
        upd = W @ x
    return (x + eta * col(listen) * (upd - x)).to(p.dtype)


def dp_mix_plain_stack(p, g, seed, col0, scal, amp, selfs, mscale, listen, W,
                       **kw) -> torch.Tensor:
    """The plain version of a stack of R rounds (the fleet's): ``dp_mix_plain``
    on each replicate's operands (p, g [R, N, D], seed [R], scal [R, 2],
    the vectors [R, N], W [R, N, N]; col0 shared)."""
    return torch.stack([
        dp_mix_plain(p[r], g[r], seed[r:r + 1], col0, scal[r], amp[r],
                     selfs[r], mscale[r], listen[r], W[r], **kw)
        for r in range(p.shape[0])])


def dp_mix_prep_plain(p, g, seed, col0, scal, amp, *, gamma: float,
                      noisy: bool, counter_width: int, row0=0) -> torch.Tensor:
    """The first half of the sparse round over rows [row0, row0 + Nb) of a
    population: the float32 workspace [2, Nb, D], z = x + n/c and n/c,
    the noise drawn with global counters (``noise.normal_field``, field
    0); gossip: x, and zeros."""
    N, D = p.shape
    x = p.float() - gamma * g.float()
    if not noisy:
        return torch.stack([x, torch.zeros_like(x)])
    g_n = noise.normal_field((N, D), counter_width, col0.reshape(-1)[0],
                             seed.reshape(-1)[0], 0, row0=row0,
                             device=p.device)
    nf = (amp.reshape(N, 1) / scal[0]) * g_n
    return torch.stack([x + nf, nf])


def dp_mix_gather_plain(p, g, ws, z_src, seed, col0, scal, amp, selfs,
                        mscale, listen, idx, w, self_w, *, gamma: float,
                        eta: float, noisy: bool, counter_width: int,
                        row0=0) -> torch.Tensor:
    """The second half: receivers [row0, row0 + Nb) from their workspace
    ``ws`` (``dp_mix_prep_plain``) and z_src [N_src, D], the rows the
    neighbor list idx [Nb, k] reads (global indices). Gm is field 1 of
    the global counters. The reference's order:

        mix = self_w z + sum_s w[:, s] z_src[idx[:, s]]      (slot order)
        out = x + eta listen (mix + m_scale sigma_m Gm - x - self n/c)
    """
    N, D = p.shape
    x = p.float() - gamma * g.float()
    col = lambda v: v.reshape(N, 1)
    rows = idx.long()
    mix = col(self_w) * ws[0]
    for s in range(idx.shape[1]):
        mix = mix + w[:, s:s + 1] * z_src[rows[:, s]]
    if noisy:
        g_m = noise.normal_field((N, D), counter_width, col0.reshape(-1)[0],
                                 seed.reshape(-1)[0], 1, row0=row0,
                                 device=p.device)
        nf = ws[1]
        upd = mix + (col(mscale) * scal[1]) * g_m - col(selfs) * nf
    else:
        upd = mix
    return (x + eta * col(listen) * (upd - x)).to(p.dtype)


def dp_mix_sparse_plain(p, g, seed, col0, scal, amp, selfs, mscale, listen,
                        idx, w, self_w, *, gamma: float, eta: float,
                        noisy: bool, counter_width: int,
                        row0=0) -> torch.Tensor:
    """``dp_mix_plain`` with the mix through a padded neighbor list: idx,
    w [N, k] (int32, float32), self_w [N] float32; the other operands as
    there. z = x + n/c is made once, then

        mix = self_w z + sum_s w[:, s] z[idx[:, s]]      (slot order)
        out = x + eta listen (mix + m_scale sigma_m Gm - x - self n/c)

    the reference's order. Gossip mixes x. ``row0`` offsets the noise
    counters' rows (the reference's ``dp_mix_sparse_jnp(row0=)``). It is
    its two halves, ``dp_mix_prep_plain`` then ``dp_mix_gather_plain``
    with the workspace's own z, as the card runs it."""
    ws = dp_mix_prep_plain(p, g, seed, col0, scal, amp, gamma=gamma,
                           noisy=noisy, counter_width=counter_width,
                           row0=row0)
    return dp_mix_gather_plain(p, g, ws, ws[0], seed, col0, scal, amp, selfs,
                               mscale, listen, idx, w, self_w, gamma=gamma,
                               eta=eta, noisy=noisy,
                               counter_width=counter_width, row0=row0)


def dp_mix_sparse_plain_stack(p, g, seed, col0, scal, amp, selfs, mscale,
                              listen, idx, w, self_w, **kw) -> torch.Tensor:
    """The plain version of a stack of R sparse rounds (the fleet's):
    ``dp_mix_sparse_plain`` on each replicate's operands (p, g [R, N, D],
    seed [R], scal [R, 2], the vectors and self_w [R, N], idx, w [R, N, k];
    col0 shared)."""
    return torch.stack([
        dp_mix_sparse_plain(p[r], g[r], seed[r:r + 1], col0, scal[r],
                            amp[r], selfs[r], mscale[r], listen[r], idx[r],
                            w[r], self_w[r], **kw)
        for r in range(p.shape[0])])
