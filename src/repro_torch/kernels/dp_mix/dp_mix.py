"""The fused DWFL round in plain PyTorch: ``dp_mix_plain``, the twin of
the reference's ``dp_mix_fused_jnp`` (repro/kernels/dp_mix/dp_mix.py) with
the ``_round_math`` arithmetic, and ``dp_mix_sparse_plain``, the twin of
its ``dp_mix_sparse_jnp`` (``_sparse_round_math``: the mix through a
padded neighbor list).

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


def dp_mix_sparse_plain(p, g, seed, col0, scal, amp, selfs, mscale, listen,
                        idx, w, self_w, *, gamma: float, eta: float,
                        noisy: bool, counter_width: int) -> torch.Tensor:
    """``dp_mix_plain`` with the mix through a padded neighbor list: idx,
    w [N, k] (int32, float32), self_w [N] float32; the other operands as
    there. z = x + n/c is made once, then

        mix = self_w z + sum_s w[:, s] z[idx[:, s]]      (slot order)
        out = x + eta listen (mix + m_scale sigma_m Gm - x - self n/c)

    the reference's order. Gossip mixes x."""
    N, D = p.shape
    x = p.float() - gamma * g.float()
    col = lambda v: v.reshape(N, 1)
    rows = idx.long()

    def gather_mix(z):
        acc = col(self_w) * z
        for s in range(idx.shape[1]):
            acc = acc + w[:, s:s + 1] * z[rows[:, s]]
        return acc

    if noisy:
        g_n, g_m = noise.normal_pair_hash(
            (N, D), counter_width, col0.reshape(-1)[0], seed.reshape(-1)[0],
            device=p.device)
        nf = (col(amp) / scal[0]) * g_n
        upd = gather_mix(x + nf) + (col(mscale) * scal[1]) * g_m - col(selfs) * nf
    else:
        upd = gather_mix(x)
    return (x + eta * col(listen) * (upd - x)).to(p.dtype)
