"""The fused DWFL round in plain PyTorch: ``dp_mix_plain``, the twin of
the reference's ``dp_mix_fused_jnp`` (repro/kernels/dp_mix/dp_mix.py) with
the ``_round_math`` arithmetic.

It is what ``ops.dp_mix_round`` runs for a tensor on the CPU, and what the
CUDA kernel (``csrc/dp_mix.cu``) is held against on the card. The noise is
the counter-hash stream of ``repro_torch.kernels.noise``, so this version
draws the reference's normals from the same seed.
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
