"""The Mamba2 SSD intra-chunk step in plain PyTorch: ``ssd_intra_chunk_plain``,
the twin of the hand-written kernel (``csrc/ssd_scan.cu``) and of the
reference's ``_ssd_kernel`` (repro/kernels/ssd_scan/ssd_scan.py).

It is what ``ops.ssd_intra_chunk`` runs for a tensor on the CPU, and what
the CUDA kernel is held against on the card. Written as the tensor
algebra of the step, in float32, for every (batch, chunk) at once:
cs = cumsum(dA) within each chunk (``cumsum_f32``: the reference's
float32 summation order); scores = C Bᵀ; the decay-gated causal
mask L_ij = exp(cs_i - cs_j) for j <= i and 0 above the diagonal (the
difference is masked to -inf before the exp, so nothing above the
diagonal overflows); y_diag = (scores ∘ L) @ (x · dt); the chunk states
(B · exp(cs_last - cs) · dt)ᵀ @ x, stored [P, N] as the reference stores
them; and the chunk decay exp(cs_last).

``inter_chunk`` is the rest of the scan, which neither the reference's
kernel nor this step computes: the state recurrence over the chunks and the
off-diagonal term. ``ops.ssd_scan`` and ``models.ssm.ssd_chunked`` share it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

RUN = 16  # rows per run of the reference's cumulative sum


def cumsum_f32(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Float32 cumulative sum along ``dim`` in the order the reference's
    ``jnp.cumsum`` takes on the CPU (XLA rewrites it as a blocked scan):
    runs of 16 elements are summed in order, the runs' totals are summed
    in order, and each run adds the total of the runs before it. Bitwise
    the reference's at every chunk length the kernel takes (<= 256;
    XLA blocks longer ones again), so ``exp(cs_i - cs_j)``, which cancels most of cs's magnitude, carries
    the reference's rounding and not another order's. Each step is an
    elementwise add, so the order is the same on every device."""
    a = a.float().movedim(dim, -1)
    n = a.shape[-1]
    nb = -(-n // RUN)
    a = F.pad(a, (0, nb * RUN - n)).unflatten(-1, (nb, RUN))
    cols = [a[..., 0]]
    for k in range(1, RUN):
        cols.append(cols[-1] + a[..., k])
    loc = torch.stack(cols, dim=-1)                      # [..., nb, RUN]
    before = loc[..., 0, -1]
    runs = [loc[..., 0, :]]
    for b in range(1, nb):
        runs.append(loc[..., b, :] + before[..., None])
        before = before + loc[..., b, -1]
    out = torch.stack(runs, dim=-2).flatten(-2)[..., :n]
    return out.movedim(-1, dim)


def ssd_intra_chunk_plain(x: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
                          Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int):
    """x: [B,S,H,P]; dt, dA: [B,S,H]; Bm, Cm: [B,S,N]; S a multiple of
    ``chunk``. Returns (y_diag [B,S,H,P] in x's dtype, states
    [B,nc,H,P,N] float32, cdecay [B,nc,H] float32)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    q = chunk
    nc = S // q
    xc = x.float().reshape(B, nc, q, H, P)
    dtc = dt.float().reshape(B, nc, q, H)
    Bc = Bm.float().reshape(B, nc, q, N)
    Cc = Cm.float().reshape(B, nc, q, N)
    cs = cumsum_f32(dA.reshape(B, nc, q, H), dim=2)            # [B,nc,q,H]

    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)            # [B,nc,q,q]
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # [B,nc,i,j,H]
    below = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(diff.masked_fill(~below[:, :, None], float("-inf")))
    gated = scores[..., None] * L                               # [B,nc,i,j,H]
    xdt = xc * dtc[..., None]                                   # [B,nc,j,H,P]
    y = torch.einsum("bcijh,bcjhp->bcihp", gated, xdt)

    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs) * dtc       # [B,nc,q,H]
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", Bc, decay_to_end, xc)
    cdecay = torch.exp(cs[:, :, -1, :])
    return y.reshape(B, S, H, P).to(x.dtype), states, cdecay


def inter_chunk(states: torch.Tensor, cdecay: torch.Tensor, cs: torch.Tensor,
                Cc: torch.Tensor, initial_state=None):
    """The inter-chunk state recurrence (sequential over the chunks) and the
    off-diagonal (state-passing) term. states: [B,nc,H,P,N]; cdecay:
    [B,nc,H]; cs: [B,nc,q,H] within-chunk cumulative dA; Cc: [B,nc,q,N]
    float32. Returns (y_off [B,nc,q,H,P] float32, final state [B,H,P,N]
    float32)."""
    B, nc, H, P, N = states.shape
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=states.device)
         if initial_state is None else initial_state.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * cdecay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)       # [B,nc,H,P,N] state entering chunk
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, torch.exp(cs), h_prevs)
    return y_off, h
