"""Padded neighbor-list mixing matrices for O(N k) DWFL rounds — the port
of the reference's ``repro.net.sparse``.

On a unit-disk graph each worker hears a handful of neighbors, so the
round's W is k-sparse. ``SparseW(idx [..., N, k] int32, w [..., N, k]
float32, self_w [..., N] float32)`` holds it at a fixed degree cap k:

  * every row has k slots; realized neighbors fill the leading ones, and
    a padded slot carries idx = its own row and w = 0, so a gather
    through it reads the worker itself with zero weight. A slot is an
    edge where w > 0.
  * ``geometry.sparse_metropolis`` builds the mutual-kNN ∩ unit-disk
    graph straight into this form: symmetric, degree <= k, Metropolis
    weights, self_w = 1 - sum w (doubly stochastic, as the dense
    ``metropolis_weights``).
  * mixing through it is k row gathers of the [N, d] buffer
    (``core.exchange.mix_exchange_sparse`` on the worker tree,
    ``kernels.dp_mix.ops.dp_mix_round_sparse`` on the flat buffer), never
    an [N, N] tensor.

A trajectory stacks rounds on a leading axis ([T, N, k] leaves:
``stack_w``, ``cat_w``, ``sw[t]``); ``dense`` takes unstacked leaves only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch


@dataclass(frozen=True)
class SparseW:
    """A padded neighbor-list mixing matrix (see the module docstring).
    Leaves may carry leading axes (a trajectory's rounds); the shape
    helpers read the trailing ones."""
    idx: torch.Tensor      # [..., N, k] int32; a padded slot points at its row
    w: torch.Tensor        # [..., N, k] float32; a padded slot is exactly 0
    self_w: torch.Tensor   # [..., N] float32 diagonal weight

    @property
    def n_workers(self) -> int:
        return int(self.idx.shape[-2])

    @property
    def k(self) -> int:
        return int(self.idx.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.idx.device

    def valid(self) -> torch.Tensor:
        """[..., N, k] bool: the realized (not padded) slots."""
        return self.w > 0

    def off_degree(self) -> torch.Tensor:
        """[..., N] float32 count of realized off-diagonal neighbors — the
        dense path's sum((W > 0) & ~eye, 1)."""
        return self.valid().sum(-1).to(torch.float32)

    def dense(self) -> torch.Tensor:
        """The dense [N, N] W (a small-N reference: O(N^2), never inside a
        worker-scale round)."""
        if self.idx.ndim != 2:
            raise ValueError("dense() expects unbatched [N, k] leaves; got "
                             f"idx shape {tuple(self.idx.shape)}")
        n = self.n_workers
        rows = torch.arange(n, device=self.device)[:, None].expand(n, self.k)
        W = torch.zeros((n, n), dtype=self.w.dtype, device=self.device)
        W.index_put_((rows, self.idx.long()), self.w, accumulate=True)
        return W + torch.diag(self.self_w)

    def layout_meta(self) -> dict:
        """The layout's JSON descriptor (the reference's checkpoint
        metadata)."""
        return {"format": "padded-neighbor-v1", "n_workers": self.n_workers,
                "k": self.k, "pad": "self-index-zero-weight"}

    def to(self, device) -> "SparseW":
        return SparseW(self.idx.to(device), self.w.to(device),
                       self.self_w.to(device))

    def __getitem__(self, r) -> "SparseW":
        """Round ``r`` (or a slice of rounds) of a stacked SparseW."""
        return SparseW(self.idx[r], self.w[r], self.self_w[r])


def stack_w(Ws: Sequence):
    """Rounds' mixing matrices on a new leading axis: dense [N, N] tensors
    into [T, N, N], SparseWs into one with [T, N, k] leaves."""
    if isinstance(Ws[0], SparseW):
        return SparseW(*(torch.stack([getattr(sw, f) for sw in Ws])
                         for f in ("idx", "w", "self_w")))
    return torch.stack(list(Ws))


def cat_w(Ws: Sequence):
    """Stacked mixing matrices joined along their leading round axis."""
    if isinstance(Ws[0], SparseW):
        return SparseW(*(torch.cat([getattr(sw, f) for sw in Ws])
                         for f in ("idx", "w", "self_w")))
    return torch.cat(list(Ws))


def top_k_stable(values: torch.Tensor, k: int):
    """The k largest of each row, ties toward the lower index (as
    ``lax.top_k``): a stable descending sort, whose order among equal
    values is the same on every device (``torch.topk`` promises none)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sparsify_dense(W: torch.Tensor, k: int) -> SparseW:
    """A dense mixing matrix as a SparseW of each row's k largest
    off-diagonal weights (ties toward the lower index). Lossless iff every
    row has <= k off-diagonal nonzeros; the dropped mass is not folded
    back into self_w."""
    n = W.shape[-1]
    offd = W * (1.0 - torch.eye(n, dtype=W.dtype, device=W.device))
    vals, idx = top_k_stable(offd, k)
    valid = vals > 0
    rows = torch.arange(n, dtype=torch.int32, device=W.device)[:, None]
    return SparseW(idx=torch.where(valid, idx.to(torch.int32), rows),
                   w=torch.where(valid, vals, 0.0).to(torch.float32),
                   self_w=torch.diagonal(W).to(torch.float32))


def isolated_count(sw: SparseW, mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """[...] int32: workers with no realized neighbor. ``mask`` [N] leaves
    churned-out workers out of the count (a worker offline this round is
    not isolated). A device tensor; the caller reads it when it needs
    to."""
    iso = sw.off_degree() <= 0
    if mask is not None:
        iso = iso & (torch.as_tensor(mask, device=sw.device) > 0)
    return iso.sum(-1).to(torch.int32)
