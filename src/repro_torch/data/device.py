"""Device-resident classification data with on-device batch sampling
(the reference's ``repro.data.device.ClassificationStore``).

The whole dataset and the per-worker index pools live on the device; a
round's [W, B] batch is a gather. Pools have unequal sizes (Dirichlet
partitions), so the pool is a padded [W, m] matrix and the draw for
worker w is j = min(floor(u * size_w), size_w - 1) for a uniform u in
[0, 1). The uniforms are an argument of ``sample`` — drawn by the caller
from its generator (``uniforms``) or replayed from the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from repro_torch.runtime import resolve_device


@dataclass(frozen=True)
class ClassificationStore:
    x: torch.Tensor          # [n, D] features
    y: torch.Tensor          # [n] int64 labels
    pool: torch.Tensor       # [W, m] int64 global sample indices (padded)
    pool_size: torch.Tensor  # [W] int64 valid prefix length per worker
    batch: int               # per-worker batch size

    @property
    def n_workers(self) -> int:
        return int(self.pool.shape[0])

    def uniforms(self, generator: torch.Generator) -> torch.Tensor:
        """One round's [W, B] float32 uniforms from ``generator``."""
        return torch.rand((self.n_workers, self.batch), generator=generator,
                          device=self.pool.device)

    def draw(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One round's batch: ``sample(uniforms(generator))``."""
        return self.sample(self.uniforms(generator))

    def sample(self, u: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The worker-stacked batch {"x": [W, B, D], "y": [W, B]} picked
        by the uniforms ``u`` [W, B] (with replacement, uniform over each
        worker's pool)."""
        size = self.pool_size[:, None]
        j = torch.minimum((u.float() * size.float()).long(), size - 1)
        gidx = torch.gather(self.pool, 1, j)
        return {"x": self.x[gidx], "y": self.y[gidx]}

    @classmethod
    def build(cls, x, y, partitions: List[np.ndarray], batch_size: int,
              device="cuda") -> "ClassificationStore":
        dev = resolve_device(device)
        W = len(partitions)
        m = max(len(p) for p in partitions)
        pool = np.zeros((W, m), np.int64)
        size = np.empty((W,), np.int64)
        for w, part in enumerate(partitions):
            # wrap-pad; draws never index past size[w]
            pool[w] = np.resize(np.asarray(part, np.int64), m)
            size[w] = len(part)
        # float32 on the device, as the reference's store holds it (jax
        # without x64 turns the generator's float64 features into float32)
        return cls(x=torch.as_tensor(x, dtype=torch.float32, device=dev),
                   y=torch.as_tensor(y, dtype=torch.int64, device=dev),
                   pool=torch.as_tensor(pool, device=dev),
                   pool_size=torch.as_tensor(size, device=dev),
                   batch=int(batch_size))
