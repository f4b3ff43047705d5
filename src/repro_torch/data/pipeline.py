"""Host-side federated data (the reference's ``repro.data.pipeline``):
``FederatedBatcher``, per-worker sample pools, whose ``next`` draws the
worker-stacked training batch of ``--no-scan`` on the host, bitwise the
reference's draw at the same seed, and ``full`` the pinned evaluation
batch; ``LMBatcher``, the same over disjoint slices of a token stream,
its ``next`` bitwise the reference's (the LM eval batch and the
``--no-scan`` batches)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


class FederatedBatcher:
    def __init__(self, x: np.ndarray, y: np.ndarray,
                 partitions: List[np.ndarray], batch_size: int, seed: int = 0):
        self.x, self.y = x, y
        self.parts = partitions
        self.b = batch_size
        self.rng = np.random.default_rng(seed)

    def next(self) -> Dict[str, np.ndarray]:
        """{"x": [W, b, ...], "y": [W, b]}: each worker's b samples drawn
        from its own pool (with replacement only when the pool is smaller
        than b)."""
        W = len(self.parts)
        xs = np.empty((W, self.b) + self.x.shape[1:], self.x.dtype)
        ys = np.empty((W, self.b), self.y.dtype)
        for w, part in enumerate(self.parts):
            idx = self.rng.choice(part, self.b, replace=len(part) < self.b)
            xs[w], ys[w] = self.x[idx], self.y[idx]
        return {"x": xs, "y": ys}

    def full(self, max_per_worker: int = 512) -> Dict[str, np.ndarray]:
        """Evaluation batch: a fixed per-worker slice of the local data."""
        m = min(max_per_worker, min(len(p) for p in self.parts))
        xs = np.stack([self.x[p[:m]] for p in self.parts])
        ys = np.stack([self.y[p[:m]] for p in self.parts])
        return {"x": xs, "y": ys}


class LMBatcher:
    def __init__(self, tokens: np.ndarray, n_workers: int, batch_size: int,
                 seq_len: int, seed: int = 0):
        self.tokens = tokens
        self.W, self.b, self.S = n_workers, batch_size, seq_len
        per = len(tokens) // n_workers
        self.slices = [tokens[w * per:(w + 1) * per] for w in range(n_workers)]
        self.rng = np.random.default_rng(seed)

    def next(self) -> Dict[str, np.ndarray]:
        """{"tokens": [W, b, S] int32}: each worker's b windows of S
        tokens from its own slice, their starts uniform in [0, per - S -
        1)."""
        out = np.empty((self.W, self.b, self.S), np.int32)
        for w, sl in enumerate(self.slices):
            starts = self.rng.integers(0, len(sl) - self.S - 1, self.b)
            for i, s in enumerate(starts):
                out[w, i] = sl[s:s + self.S]
        return {"tokens": out}
