"""Dirichlet label partitioning — a numpy copy of the reference's
``repro.data.partition.dirichlet_partition``, bitwise equal to it."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(y: np.ndarray, n_workers: int, alpha: float = 0.5,
                        seed: int = 0) -> List[np.ndarray]:
    """Per-worker index arrays of equal size, drawn without replacement by
    Dirichlet class proportions (alpha -> inf is IID)."""
    rng = np.random.default_rng(seed)
    n = len(y)
    classes = np.unique(y)
    per_worker = n // n_workers
    props = rng.dirichlet([alpha] * len(classes), size=n_workers)
    idx_by_class = {c: rng.permutation(np.where(y == c)[0]).tolist() for c in classes}
    out = []
    for w in range(n_workers):
        want = (props[w] / props[w].sum() * per_worker).astype(int)
        take = []
        for ci, c in enumerate(classes):
            got = idx_by_class[c][:want[ci]]
            idx_by_class[c] = idx_by_class[c][want[ci]:]
            take.extend(got)
        # top up from whatever classes still have samples
        pool = [i for c in classes for i in idx_by_class[c]]
        rng.shuffle(pool)
        while len(take) < per_worker and pool:
            take.append(pool.pop())
        taken = set(take)
        for c in classes:
            idx_by_class[c] = [i for i in idx_by_class[c] if i not in taken]
        out.append(np.array(take[:per_worker], np.int64))
    return out
