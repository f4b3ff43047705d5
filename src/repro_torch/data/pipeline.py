"""Host-side federated data: per-worker sample pools (the reference's
``repro.data.pipeline.FederatedBatcher``). The port draws training batches
on the device (``data.device.ClassificationStore``); the host batcher
supplies only the pinned evaluation batch."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


class FederatedBatcher:
    def __init__(self, x: np.ndarray, y: np.ndarray,
                 partitions: List[np.ndarray], batch_size: int):
        self.x, self.y = x, y
        self.parts = partitions
        self.b = batch_size

    def full(self, max_per_worker: int = 512) -> Dict[str, np.ndarray]:
        """Evaluation batch: a fixed per-worker slice of the local data."""
        m = min(max_per_worker, min(len(p) for p in self.parts))
        xs = np.stack([self.x[p[:m]] for p in self.parts])
        ys = np.stack([self.y[p[:m]] for p in self.parts])
        return {"x": xs, "y": ys}
