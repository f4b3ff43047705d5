"""Model-axis shard geometry of the persistent flat [N, d] DWFL buffer —
the port of the reference's ``repro.shard.layout``, copied: it is pure
geometry.

The fused dp_mix round is independent column by column: the local SGD
step, the counter-hash noise, the mix (a contraction over workers, not
columns), the self-correction and the AWGN. ``ShardLayout`` fixes the
geometry under which a column-sharded round reproduces the single-device
one exactly:

* the buffer is padded to ``padded_width = n_shards * shard_width`` with
  ``shard_width`` a multiple of 128, shard s owning global columns
  [s * shard_width, (s + 1) * shard_width);
* the noise-counter stride ``counter_width`` = roundup(d, 128) depends on
  ``d`` only, never on the shard count: element (row, col) draws from the
  global counters 2 (row counter_width + col) and + 1 on whatever device
  holds it, so every shard count realizes the same stream;
* padding columns (global col >= d) are held at zero by the sharded round
  and no leaf offset reaches them, so re-laying a buffer out is a pad or
  a slice of the canonical [..., :d] view.

``plan_chunks`` cuts [0, d) at leaf and window boundaries (and at an
optional column budget) into the segments the gather-free gradient pass
moves one collective at a time (``repro_torch.shard.round``). Importing
this module touches no device and no process group.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# The noise counters' row-stride multiple of the dp_mix kernel family
# (``kernels.dp_mix.ops.LANES``; tests/test_torch_shard.py holds the two
# equal).
LANES = 128


def _roundup(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass(frozen=True)
class ShardLayout:
    """Geometry of a model-axis sharding of the flat [.., d] buffer."""
    d: int              # canonical (unpadded) flat width
    n_shards: int = 1   # model-axis size S

    def __post_init__(self):
        if self.d < 1:
            raise ValueError(f"d must be >= 1, got {self.d}")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")

    @property
    def counter_width(self) -> int:
        """Canonical noise-counter stride between worker rows — a function
        of d only (== the unsharded CPU kernel's padded width), so every
        shard count realizes the SAME stream."""
        return _roundup(self.d, LANES)

    @property
    def shard_width(self) -> int:
        """Columns per shard (lane-aligned)."""
        return _roundup(-(-self.d // self.n_shards), LANES)

    @property
    def padded_width(self) -> int:
        """Physical last-axis width of the sharded buffer."""
        return self.n_shards * self.shard_width

    def col_offsets(self) -> np.ndarray:
        """[S] global column offset of each shard's window."""
        return np.arange(self.n_shards, dtype=np.int32) * self.shard_width

    def pad(self, flat):
        """Canonical [..., d] buffer → physical [..., padded_width]."""
        if flat.shape[-1] != self.d:
            raise ValueError(f"expected canonical width {self.d}, got "
                             f"{flat.shape[-1]}")
        return torch.nn.functional.pad(flat, (0, self.padded_width - self.d))

    def unpad(self, flat):
        """Physical [..., padded_width] buffer → canonical [..., d]."""
        if flat.shape[-1] != self.padded_width:
            raise ValueError(f"expected physical width {self.padded_width}, "
                             f"got {flat.shape[-1]}")
        return flat[..., :self.d]

    def relayout(self, flat, other: "ShardLayout"):
        """Re-lay a physical buffer out for ``other`` (same d) — a pure
        slice + pad, since padding carries no information."""
        if other.d != self.d:
            raise ValueError(f"cannot relayout d={self.d} to d={other.d}")
        return other.pad(self.unpad(flat))

    def to_meta(self) -> dict:
        return {"d": self.d, "n_shards": self.n_shards,
                "shard_width": self.shard_width,
                "counter_width": self.counter_width}

    @classmethod
    def from_meta(cls, meta: dict) -> "ShardLayout":
        lay = cls(int(meta["d"]), int(meta["n_shards"]))
        for k in ("shard_width", "counter_width"):
            if k in meta and int(meta[k]) != getattr(lay, k):
                raise ValueError(
                    f"layout metadata mismatch: recorded {k}={meta[k]}, "
                    f"this build derives {getattr(lay, k)} (lane tile "
                    f"changed?)")
        return lay


# ---------------------------------------------------------------------------
# chunk plan: leaf x shard-window tiling of [0, d) for the gather-free pass
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Chunk:
    """One chunk of the gather-free grad pass: a contiguous global column
    span [start, stop) of the canonical [0, d) buffer that lies within
    exactly ONE leaf and ONE shard window. ``local_start``/``local_stop``
    are the same span in the owning shard's window coordinates
    (start − shard·shard_width)."""
    leaf: int           # leaf index in FlatSpec ravel order
    start: int          # global column span [start, stop)
    stop: int
    shard: int          # owning shard window
    local_start: int    # window-local coordinates of the same span
    local_stop: int

    @property
    def cols(self) -> int:
        return self.stop - self.start


@dataclass(frozen=True)
class ChunkPlan:
    """The per-leaf chunk plan of a ShardLayout.

    Contract (swept against the reference by tests/test_torch_shard.py):

    * the chunks tile [0, d) exactly once, in order, with no overlap;
    * every chunk lies within ONE leaf and ONE shard window — chunk
      boundaries are the union of leaf boundaries, window boundaries, and
      budget splits;
    * no chunk exceeds ``max_chunk_cols`` columns when a budget is set.

    The plan is PURE GEOMETRY: the executor (repro_torch.shard.round) derives
    its collective schedule from ``exec_segments()`` — the window-LOCAL
    column segments whose union of cut points covers [0, shard_width) —
    and moves one segment per collective, so the budget bounds the
    transient gather buffer at ~n_workers·max_chunk_cols elements while
    the realized arithmetic (and therefore the noise stream) is bitwise
    IDENTICAL across every budget choice: chunking is data movement,
    never math."""
    layout: ShardLayout
    max_chunk_cols: Optional[int] = None
    chunks: Tuple[Chunk, ...] = field(default=())

    def exec_segments(self) -> List[Tuple[int, int]]:
        """Window-local segments [(l0, l1), ...] partitioning
        [0, shard_width): the union of every window's chunk cut points
        (re-split to the budget so the padding tail of the last window
        obeys it too). One collective moves one segment — S aligned
        spans, one per window — so every segment's transient is at most
        ~n_shards·(budget) columns wide."""
        sw = self.layout.shard_width
        cuts = {0, sw}
        for c in self.chunks:
            cuts.add(c.local_start)
            cuts.add(min(c.local_stop, sw))
        edges = sorted(cuts)
        out: List[Tuple[int, int]] = []
        for a, b in zip(edges[:-1], edges[1:]):
            out.extend(_budget_splits(a, b, self.max_chunk_cols))
        return out

    def to_meta(self) -> dict:
        return {"max_chunk_cols": self.max_chunk_cols,
                "n_chunks": len(self.chunks)}


def _budget_splits(start: int, stop: int,
                   budget: Optional[int]) -> List[Tuple[int, int]]:
    """Split [start, stop) into even-ish pieces of at most ``budget``."""
    n = stop - start
    if budget is None or n <= budget:
        return [(start, stop)]
    pieces = -(-n // budget)
    edges = [start + (n * i) // pieces for i in range(pieces + 1)]
    return list(zip(edges[:-1], edges[1:]))


def plan_chunks(layout: ShardLayout, leaf_sizes: Sequence[int],
                max_chunk_cols: Optional[int] = None) -> ChunkPlan:
    """Build the ChunkPlan for ``layout`` over leaves of the given flat
    sizes (FlatSpec._sizes order). ``max_chunk_cols`` caps every chunk's
    width (None = unbounded: one chunk per leaf x window intersection)."""
    if sum(leaf_sizes) != layout.d:
        raise ValueError(f"leaf sizes sum to {sum(leaf_sizes)}, layout has "
                         f"d={layout.d}")
    if max_chunk_cols is not None and max_chunk_cols < 1:
        raise ValueError(f"max_chunk_cols must be >= 1, got "
                         f"{max_chunk_cols}")
    sw = layout.shard_width
    # global cut points: leaf boundaries + window boundaries inside [0, d)
    cuts = {0, layout.d}
    off = 0
    for n in leaf_sizes:
        off += n
        cuts.add(off)
    for s in range(1, layout.n_shards):
        if s * sw < layout.d:
            cuts.add(s * sw)
    edges = sorted(cuts)
    # leaf lookup by start offset
    leaf_starts = np.cumsum([0] + list(leaf_sizes))
    chunks: List[Chunk] = []
    for a, b in zip(edges[:-1], edges[1:]):
        leaf = int(np.searchsorted(leaf_starts, a, side="right") - 1)
        shard = a // sw
        for c0, c1 in _budget_splits(a, b, max_chunk_cols):
            chunks.append(Chunk(leaf, c0, c1, shard,
                                c0 - shard * sw, c1 - shard * sw))
    return ChunkPlan(layout, max_chunk_cols, tuple(chunks))
