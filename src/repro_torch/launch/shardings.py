"""Sharding rules: the placement of parameter, batch and cache trees over
a production mesh (the reference's ``repro.launch.shardings``).

The rules are the reference's, over the port's trees (nested dicts with
the reference's keys; a None subtree holds no leaf). For each parameter
leaf, the largest eligible (divisible, at least the axis's size)
non-leading dimension goes over "model", with the reference's path
overrides (expert stacks shard the expert axis, down/out projections the
row axis, the mLSTM q/k/if projections and the sLSTM recurrence
replicate); the leading worker axis of a DWFL worker-stacked tree goes
over "data" (and "pod"); small leaves replicate.

A spec is a tuple with one entry a dimension: None, an axis name, or a
tuple of axis names (the reference's ``PartitionSpec`` entries, so
``tuple(P(...))`` compares equal to it). The mesh is any object
``launch.mesh.axis_sizes`` reads, usually a ``launch.mesh.MeshShape``.
``per_device_bytes`` is the memory a tree takes on each device under its
specs; ``flat_buffer_sharding`` is the placement of the persistent flat
DWFL buffer, whose column windows are ``shard.ShardLayout``'s.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.launch.mesh import axis_sizes

Spec = Tuple


def _model_dim(shape, skip: int, msize: int, path: str = "") -> Optional[int]:
    """The dim to shard over "model": the largest divisible dim (ties go
    to the later dim, column parallel), the leading ``skip`` dims left
    out. Path overrides: expert stacks shard the expert dim; *down/*out
    projections prefer the penultimate (row parallel) dim; the mLSTM's
    q/k/if projections and the sLSTM's recurrent weights replicate."""
    eligible = [d for d in range(skip, len(shape))
                if shape[d] >= msize and shape[d] % msize == 0]
    if not eligible:
        return None
    if "mlstm" in path and any(t in path for t in ("w_q", "w_k", "w_if")):
        return None
    if "slstm" in path and "r_zifo" in path:
        return None
    if "moe/w_" in path and len(shape) - skip >= 3:
        d = len(shape) - 3  # [.., E, in, out] -> shard experts
        if d in eligible:
            return d
    if any(t in path for t in ("w_down", "wo", "w_out")) and len(shape) >= 2:
        d = len(shape) - 2
        if d in eligible:
            return d
    return max(eligible, key=lambda d: (shape[d], d))


def map_with_path(fn: Callable, tree, path: str = ""):
    """``fn(path, leaf)`` over every leaf of a tree of dicts and lists,
    the path "a/b/0/c" as the reference's ``_path_str`` writes it; a None
    subtree stays None. A tuple is a leaf: a spec tree maps too."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def leaves_with_path(tree, path: str = ""):
    """[(path, leaf)] of a tree, in ``map_with_path``'s order."""
    out = []
    map_with_path(lambda p, l: out.append((p, l)), tree, path)
    return out


def _lead(axes: Tuple[str, ...]):
    return axes if len(axes) > 1 else axes[0]


def param_specs(params, *, mesh, worker_axes: Tuple[str, ...] = ()):
    """The spec tree of a (possibly worker-stacked) parameter tree.
    ``worker_axes``: the mesh axes of the leading worker dim (() for
    serving). "model" is placed only among the last three dims of a
    leaf, never on a layer-stack dim."""
    msize = axis_sizes(mesh)["model"]
    n_lead = len(worker_axes)

    def spec_for(path, leaf):
        shape, ndim = tuple(leaf.shape), len(leaf.shape)
        d = _model_dim(shape, n_lead, msize, path) if ndim > n_lead else None
        if d is not None and d < ndim - 3:
            d = None
        spec = [None] * ndim
        if worker_axes:
            spec[0] = _lead(worker_axes)
        if d is not None:
            spec[d] = "model"
        return tuple(spec)

    return map_with_path(spec_for, params)


def batch_specs(batch, *, mesh, worker_axes: Tuple[str, ...] = (),
                data_axes: Tuple[str, ...] = ()):
    """Batch leaves: worker-stacked [W, b, ...] over ``worker_axes``,
    serving [B, ...] over ``data_axes``, where the leading dim is at least
    the axes' size."""
    lead = worker_axes or data_axes
    sizes = axis_sizes(mesh)

    def spec_for(path, leaf):
        spec = [None] * len(leaf.shape)
        if lead and leaf.shape[0] >= math.prod(sizes[a] for a in lead):
            spec[0] = _lead(lead)
        return tuple(spec)

    return map_with_path(spec_for, batch)


def cache_specs(cache, *, mesh, data_axes: Tuple[str, ...] = ("data",),
                batch_size: int = 0):
    """KV and state caches, stacked [L(, k), B, ...]: the first dim whose
    size is the batch size goes over ``data_axes`` (never a layer-stack
    dim), and a trailing feature dim over "model" where eligible."""
    sizes = axis_sizes(mesh)
    msize = sizes["model"]
    dsize = math.prod(sizes[a] for a in data_axes) if data_axes else 0

    def spec_for(path, leaf):
        shape, ndim = tuple(leaf.shape), len(leaf.shape)
        spec = [None] * ndim
        if data_axes and dsize and batch_size and batch_size % dsize == 0:
            for d in range(ndim - 1):
                if shape[d] == batch_size:
                    spec[d] = _lead(data_axes)
                    break
        for d in range(ndim - 1, max(ndim - 3, 0), -1):
            if spec[d] is None and shape[d] >= msize and shape[d] % msize == 0:
                spec[d] = "model"
                break
        return tuple(spec)

    return map_with_path(spec_for, cache)


def flat_buffer_sharding(spec, replicate_axis: Optional[str] = None) -> Spec:
    """The placement of the persistent flat buffer of an
    ``exchange.FlatSpec``: its column axis over "model" when the spec
    carries a ``shard.ShardLayout`` (S windows of ``shard_width``
    columns), the fleet's leading replicate axis over
    ``replicate_axis``."""
    parts = [None] * (spec.lead_axes + 1)
    if replicate_axis is not None:
        parts[0] = replicate_axis
    layout = getattr(spec, "layout", None)
    if layout is not None and layout.n_shards > 1:
        parts[-1] = "model"
    return tuple(parts)


def shard_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's block of a leaf of ``shape`` under ``spec``: each dim
    divided by the product of its axes' sizes, rounded up."""
    sizes = axis_sizes(mesh)
    out = []
    for n, entry in zip(shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        out.append(-(-int(n) // math.prod(sizes[a] for a in axes)))
    return tuple(out)


def _itemsize(leaf) -> int:
    dtype = leaf.dtype
    return (dtype.itemsize if isinstance(dtype, torch.dtype)
            else torch.empty((), dtype=dtype).element_size())


def per_device_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` under ``specs`` (a matching
    spec tree): each leaf's ``shard_shape`` times its element size."""
    spec_of = dict(leaves_with_path(specs))
    total = 0
    for path, leaf in leaves_with_path(tree):
        total += math.prod(shard_shape(leaf.shape, spec_of[path], mesh)) \
            * _itemsize(leaf)
    return total
