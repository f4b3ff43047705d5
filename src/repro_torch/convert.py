"""Parameters of the JAX reference -> the port's trees.

``params_from_jax`` takes the reference's MLP parameters as numpy arrays,
{"layers": [{"w": [in, out], "b": [out]}, ...]} for one worker or with a
leading worker axis ([N, in, out], [N, out]), and returns the port's flat
[N, d] float32 buffer (the reference's ravel order) with the matching
worker-stacked tree, so both packages compute on the same numbers. The
tree's leaves are materialized copies, each worker its own memory: a
stride-0 view handed to a kernel by its pointer would make every worker
read worker 0's parameters. ``fleet_params_from_jax`` does the same for
the fleet's [R, N, ...] parameters: the [R, N, d] buffer and its tree,
and ``lm_worker_params_from_jax`` for an LM's worker-stacked parameters
(the reference's ``init_worker_params`` tree: [N, ...] leaves).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.exchange import FlatSpec, tree_flatten, tree_unflatten
from repro_torch.runtime import resolve_device


def params_from_jax(tree, n_workers: Optional[int] = None, device="cuda"
                    ) -> Tuple[torch.Tensor, dict, FlatSpec]:
    """Returns (flat [N, d], worker-stacked tree of contiguous [N, ...]
    leaves, FlatSpec). An unstacked tree is repeated over ``n_workers``
    rows (default 1)."""
    if not (isinstance(tree, dict) and set(tree) == {"layers"}):
        raise ValueError("params_from_jax takes the MLP's {'layers': [...]} "
                         "tree; an LM's worker-stacked tree goes through "
                         "lm_worker_params_from_jax")
    dev = resolve_device(device)
    leaves, structure = tree_flatten(tree)
    arrs = [np.asarray(l) for l in leaves]
    stacked = arrs[0].ndim == 2 and arrs[1].ndim == 3   # layer 0: b, w
    if not stacked:
        n = 1 if n_workers is None else int(n_workers)
        arrs = [np.broadcast_to(a[None], (n,) + a.shape) for a in arrs]
    elif n_workers is not None and arrs[0].shape[0] != n_workers:
        raise ValueError(f"tree is stacked over {arrs[0].shape[0]} workers, "
                         f"asked for {n_workers}")
    tensors = tree_unflatten(structure, [
        torch.as_tensor(np.array(a), device=dev) for a in arrs])
    spec = FlatSpec(tensors, lead_axes=1)
    return spec.flatten(tensors), tensors, spec


def fleet_params_from_jax(tree, device="cuda"
                          ) -> Tuple[torch.Tensor, dict, FlatSpec]:
    """The reference fleet's [R, N, ...] MLP parameters (numpy leaves, as
    ``FleetEngine.init_worker_params`` makes them) -> (flat [R, N, d]
    float32 in the reference's ravel order, the tree of contiguous [R, N,
    ...] leaves, FlatSpec with lead axes 2)."""
    return _stacked(tree, 2, device)


def lm_worker_params_from_jax(tree, device="cuda"
                              ) -> Tuple[torch.Tensor, dict, FlatSpec]:
    """The reference's worker-stacked LM parameters (``init_worker_params``
    of an LM: nested dicts of [N, ...] leaves, as numpy arrays) -> (flat
    [N, d] float32 in the reference's ravel order, the port's tree of
    contiguous [N, ...] leaves, dtypes kept, one copy a worker, and its
    FlatSpec)."""
    return _stacked(tree, 1, device)


def _stacked(tree, lead_axes: int, device):
    dev = resolve_device(device)
    leaves, structure = tree_flatten(tree)
    tensors = tree_unflatten(structure, [
        torch.as_tensor(np.array(l), device=dev) for l in leaves])
    spec = FlatSpec(tensors, lead_axes=lead_axes)
    return spec.flatten(tensors), tensors, spec


def lm_params_from_jax(tree, device="cuda"):
    """The reference's LM parameters (nested dicts of arrays, as
    ``np.asarray`` leaves) -> the port's tree of contiguous tensors on
    ``device``, same keys, dtypes kept."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: lm_params_from_jax(v, dev) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=dev)
