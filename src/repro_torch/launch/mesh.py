"""Process-group meshes for the sharded rounds — the port of the
reference's ``repro.launch.mesh`` on ``torch.distributed``.

Each function returns a ``torch.distributed.device_mesh.DeviceMesh`` over
the ranks of the default process group, which the caller has initialized
(``torch.distributed.init_process_group``, or ``torchrun``): NCCL for CUDA
tensors, gloo on the CPU. A mesh axis is a process group
(``mesh.get_group(name)``): "model" for the flat buffer's columns
(``shard.round``), "workers" for its rows (``shard.worker``), "replicas"
for the fleet's networks. NCCL takes one rank a card.

The production mesh of the dry run (``launch.specs``, ``launch.dryrun``)
is an abstract ``MeshShape``, axis names and sizes with no devices and no
process group: (data 16, model 16), or (pod 2, data 16, model 16) for two
pods. The DWFL worker axis is "data" (16 workers), or ("pod", "data")
(32); each worker is one model-parallel group of 16 chips.

Functions only: importing this module touches no process group.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.runtime import resolve_device


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind it."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``MeshShape``, or of any mesh with
    ``axis_names`` and ``devices.shape`` (a jax mesh) or ``mesh.shape``
    (a torch DeviceMesh with ``mesh_dim_names``)."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    if isinstance(mesh, MeshShape):
        sizes = mesh.sizes
    elif hasattr(mesh, "devices"):
        sizes = mesh.devices.shape
    else:
        sizes = mesh.mesh.shape
    return dict(zip(names, (int(s) for s in sizes)))


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def worker_axes(multi_pod: bool = False) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def n_workers(mesh) -> int:
    sizes = axis_sizes(mesh)
    return sizes.get("pod", 1) * sizes["data"]


def model_size(mesh) -> int:
    return axis_sizes(mesh)["model"]


def n_chips(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


def gather_into(out, inp, group=None) -> None:
    """``out`` [S n, ...] <- the ranks' ``inp`` [n, ...] concatenated in
    rank order: ``all_gather_single`` where this torch has it, else its
    older name ``all_gather_into_tensor``."""
    import torch.distributed as dist
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp.contiguous(), group=group)


def _make_mesh(shape, names, device):
    """A DeviceMesh of ``shape`` over the default group, its communicators
    started on ``device`` (this rank's card, e.g. "cuda:1", which the
    caller has made the current device; or "cpu")."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    mesh = init_device_mesh(dev.type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(names))
    # a communicator is set up by its first collective: start each axis's
    # here, so that a round's first collective runs on a ready one (inside
    # obs.no_implicit_transfers, where the set-up's host waits would fail)
    for name in names:
        dist.all_reduce(torch.zeros(1, device=dev), group=mesh.get_group(name))
    return mesh


def make_host_mesh(n_data: int = 1, n_model: int = 1, device="cpu"):
    """A small ("data", "model") mesh for tests."""
    return _make_mesh((n_data, n_model), ("data", "model"), device)


def make_worker_mesh(n_worker_shards: int, device="cuda"):
    """The ("workers",) mesh that row-shards the worker population
    (``shard.worker``). Needs n_worker_shards ranks."""
    return _make_mesh((int(n_worker_shards),), ("workers",), device)


def make_shard_mesh(n_model: int, n_replicas: Optional[int] = None,
                    device="cuda"):
    """The mesh of the model-sharded flat round (``shard.round``): ("model",)
    for one network, ("replicas", "model") when the fleet's replicate axis
    composes with it (n_replicas=1 for a fleet whose replicates all live in
    one model group: the fleet step needs the axis to exist). Needs
    max(n_replicas, 1) n_model ranks. ``device``: this rank's card
    ("cuda:<local rank>") or "cpu"."""
    if n_replicas is not None:
        return _make_mesh((n_replicas, n_model), ("replicas", "model"),
                          device)
    return _make_mesh((n_model,), ("model",), device)
