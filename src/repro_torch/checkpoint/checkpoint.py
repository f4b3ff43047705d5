"""Checkpoints: a numpy ``.npz`` payload and a JSON manifest — the port of
the reference's ``repro.checkpoint.checkpoint``, in its format, so either
package restores what the other wrote.

A tree (nested dicts, lists, tuples and dataclasses of tensors, numpy
arrays and numbers) is stored leaf by leaf under its path: a dict key as
``str(key)`` in sorted order, a list or tuple index as ``str(i)``, a
dataclass field by name, joined by "/" (jax's path strings for dicts and
lists). Tensors are copied to the host here, so a checkpoint is taken
between chunks, outside ``obs.no_implicit_transfers``. numpy has no
bfloat16, so a bfloat16 leaf is widened to float32 with ``orig_dtype``
"bfloat16", and a restore narrows it back. The ``.npz`` is written first,
then the ``.json``, each to a temporary file moved into place.

``save_flat`` stores the flat DWFL buffer in its canonical [lead..., d]
form with the writing layout in ``metadata.flat_layout``, so a buffer
written under any shard count restores under any other
(``restore_flat``). A mid-trajectory checkpoint carries the trajectory's
state under ``state/``: the ``torch.Generator``'s state (a uint8 array)
and the network's ``NetState``, all that a bitwise resume needs
(``trajectory_state``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _items(tree, prefix=""):
    """(path, leaf) pairs of ``tree`` in the reference's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _items(t, f"{prefix}{i}/")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _items(getattr(tree, f.name), f"{prefix}{f.name}/")
    else:
        yield prefix[:-1], tree


def _rebuild(like, values, prefix=""):
    """``like``'s structure with each leaf taken from ``values`` by path."""
    if isinstance(like, dict):
        return {k: _rebuild(v, values, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(t, values, f"{prefix}{i}/")
               for i, t in enumerate(like)]
        return out if isinstance(like, list) else type(like)(out)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), values,
                             f"{prefix}{f.name}/")
            for f in dataclasses.fields(like)})
    return values[prefix[:-1]]


def _describe(tree) -> str:
    """The tree's structure as a string (the reference writes its
    treedef's; no restore reads it)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(t) for t in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f.name}={_describe(getattr(tree, f.name))}"
            for f in dataclasses.fields(tree)) + ")"
    return "*"


def _dtype_name(v) -> str:
    if torch.is_tensor(v):
        return str(v.dtype).replace("torch.", "")
    return str(np.asarray(v).dtype)


def _host(v) -> np.ndarray:
    """A leaf as a numpy array on the host; bfloat16 widened to float32."""
    if torch.is_tensor(v):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def _write_atomic(path: str, mode: str, write) -> None:
    d = os.path.dirname(os.path.abspath(path))
    suffix = os.path.splitext(path)[1]
    with tempfile.NamedTemporaryFile(mode, dir=d, suffix=suffix,
                                     delete=False) as f:
        write(f)
        tmp = f.name
    os.replace(tmp, path)


def save(path: str, tree, step: int = 0,
         metadata: Optional[Dict[str, Any]] = None) -> None:
    """``path``.npz (the leaves by path) and ``path``.json (the manifest:
    step, structure, each leaf's shape, dtype and orig_dtype, metadata)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = dict(_items(tree))
    arrays = {k: _host(v) for k, v in leaves.items()}
    manifest = {
        "step": step,
        "treedef": _describe(tree),
        "leaves": {k: {"shape": list(a.shape), "dtype": str(a.dtype),
                       "orig_dtype": _dtype_name(leaves[k])}
                   for k, a in arrays.items()},
        "metadata": metadata or {},
    }
    _write_atomic(path + ".npz", "wb", lambda f: np.savez(f, **arrays))
    _write_atomic(path + ".json", "w",
                  lambda f: json.dump(manifest, f, indent=1))


def restore(path: str, like) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like`` (a template tree): each leaf
    in the template leaf's dtype, and for a tensor template on its
    device."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    values = {}
    with np.load(path + ".npz") as data:
        for k, tmpl in _items(like):
            a = data[k]
            if list(a.shape) != list(np.shape(tmpl)):
                raise ValueError(f"checkpoint leaf {k!r} has shape "
                                 f"{list(a.shape)}, the template "
                                 f"{list(np.shape(tmpl))}")
            if torch.is_tensor(tmpl):
                values[k] = torch.from_numpy(a).to(device=tmpl.device,
                                                   dtype=tmpl.dtype)
            else:
                dt = getattr(tmpl, "dtype", None)
                values[k] = a if dt is None else a.astype(dt)
    return _rebuild(like, values), manifest


def save_flat(path: str, flat, spec, *, step: int = 0, state=None,
              metadata: Optional[Dict[str, Any]] = None) -> None:
    """Checkpoint the flat DWFL buffer of an ``exchange.FlatSpec``: stored
    canonical ([lead..., d], ``spec.unpad``: padding carries nothing),
    with the writing layout in ``metadata.flat_layout`` (d, lead shape,
    shard count and width, chunk plan; ``shard``: the ``ShardLayout``'s
    record), so a restore under another d fails loudly. ``state``: an
    optional tree saved beside it (``trajectory_state``)."""
    meta = dict(metadata or {})
    meta["flat_layout"] = spec.layout_meta()
    if spec.layout is not None:
        meta["flat_layout"]["shard"] = spec.layout.to_meta()
    tree = {"flat": spec.unpad(flat)}
    if state is not None:
        tree["state"] = state
    save(path, tree, step=step, metadata=meta)


def restore_flat(path: str, spec, state_like=None, device="cuda"
                 ) -> Tuple[torch.Tensor, Any, Dict[str, Any]]:
    """Restore a ``save_flat`` checkpoint into ``spec``'s layout: (flat,
    state, manifest), ``flat`` the physical float32 buffer on ``device``
    (the canonical d columns bitwise, the padding zeros), whatever shard
    count wrote it. ``state_like`` mirrors the saved state's structure
    when one was saved."""
    from repro_torch.runtime import resolve_device
    dev = resolve_device(device)
    with open(path + ".json") as f:
        manifest = json.load(f)
    rec = manifest.get("metadata", {}).get("flat_layout", {})
    if rec:
        if int(rec.get("d", spec.d)) != spec.d:
            raise ValueError(
                f"checkpoint buffer has d={rec.get('d')} but the restoring "
                f"spec ravels to d={spec.d} — different model/leaf contract")
        ls = rec.get("lead_shape")
        if ls is not None and tuple(ls) != tuple(spec.lead_shape):
            raise ValueError(
                f"checkpoint buffer has lead shape {tuple(ls)} but the "
                f"restoring spec expects {tuple(spec.lead_shape)} — "
                f"different worker/replicate counts")
        if "shard" in rec:
            # the ShardLayout drift guard (a lane-tile change between the
            # writing and the restoring build)
            from repro_torch.shard.layout import ShardLayout
            ShardLayout.from_meta(rec["shard"])
    like = {"flat": torch.zeros(tuple(spec.lead_shape) + (spec.d,),
                                device=dev)}
    if state_like is not None:
        like["state"] = state_like
    tree, manifest = restore(path, like)
    flat = tree["flat"]
    if spec.width > spec.d:
        flat = torch.nn.functional.pad(flat, (0, spec.width - spec.d))
    return flat, tree.get("state"), manifest


def trajectory_state(carry) -> dict:
    """The part of a ``trajectory.TrajCarry`` besides its parameters that a
    bitwise resume needs: the generator's state, and the network's
    ``NetState`` and the telemetry moments where the carry has them."""
    state = {"generator": carry.generator.get_state()}
    if carry.net is not None:
        state["net"] = carry.net
    if carry.eps is not None:
        state["eps"] = carry.eps
    return state


def resume_carry(state, params, device="cuda"):
    """A ``trajectory.TrajCarry`` from a restored ``trajectory_state`` and
    the restored parameters: a generator on ``device`` in the saved
    state."""
    from repro_torch.core.trajectory import TrajCarry
    from repro_torch.runtime import resolve_device
    gen = torch.Generator(device=resolve_device(device))
    gen.set_state(state["generator"])
    return TrajCarry(gen, params, state.get("net"), state.get("eps"))
