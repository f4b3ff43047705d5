"""Per-(arch x shape x mesh) cases of the dry run (the reference's
``repro.launch.specs``).

``build_case`` returns one of three steps with its arguments on
``device`` (the meta device by default: shapes and dtypes, no memory),
and the spec tree that places each argument on the mesh
(``launch.shardings``):

    train    — the full DWFL round (per-worker gradients, the local step,
               the exchange) at W = the mesh's workers:
               step(worker_params, batch, generator)
    prefill  — the forward that builds the KV or state cache, with
               ``use_pallas`` (flash_attention, ssd_scan): step(params,
               batch)
    decode   — ONE new token against a seq_len cache: step(params, batch,
               cache, idx)

It also gives MODEL_FLOPS (6 N D train, 2 N_active D prefill and decode)
for the roofline's useful-compute ratio. The dtypes are
``DRYRUN_OVERRIDES``' bfloat16. The reference's ``remat`` (JAX
activation checkpointing under ``lax.scan``) has no reader in the port,
so it is left out. The train step's noise comes from a
``torch.Generator`` where the reference passes a key. The decode step's
``idx`` is an int32 0-d tensor on ``device`` holding the cache's last
position, replicated, as the reference's ``_sds((), jnp.int32)``: the
cache position is a device value, never read by the host (the meta
device proves it: a step that read it would fail there).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import get_arch, get_shape
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings as sh
from repro_torch.runtime import resolve_device

DRYRUN_OVERRIDES = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


@dataclass
class Case:
    name: str
    fn: Callable
    args: Tuple[Any, ...]
    tokens: float            # tokens processed per step (global)
    model_flops: float
    n_params: int
    kind: str
    arg_specs: Tuple[Any, ...] = ()   # one spec tree per argument
    cfg: Optional[ModelConfig] = None
    mesh: Any = None
    seq_len: int = 0

    def argument_bytes(self) -> int:
        """Bytes of the tensor arguments, whole."""
        from repro_torch.core.exchange import tree_flatten
        return sum(t.numel() * t.element_size() for a in self.args
                   for t in tree_flatten(a)[0] if isinstance(t, torch.Tensor))

    def per_device_argument_bytes(self) -> int:
        """Bytes one device holds of the arguments under ``arg_specs``."""
        return sum(sh.per_device_bytes(a, s, self.mesh)
                   for a, s in zip(self.args, self.arg_specs)
                   if s is not None)


def count_params(tree) -> int:
    from repro_torch.core.exchange import tree_flatten
    return sum(t.numel() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def active_param_fraction(cfg: ModelConfig, n_params: int) -> float:
    """MoE: the fraction of the parameters active per token."""
    if not cfg.num_experts:
        return 1.0
    n_moe_layers = cfg.num_layers - cfg.first_dense_layers
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    inactive = (n_moe_layers * (cfg.num_experts - cfg.num_experts_per_tok)
                * per_expert)
    return max(0.05, (n_params - inactive) / n_params)


def _empty(shape, dtype, dev):
    return torch.empty(shape, dtype=dtype, device=dev)


def train_batch_shapes(cfg: ModelConfig, shp: ShapeConfig, W: int,
                       W_mesh: Optional[int] = None) -> dict:
    """[W, b, ...] leaves, b the global batch over the mesh's workers
    (``W_mesh``, default W)."""
    b = max(1, shp.global_batch // (W_mesh or W))
    S, d = shp.seq_len, cfg.d_model
    if cfg.is_encoder_decoder:
        return {"embeds": ((W, b, cfg.encoder_seq_len, d), torch.bfloat16),
                "tokens": ((W, b, S), torch.int32)}
    if cfg.embedding_inputs:
        return {"embeds": ((W, b, S, d), torch.bfloat16),
                "labels": ((W, b, S), torch.int32)}
    return {"tokens": ((W, b, S), torch.int32)}


def serve_batch_shapes(cfg: ModelConfig, B: int, S: int,
                       decode: bool) -> dict:
    d = cfg.d_model
    if decode:
        return {"tokens": ((B, 1), torch.int32)}
    if cfg.is_encoder_decoder:
        return {"embeds": ((B, cfg.encoder_seq_len, d), torch.bfloat16),
                "tokens": ((B, S), torch.int32)}
    if cfg.embedding_inputs:
        return {"embeds": ((B, S, d), torch.bfloat16),
                "labels": ((B, S), torch.int32)}
    return {"tokens": ((B, S), torch.int32)}


def _lead_spec(axes, ndim: int):
    lead = (axes if len(axes) > 1 else axes[0]) if axes else None
    return (lead,) + (None,) * (ndim - 1)


def build_case(arch: str, shape: str, mesh=None, device="meta", *,
               multi_pod: Optional[bool] = None, proto=None,
               overrides: Optional[dict] = None,
               workers: Optional[int] = None,
               seq_len: Optional[int] = None) -> Case:
    """The case of ``arch`` at ``shape`` on ``mesh`` (a
    ``launch.mesh.MeshShape``; default the single-pod production mesh, or
    the two-pod one with ``multi_pod``). ``workers`` and ``seq_len``
    override the train round's W and a train or prefill step's S,
    keeping the mesh's batch a worker (the dry run's fits count smaller
    rounds of the same shapes)."""
    from repro_torch.core import protocol as P
    from repro_torch.models import model as M
    if mesh is None:
        mesh = mesh_lib.production_mesh_shape(bool(multi_pod))
    if multi_pod is None:
        multi_pod = "pod" in mesh_lib.axis_sizes(mesh)
    dev = resolve_device(device)
    cfg = get_arch(arch, shape).replace(**(overrides or DRYRUN_OVERRIDES))
    shp = get_shape(shape)
    if seq_len is not None:
        shp = dataclasses.replace(shp, seq_len=int(seq_len))
    waxes = mesh_lib.worker_axes(multi_pod)
    W_mesh = mesh_lib.n_workers(mesh)
    W = W_mesh if workers is None else int(workers)
    gen = torch.Generator()
    params = M.init_params(gen, cfg, dev)
    n_params = count_params(params)
    act = active_param_fraction(cfg, n_params)
    name = f"{arch}|{shape}"

    if shp.kind == "train":
        del params
        proto = proto or P.ProtocolConfig(scheme="dwfl", n_workers=W,
                                          gamma=0.01, eta=0.5, clip=1.0)
        proto = dataclasses.replace(proto, n_workers=W)
        step = P.make_train_step(cfg, proto, dev)
        wp = P.init_worker_params(gen, cfg, W, dev)
        batch = {k: _empty(s, dt, dev) for k, (s, dt)
                 in train_batch_shapes(cfg, shp, W, W_mesh).items()}
        specs = (sh.param_specs(wp, mesh=mesh, worker_axes=waxes),
                 {k: _lead_spec(waxes, v.ndim) for k, v in batch.items()},
                 None)
        tokens = float(shp.global_batch * shp.seq_len)
        return Case(name, step, (wp, batch, gen), tokens,
                    6.0 * n_params * act * tokens, n_params, "train", specs,
                    cfg, mesh, shp.seq_len)

    pspecs = sh.param_specs(params, mesh=mesh, worker_axes=())
    if shp.kind == "prefill":
        def step(p, b):
            return M.prefill(p, b, cfg, use_pallas=True)
        batch = {k: _empty(s, dt, dev) for k, (s, dt) in serve_batch_shapes(
            cfg, shp.global_batch, shp.seq_len, False).items()}
        specs = (pspecs, {k: _lead_spec(waxes, v.ndim)
                          for k, v in batch.items()})
        tokens = float(shp.global_batch * shp.seq_len)
        return Case(name, step, (params, batch), tokens,
                    2.0 * n_params * act * tokens, n_params, "prefill", specs,
                    cfg, mesh, shp.seq_len)

    B = shp.global_batch

    def step(p, b, cache, idx):
        return M.decode_step(p, b, cache, idx, cfg)
    cache = M.init_cache(cfg, B, shp.seq_len, dev)
    dax = waxes if B >= W else ()
    batch = {k: _empty(s, dt, dev) for k, (s, dt) in serve_batch_shapes(
        cfg, B, shp.seq_len, True).items()}
    specs = (pspecs, {k: _lead_spec(dax, v.ndim) for k, v in batch.items()},
             sh.cache_specs(cache, mesh=mesh, data_axes=dax, batch_size=B),
             ())
    # the cache's last position
    idx = torch.full((), shp.seq_len - 1, dtype=torch.int32, device=dev)
    tokens = float(B)
    return Case(name, step, (params, batch, cache, idx), tokens,
                2.0 * n_params * act * tokens, n_params, "decode", specs,
                cfg, mesh, shp.seq_len)

