"""Worker-axis sharded execution of the sparse-mixing DWFL round — the port
of the reference's ``repro.shard.worker``.

``shard.round`` splits the flat buffer's columns; every rank still holds
all N worker rows. This module splits the worker axis: with S ranks and
N % S == 0, rank s holds rows [s Nb, (s + 1) Nb) of the [N, d] buffer (Nb
= N / S) and

* the per-worker gradient pass, the round's largest cost at scale, runs
  on the rank's Nb workers and their rows of the batch;
* its DP noise is drawn with the block's global row offset (``row0``:
  counters 2 ((row0 + r) counter_width + col) on the card,
  ``kernels.dp_mix.ops.dp_mix_prep_rows``), so the ranks' streams tile the
  unsharded stream;
* the mix gathers neighbor rows from one all-gather (``launch.mesh.gather_into``) of
  the noised buffer z = x + n/c (``dp_mix_gather_rows``): the [N, d]
  float32 transient is the only full-population tensor (a neighbor can
  live on any rank), freed within the round.

Each element's arithmetic is the unsharded sparse round's, so the round
is bitwise ``ops.dp_mix_round_sparse``'s on the whole population, on the
CPU and on the card (the reference, whose XLA fuses the chain differently
around its collective, is ULP-close). Only the sparse neighbor-list path
is supported: worker-scale N is where a dense [N, N] W must not exist.
"""
from __future__ import annotations

import torch

from repro_torch.core import exchange as exchange_lib
from repro_torch.core import protocol as protocol_lib
from repro_torch.kernels.dp_mix import ops as mix_ops
from repro_torch.runtime import resolve_device


def worker_window_round(p_loc, g_loc, seed, plan, row0: int, n_workers: int,
                        *, gamma: float, eta: float, axis=None, out=None
                        ) -> torch.Tensor:
    """One rank's row window of the fused sparse round: p_loc, g_loc [Nb,
    d] are rows [row0, row0 + Nb); ``plan`` is the whole population's
    MixPlan (its per-receiver vectors [N] are cheap; its W a SparseW);
    ``axis`` the process group whose ranks hold the other windows, in row
    order; ``out`` the tensor the window is written into (it may be p_loc:
    ``ops.dp_mix_gather_rows``), else a new one."""
    from repro_torch.launch.mesh import gather_into
    from repro_torch.net.sparse import SparseW
    sw = plan.W
    if not isinstance(sw, SparseW):
        raise TypeError("worker-axis sharding requires a sparse neighbor "
                        "list (ProtocolConfig(sparse_neighbors=k)); got a "
                        f"dense {type(sw).__name__} mixing matrix")
    nb = p_loc.shape[0]
    rows = slice(row0, row0 + nb)
    mine = lambda v: (v[rows] if torch.is_tensor(v) and v.ndim > 0 else v)
    m_scale = plan.m_scale
    if m_scale is None:
        m_scale = (torch.ones((n_workers,), device=p_loc.device)
                   / (plan.c * max(n_workers - 1, 1)))
    ws = mix_ops.dp_mix_prep_rows(p_loc, g_loc, seed, plan.amp[rows], plan.c,
                                  gamma=gamma, row0=row0,
                                  n_workers=n_workers, noisy=plan.noisy)
    # the one full-population tensor: every rank's z in row order
    z_full = ws.new_empty((n_workers, ws.shape[-1]))
    gather_into(z_full, ws[0], axis)
    return mix_ops.dp_mix_gather_rows(
        p_loc, g_loc, ws, z_full, seed, sw[rows], plan.amp[rows], plan.c,
        plan.sigma_m, gamma=gamma, eta=eta, row0=row0,
        self_scale=mine(plan.self_scale), m_scale=mine(m_scale),
        listen=mine(plan.listen), noisy=plan.noisy, out=out)


def _worker_group(proto, mesh, axis: str):
    """(the process group of ``mesh``'s ``axis``, its size S), checked."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no {axis!r} axis: {names}")
    S = mesh.size(names.index(axis))
    if proto.n_workers % S != 0:
        raise ValueError(f"n_workers={proto.n_workers} must divide evenly "
                         f"over the {S} {axis!r} shards")
    return mesh.get_group(axis), S


def local_rows(flat, mesh, axis: str = "workers") -> torch.Tensor:
    """This rank's rows of a whole [N, d] buffer (the placement the worker
    step takes)."""
    import torch.distributed as dist
    names = tuple(mesh.mesh_dim_names)
    S = mesh.size(names.index(axis))
    nb = flat.shape[0] // S
    r = dist.get_rank(mesh.get_group(axis))
    return flat[r * nb:(r + 1) * nb].contiguous()


def full_rows(flat_loc, mesh, axis: str = "workers") -> torch.Tensor:
    """Every rank's rows gathered back into the [N, d] buffer (for an eval
    or a checkpoint, never inside a round)."""
    from repro_torch.launch.mesh import gather_into
    names = tuple(mesh.mesh_dim_names)
    S = mesh.size(names.index(axis))
    out = flat_loc.new_empty((S * flat_loc.shape[0],) + flat_loc.shape[1:])
    gather_into(out, flat_loc, mesh.get_group(axis))
    return out


def make_worker_sharded_dynamic_flat_train_step(cfg, proto, spec, mesh,
                                                axis: str = "workers",
                                                device="cuda",
                                                remat: bool = False):
    """The worker-axis sharded twin of
    ``protocol.make_dynamic_flat_train_step``:

        step(flat, batch, seed, chan, W, out=None) -> (flat', metrics)

    ``flat`` is this rank's rows [Nb, d] of the buffer (``local_rows``),
    ``out`` the tensor flat' is written into (it may be ``flat``);
    ``batch`` the whole population's [N, B, ...] (every rank draws the
    same; the step takes its rows); seed, chan and W the round's, the same
    on every rank (W a ``net.sparse.SparseW``). The rows, losses and
    gradient norms are bitwise the unsharded sparse step's; param_norm is
    a sum of the ranks' partial sums (ULP-close)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import gather_into
    if spec.layout is not None:
        raise ValueError("worker-axis sharding takes the unsharded exact-d "
                         "FlatSpec (model-axis column windows don't compose "
                         "with the row split yet)")
    group, S = _worker_group(proto, mesh, axis)
    if proto.n_workers < 2:
        raise ValueError("worker-axis sharding needs n_workers >= 2")
    dev = resolve_device(device)
    N = proto.n_workers
    Nb = N // S
    local_grads = protocol_lib.make_flat_local_pass(cfg, proto, spec,
                                                    remat=remat)
    mix = protocol_lib._flat_spec(proto, dynamic=True)
    gamma, eta = proto.gamma, proto.eta
    row0 = dist.get_rank(group) * Nb

    def gather_rows(v):
        out = v.new_empty((S * v.shape[0],))
        gather_into(out, v, group)
        return out

    def step(flat_loc, batch, seed, chan, W, out=None):
        block = exchange_lib.tree_map(lambda t: t[row0:row0 + Nb], batch)
        losses_b, g_loc, gnorms_b = local_grads(flat_loc, block)
        plan = mix.plan(proto, chan, dev, W)
        flat_loc = worker_window_round(flat_loc, g_loc, seed, plan, row0, N,
                                       gamma=gamma, eta=eta, axis=group,
                                       out=out)
        sq = torch.sum(flat_loc.float() ** 2)
        dist.all_reduce(sq, group=group)
        return flat_loc, {"loss": gather_rows(losses_b).mean(),
                          "grad_norm": gather_rows(gnorms_b).mean(),
                          "param_norm": torch.sqrt(sq)}

    step.writes_into = True
    return step
