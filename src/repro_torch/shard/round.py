"""Model-axis sharded execution of the fused flat-buffer DWFL round — the
port of the reference's ``repro.shard.round``.

The persistent [N, d] buffer (``exchange.FlatSpec`` with a
``shard.ShardLayout``) is split by columns into S windows of
``shard_width``; each window runs the whole fused dp_mix round (local
step, counter-hash noise, mix, self-correction, AWGN) with its noise
counters at its global columns (``col0`` = s shard_width, the layout's
``counter_width``), so the windows together draw the unsharded round's
noise stream and every real column is bitwise the unsharded round's.
Padding columns (global col >= d) are held at zero.

Two modes share the window primitive (``shard_window_round``):

* ``mesh=None`` — the logical mode: the padded buffer lives on one
  device and its S windows are one dp_mix call (``dp_mix_round_sharded``).
  No collectives; bitwise the unsharded step on the canonical columns.
* ``mesh`` (``launch.mesh.make_shard_mesh``, a ``torch.distributed``
  DeviceMesh with a "model" axis of S ranks): each rank holds [N,
  shard_width] of the buffer and mixes its own window. Only the
  per-worker gradient pass needs whole rows, and it gets them without
  ever gathering the buffer: the worker axis is split instead (Wb =
  ceil(N / S) rows a rank, zero-padded to S Wb), an ``all_to_all_single``
  per chunk segment (``spec.chunk_plan``, at most ``max_chunk_cols``
  columns each) trades the rank's column window for its row block's full
  rows, the gradients run on the block, and the reverse ``all_to_all``
  sends each window's gradient columns back to its owner. The buffer's
  rounds are bitwise the logical mode's; the metrics' sums are ULP-close
  (a sum of per-rank partial sums).

``make_fleet_sharded_step`` is the fleet's round on a 2-D ("replicas",
"model") mesh: each rank's local replicates ([R_loc, N, shard_width]),
their gradient pass as one batch, one dp_mix call for them all.
"""
from __future__ import annotations

import torch

from repro_torch.core import exchange as exchange_lib
from repro_torch.core import protocol as protocol_lib
from repro_torch.kernels.dp_mix import ops as mix_ops
from repro_torch.runtime import resolve_device
from repro_torch.shard.layout import ShardLayout


def shard_window_round(p_loc, g_loc, seed, plan, col0: int,
                       layout: ShardLayout, *, gamma: float, eta: float
                       ) -> torch.Tensor:
    """One column window of the fused round: dp_mix on the window [...,
    N, w] (contiguous) with its noise counters at global columns col0 ..,
    row stride the layout's ``counter_width``; the window's padding
    columns (global col >= d) set to zero."""
    out = mix_ops.dp_mix_round_plan(p_loc, g_loc, seed, plan, gamma=gamma,
                                    eta=eta, col0=col0,
                                    counter_width=layout.counter_width)
    real = layout.d - int(col0)
    if real < out.shape[-1]:
        out[..., max(real, 0):] = 0
    return out


def dp_mix_round_sharded(flat, g, seed, plan, layout: ShardLayout, *,
                         gamma: float, eta: float) -> torch.Tensor:
    """The logical mode's round over the padded [..., N, padded_width]
    buffer: its S windows as one dp_mix launch (``col0`` = 0; the counters
    are global, so window s's columns draw what its own call at ``col0`` =
    s shard_width would), the padding set to zero. Bitwise
    ``ops.dp_mix_round`` on the unpadded buffer's real columns."""
    return shard_window_round(flat.contiguous(), g.contiguous(), seed, plan,
                              0, layout, gamma=gamma, eta=eta)


def _padded_local_grads(cfg, proto, spec, remat: bool = False):
    """The flat gradient pass on a padded buffer: the unsharded pass on the
    canonical d columns (``protocol.make_flat_local_pass``), its clipped
    gradients padded with exact zeros (no parameter lives in a padding
    column). Takes any number of worker rows. The canonical columns are
    copied to a tensor of their own first, so the pass reads its leaves
    with the unsharded buffer's strides and alignment (a library's
    product may pick its algorithm by them) and its rounding is the
    unsharded pass's."""
    base = protocol_lib.make_flat_local_pass(cfg, proto, spec, remat=remat)
    d, pad = spec.d, spec.width - spec.d

    def local_grads(flat, batch):
        losses, g, gnorms = base(flat[..., :d].contiguous() if pad else flat,
                                 batch)
        if pad:
            g = torch.nn.functional.pad(g, (0, pad))
        return losses, g, gnorms

    return local_grads


def _gather_block_rows(flat_p, group, layout: ShardLayout, segs):
    """[L, S Wb, shard_width] (this rank's window of every worker) ->
    [L, Wb, padded_width] (its row block's whole rows): one
    ``all_to_all_single`` a chunk segment, each sending row block j's
    piece of the segment to rank j and receiving this block's piece of
    every window."""
    import torch.distributed as dist
    S, sw = layout.n_shards, layout.shard_width
    L, Wp, _ = flat_p.shape
    Wb = Wp // S
    rows = flat_p.new_empty((L, Wb, S * sw))
    for a, b in segs:
        send = (flat_p[:, :, a:b].reshape(L, S, Wb, b - a).transpose(0, 1)
                .contiguous())
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        for s in range(S):
            rows[:, :, s * sw + a:s * sw + b] = recv[s]
    return rows


def _scatter_grad_cols(g_rows, group, layout: ShardLayout, segs):
    """The reverse schedule: [L, Wb, padded_width] row-block gradients ->
    [L, S Wb, shard_width], every worker's gradient in this rank's window.
    The row blocks are disjoint, so no sum: pure data movement."""
    import torch.distributed as dist
    S, sw = layout.n_shards, layout.shard_width
    L, Wb, _ = g_rows.shape
    out = g_rows.new_empty((L, S * Wb, sw))
    for a, b in segs:
        send = torch.stack([g_rows[:, :, s * sw + a:s * sw + b]
                            for s in range(S)])
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        out[:, :, a:b] = recv.transpose(0, 1).reshape(L, S * Wb, b - a)
    return out


def _all_gather_rows(v, group, S: int):
    """[L, Wb] per rank -> [L, S Wb] in rank order."""
    from repro_torch.launch.mesh import gather_into
    L, Wb = v.shape
    out = v.new_empty((S * L, Wb))
    gather_into(out, v, group)
    return out.reshape(S, L, Wb).transpose(0, 1).reshape(L, S * Wb)


def _mesh_group(spec, mesh, axis: str):
    """The process group of ``mesh``'s ``axis``, checked against the
    spec's layout."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no {axis!r} axis: {names}")
    size = mesh.size(names.index(axis))
    if size != spec.layout.n_shards:
        raise ValueError(f"layout has {spec.layout.n_shards} shards but "
                         f"mesh {axis!r} axis has {size} ranks")
    return mesh.get_group(axis)


def _local_round_factory(cfg, proto, spec, *, dynamic: bool, group=None,
                         fleet: bool = False, device="cuda",
                         remat: bool = False):
    """The round over this rank's part of the buffer.

    group None: the logical mode, the whole padded buffer ([N, width], the
    fleet's [R, N, width]). A group: the mesh mode, this rank's window
    ([N, shard_width] / [R, N, shard_width]), the gather-free worker-split
    gradient pass (module docstring).

        run(flat, batch, seed, chan=None, W=None, generator=None,
            mask=None) -> (flat', metrics)

    The batch is the whole population's (every rank draws the same);
    dynamic rounds take the round's chan and W, static ones their sampled
    mask or a generator to draw it."""
    if spec.layout is None:
        raise ValueError("the sharded round needs a FlatSpec with a "
                         "ShardLayout (exchange.make_flat_spec(..., "
                         "n_shards=S))")
    layout = spec.layout
    dev = resolve_device(device)
    local_grads = _padded_local_grads(cfg, proto, spec, remat=remat)
    gamma, eta, N = proto.gamma, proto.eta, proto.n_workers
    mix = protocol_lib._flat_spec(proto, dynamic=dynamic)
    plan_of = (None if dynamic
               else protocol_lib._round_plan(proto, mix, dev))
    if group is not None:
        import torch.distributed as dist
        S, sw = layout.n_shards, layout.shard_width
        rank = dist.get_rank(group)
        col0 = rank * sw
        Wb = -(-N // S)
        segs = spec.chunk_plan.exec_segments()

    def grads(flat, batch):
        """(losses [L, N], g [L, N, w], gnorms [L, N]) of the [L, N, w]
        buffer; batch leaves [L, N, ...]."""
        L = flat.shape[0]
        if group is None:
            losses, g, gnorms = local_grads(flat.reshape(L * N, -1),
                                            protocol_lib._fold(batch, L, N))
            return (losses.reshape(L, N), g.reshape(L, N, -1),
                    gnorms.reshape(L, N))
        pad_rows = lambda t: torch.nn.functional.pad(
            t, (0, 0) * (t.ndim - 2) + (0, S * Wb - N))
        rows = _gather_block_rows(pad_rows(flat), group, layout, segs)
        block = exchange_lib.tree_map(
            lambda t: pad_rows(t)[:, rank * Wb:(rank + 1) * Wb], batch)
        losses_b, g_rows, gnorms_b = local_grads(
            rows.reshape(L * Wb, -1), protocol_lib._fold(block, L, Wb))
        g = _scatter_grad_cols(g_rows.reshape(L, Wb, -1), group, layout,
                               segs)[:, :N]
        return (_all_gather_rows(losses_b.reshape(L, Wb), group, S)[:, :N],
                g, _all_gather_rows(gnorms_b.reshape(L, Wb), group, S)[:, :N])

    def run(flat, batch, seed, chan=None, W=None, generator=None, mask=None):
        lead = not fleet
        f3 = flat.unsqueeze(0) if lead else flat
        b3 = (exchange_lib.tree_map(lambda t: t.unsqueeze(0), batch) if lead
              else batch)
        losses, g, gnorms = grads(f3, b3)
        if lead:
            g, losses, gnorms = g[0], losses[0], gnorms[0]
        if N < 2:
            flat = flat - gamma * g
        else:
            plan = (mix.plan(proto, chan, dev, W) if dynamic
                    else plan_of(generator, mask))
            if group is None:
                flat = dp_mix_round_sharded(flat, g, seed, plan, layout,
                                            gamma=gamma, eta=eta)
            else:
                flat = shard_window_round(flat, g.contiguous(), seed, plan,
                                          col0, layout, gamma=gamma, eta=eta)
        return flat, _metrics(losses, gnorms, flat)

    def _metrics(losses, gnorms, flat):
        # logical: the canonical columns, so param_norm is bitwise the
        # unsharded step's; mesh: the sum of every rank's window
        real = (flat if group is not None
                else flat[..., :layout.d].contiguous())
        if fleet:
            sq = torch.sum(real.float().reshape(real.shape[0], -1) ** 2,
                           dim=1)
            loss, gnorm = losses.mean(-1), gnorms.mean(-1)
        else:
            sq = torch.sum(real.float() ** 2)
            loss, gnorm = losses.mean(), gnorms.mean()
        if group is not None:
            import torch.distributed as dist
            dist.all_reduce(sq, group=group)
        return {"loss": loss, "grad_norm": gnorm,
                "param_norm": torch.sqrt(sq)}

    return run


def make_sharded_flat_train_step(cfg, proto, spec, mesh=None,
                                 axis: str = "model", device="cuda",
                                 remat: bool = False):
    """The sharded twin of ``protocol.make_flat_train_step`` (static
    channel):

        step(flat, batch, seed, generator=None, mask=None) -> (flat', metrics)

    ``flat``: the padded [N, spec.width] buffer (``mesh=None``, logical),
    or this rank's window [N, shard_width] of it (``mesh``'s ``axis``).
    Bitwise the unsharded step on the canonical columns."""
    group = None if mesh is None else _mesh_group(spec, mesh, axis)
    run = _local_round_factory(cfg, proto, spec, dynamic=False, group=group,
                               device=device, remat=remat)
    return lambda flat, batch, seed, generator=None, mask=None: run(
        flat, batch, seed, generator=generator, mask=mask)


def make_sharded_dynamic_flat_train_step(cfg, proto, spec, mesh=None,
                                         axis: str = "model", device="cuda",
                                         remat: bool = False):
    """The sharded twin of ``protocol.make_dynamic_flat_train_step``:

        step(flat, batch, seed, chan, W) -> (flat', metrics)

    chan and W are the round's (every rank builds the same plan and mixes
    its own columns)."""
    group = None if mesh is None else _mesh_group(spec, mesh, axis)
    run = _local_round_factory(cfg, proto, spec, dynamic=True, group=group,
                               device=device, remat=remat)
    return lambda flat, batch, seed, chan, W: run(flat, batch, seed, chan, W)


def make_fleet_sharded_step(cfg, proto, spec, mesh=None,
                            replicate_axis: str = "replicas",
                            axis: str = "model", device="cuda",
                            remat: bool = False):
    """The fleet's sharded round:

        step(flat, batch, seeds, chans, Ws) -> (flat', metrics)

    ``mesh=None``: the logical mode over the padded [R, N, width] buffer.
    A 2-D (``replicate_axis``, ``axis``) mesh: this rank's replicates and
    window, flat [R_loc, N, shard_width] and the R_loc replicates' batch
    [R_loc, N, ...], seeds, chans and Ws (``fleet.FleetEngine.
    make_fleet_round`` slices them). Replicates never communicate; the
    only collectives are the model axis's. Metrics [R_loc] each."""
    if spec.lead_axes != 2:
        raise ValueError("fleet sharding requires a lead_axes=2 FlatSpec "
                         "([R, N, d] buffer)")
    group = None
    if mesh is not None:
        group = _mesh_group(spec, mesh, axis)
        if replicate_axis not in tuple(mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh has no {replicate_axis!r} axis: "
                             f"{mesh.mesh_dim_names}")
    run = _local_round_factory(cfg, proto, spec, dynamic=True, group=group,
                               fleet=True, device=device, remat=remat)
    return lambda flat, batch, seeds, chans, Ws: run(flat, batch, seeds,
                                                     chans, Ws)


def local_window(flat, spec, mesh, axis: str = "model") -> torch.Tensor:
    """This rank's window [..., shard_width] of a padded buffer (the
    placement the mesh steps take)."""
    import torch.distributed as dist
    sw = spec.layout.shard_width
    r = dist.get_rank(_mesh_group(spec, mesh, axis))
    return flat[..., r * sw:(r + 1) * sw].contiguous()


def full_buffer(flat_loc, spec, mesh, axis: str = "model") -> torch.Tensor:
    """Every rank's window gathered back into the padded [..., width]
    buffer (for an eval or a checkpoint, never inside a round)."""
    from repro_torch.launch.mesh import gather_into
    S = spec.layout.n_shards
    parts = flat_loc.new_empty((S * flat_loc.shape[0],) + flat_loc.shape[1:])
    gather_into(parts, flat_loc, _mesh_group(spec, mesh, axis))
    return torch.cat(parts.chunk(S), dim=-1)
