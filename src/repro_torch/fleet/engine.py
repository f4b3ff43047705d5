"""FleetEngine — R independent networks in one round, the port of the
reference's ``repro.fleet.engine``.

The reference vmaps the dynamic round over a leading replicate axis. Here
the axis is written out: the stacked ``NetState`` ([R, ...] leaves) goes
through ``NetworkSimulator.round`` in one call, the R networks' plans
stack ([R, N, N] W, [R, N] vectors), the gradient pass takes the R N
workers as one batch, and the flat round's mix is one dp_mix launch for
all R (the kernel's replicate grid axis). So a fleet round costs about
the launches of one round, however large R is.

Replicates are independent through the generator's draws alone (fading,
placement, churn, data order, noise); the scenario, the worker count and
the protocol are shared — except the transmit power, which may be an [R]
vector (``power_dbm``: the paper's Fig. 2 power sweep in one round).
``n_shards > 1`` shards each replicate's buffer columns
(``shard.round``): logically on one device, or over a 2-D ("replicas",
"model") mesh (``launch.mesh.make_shard_mesh``). With
``sparse_neighbors`` > 0 each round's Ws are one stacked
``net.sparse.SparseW`` ([R, N, k] leaves, built in one simulator call),
and the flat round's mix is one ``dp_mix_prep`` and one ``dp_mix_gather``
launch for all R.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import exchange as exchange_lib
from repro_torch.core import protocol as protocol_lib
from repro_torch.core.channel import dbm_to_watts
from repro_torch.models import model as M
from repro_torch.net.simulator import NetState
from repro_torch.net.sparse import SparseW
from repro_torch.net.state import FIELDS, TracedChannelState
from repro_torch.runtime import resolve_device


def stack_rounds(rounds):
    """A list of rounds' [R, ...] tensors, SparseWs, TracedChannelStates or
    dicts of them, stacked along a NEW axis 1: the [R, T, ...] layout of
    ``privacy.epsilon_trajectory_batched`` (axis 0 stays the replicate
    axis, as ``FleetEngine.trajectory`` returns it)."""
    rounds = list(rounds)
    first = rounds[0]
    if torch.is_tensor(first):
        return torch.stack(rounds, dim=1)
    if isinstance(first, SparseW):
        return SparseW.join(rounds, lambda ts: torch.stack(ts, dim=1))
    if isinstance(first, TracedChannelState):
        return dataclasses.replace(first, **{
            f: torch.stack([getattr(r, f) for r in rounds], dim=1)
            for f in FIELDS})
    if isinstance(first, dict):
        return {k: stack_rounds([r[k] for r in rounds]) for k in first}
    raise TypeError(f"stack_rounds takes tensors, SparseWs, "
                    f"TracedChannelStates or dicts of them, got "
                    f"{type(first).__name__}")


def mean_ci(values, confidence_z: float = 1.96):
    """Across-replicate aggregate: (mean, half-width of the normal-approx
    95% CI of the mean). One replicate: CI 0 (no spread information)."""
    v = np.asarray(values, np.float64).reshape(-1)
    if v.size <= 1:
        return float(v.mean()), 0.0
    return (float(v.mean()),
            float(confidence_z * v.std(ddof=1) / np.sqrt(v.size)))


class FleetEngine:
    """R networks of one scenario and protocol, advanced together: every
    method takes and returns [R, ...] leaves.

    ``power_dbm``: None (every replicate at proto.p_dbm) or [R] transmit
    powers, one a replicate."""

    def __init__(self, proto: "protocol_lib.ProtocolConfig",
                 replicates: Optional[int] = None, *, power_dbm=None,
                 device="cuda"):
        if proto.channel_model != "dynamic":
            raise ValueError("FleetEngine requires channel_model='dynamic' "
                             "(the static channel is fixed for the whole "
                             "run — there is nothing to batch)")
        self.proto = proto
        self.replicates = int(replicates if replicates is not None
                              else proto.replicates)
        if self.replicates < 1:
            raise ValueError(f"replicates must be >= 1, got {self.replicates}")
        self.device = resolve_device(device)
        self.sim = proto.simulator(self.device)
        if power_dbm is None:
            self._P = None                      # shared proto.p_dbm
        else:
            p = np.asarray(power_dbm, np.float64).reshape(-1)
            if p.shape[0] != self.replicates:
                raise ValueError(f"power_dbm has {p.shape[0]} entries for "
                                 f"{self.replicates} replicates")
            # [R, 1] watts: each replicate's power over its N workers
            self._P = torch.as_tensor(dbm_to_watts(p), dtype=torch.float32,
                                      device=self.device).reshape(-1, 1)

    # -- the networks ([R, ...] leaves) -------------------------------------

    def init(self, generator: torch.Generator) -> NetState:
        """The stacked initial state, all R drawn at once."""
        return self.sim.init(generator, replicates=self.replicates)

    def round(self, generator: torch.Generator, states: NetState
              ) -> Tuple[NetState, TracedChannelState, torch.Tensor,
                         torch.Tensor]:
        """All R networks one round: (states', chans, masks, Ws) with
        leaves [R, ...], masks [R, N], Ws [R, N, N] (with
        ``sparse_neighbors``, a SparseW of [R, N, k] leaves); one simulator
        call."""
        return self.sim.round(generator, states, P=self._P)

    def trajectory(self, generator: torch.Generator, T: int,
                   states: Optional[NetState] = None
                   ) -> Tuple[TracedChannelState, torch.Tensor, torch.Tensor]:
        """R stacked T-round channel trajectories, replicate-major: ([R,
        T, ...] chans, [R, T, N] masks, [R, T, N, N] Ws or a SparseW of
        [R, T, N, k] leaves), the input of
        ``privacy.epsilon_trajectory_batched``."""
        if states is None:
            states = self.init(generator)
        chans, masks, Ws = [], [], []
        for _ in range(int(T)):
            states, chan, mask, W = self.round(generator, states)
            chans.append(chan)
            masks.append(mask)
            Ws.append(W)
        return stack_rounds(chans), stack_rounds(masks), stack_rounds(Ws)

    # -- the model ----------------------------------------------------------

    def init_worker_params(self, generator: torch.Generator, cfg):
        """[R, N, ...] parameters: replicate r's N workers share one init
        (the paper's common start), each replicate its own, drawn in
        replicate order."""
        inits = [M.init_params(generator, cfg, device=self.device)
                 for _ in range(self.replicates)]
        N = self.proto.n_workers
        return exchange_lib.tree_map(
            lambda *ls: torch.stack(ls)[:, None].expand(
                (len(ls), N) + tuple(ls[0].shape)).contiguous(), *inits)

    def init_flat_spec(self, generator: torch.Generator, cfg,
                       n_shards: int = 1, max_chunk_cols=None):
        """The fleet's flat buffer [R, N, width] float32 and its
        ``exchange.FlatSpec`` (lead axes 2), raveled once here;
        ``n_shards`` > 1 attaches a model-axis ``shard.ShardLayout`` (the
        buffer padded to its width; ``max_chunk_cols`` caps the sharded
        gradient pass's columns a collective)."""
        wp = self.init_worker_params(generator, cfg)
        spec = exchange_lib.make_flat_spec(wp, lead_axes=2, n_shards=n_shards,
                                           max_chunk_cols=max_chunk_cols)
        return spec.flatten(wp), spec

    def make_fleet_step(self, cfg, spec=None, mesh=None,
                        remat: bool = False):
        """The fleet's train step: with ``spec`` (init_flat_spec's) the
        flat round, ``protocol.make_fleet_flat_train_step`` (one dp_mix
        launch for all R); without, the worker-tree round,
        ``protocol.make_fleet_train_step``. A model-sharded spec runs
        ``shard.round.make_fleet_sharded_step``: logically without a mesh,
        or on a ("replicas", "model") ``mesh``, where the step takes this
        rank's replicates (``make_fleet_round`` slices them)."""
        if spec is not None and spec.layout is not None:
            from repro_torch.shard.round import make_fleet_sharded_step
            return make_fleet_sharded_step(cfg, self.proto, spec, mesh,
                                           device=self.device, remat=remat)
        if mesh is not None:
            raise ValueError("the fleet over a mesh shards a replicate's "
                             "columns: it needs a spec with n_shards "
                             "(init_flat_spec(..., n_shards=S))")
        if spec is not None:
            return protocol_lib.make_fleet_flat_train_step(
                cfg, self.proto, spec, self.device)
        return protocol_lib.make_fleet_train_step(cfg, self.proto,
                                                  self.device)

    def replicate_slice(self, mesh) -> slice:
        """This rank's replicates on ``mesh``'s "replicas" axis (all R
        without a mesh)."""
        if mesh is None:
            return slice(0, self.replicates)
        names = tuple(mesh.mesh_dim_names)
        n = mesh.size(names.index("replicas"))
        if self.replicates % n:
            raise ValueError(f"replicates={self.replicates} not divisible "
                             f"by the mesh's {n} replica groups")
        per = self.replicates // n
        r = mesh.get_local_rank("replicas")
        return slice(r * per, (r + 1) * per)

    def make_fleet_round(self, cfg, spec=None, mesh=None,
                         remat: bool = False):
        """The networks' round and the train step in one call:

            fleet_round(generator, states, worker_params, batch, out=None)
                -> (states', worker_params', metrics, chans, Ws)

        After the caller's batch it draws, from ``generator``, the
        networks' round, then the R noise seeds (flat) or the exchange's
        normals (tree) — the order of the trajectory's fleet body. On a
        mesh every rank draws all R networks alike; the step takes this
        rank's replicates (``replicate_slice``; ``worker_params`` is this
        rank's [R_loc, N, shard_width]) and the metrics come back [R],
        gathered over the "replicas" axis. ``out``: the tensor the flat
        step writes its new buffer into (a neighbor-list round without a
        mesh, which ``fleet_round.writes_into`` declares;
        ``protocol.make_fleet_flat_train_step``)."""
        from repro_torch.core.trajectory import round_seed
        step = self.make_fleet_step(cfg, spec=spec, mesh=mesh, remat=remat)
        R = self.replicates
        mine = self.replicate_slice(mesh)

        def fleet_round(generator, states, worker_params, batch, out=None):
            states, chans, _, Ws = self.round(generator, states)
            noise = round_seed(generator, R) if spec is not None else generator
            if mesh is None:
                worker_params, metrics = step(
                    worker_params, batch, noise, chans, Ws,
                    **({} if out is None else {"out": out}))
                return states, worker_params, metrics, chans, Ws
            local = lambda t: t[mine]
            worker_params, metrics = step(
                worker_params, exchange_lib.tree_map(local, batch),
                noise[mine], dataclasses.replace(chans, **{
                    f: getattr(chans, f)[mine] for f in FIELDS}), Ws[mine])
            return (states, worker_params,
                    {k: _gather_replicas(v, mesh) for k, v in
                     metrics.items()}, chans, Ws)

        fleet_round.writes_into = (mesh is None
                                   and getattr(step, "writes_into", False))
        return fleet_round


def _gather_replicas(v, mesh) -> torch.Tensor:
    """[R_loc] per replica group -> [R] over ``mesh``'s "replicas" axis."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import gather_into
    group = mesh.get_group("replicas")
    out = v.new_empty((dist.get_world_size(group) * v.shape[0],))
    gather_into(out, v, group)
    return out


def fleet_eval(evaluate, worker_params, batch):
    """Per replicate (loss [R], accuracy [R]) of ``protocol.make_eval_fn``
    over [R, N, ...] parameters and an [R, N, B, ...] batch."""
    leaves, _ = exchange_lib.tree_flatten(worker_params)
    out = [evaluate(exchange_lib.tree_map(lambda l: l[r], worker_params),
                    {k: v[r] for k, v in batch.items()})
           for r in range(leaves[0].shape[0])]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))


def fleet_round_telemetry(proto, chans, Ws=None, spec=None) -> dict:
    """The channel telemetry columns over a stacked fleet log (``chans``/
    ``Ws`` leaves [R, T, ...]; Ws dense or a SparseW of [R, T, N, k]
    leaves): {name: [R, T]} for every enabled channel
    scalar, and the per-round epsilon when the spec keeps it — the same
    formulas the trajectory's telemetry evaluates, from the logged
    channels."""
    from repro_torch.obs import telemetry as tele_lib
    spec = spec if spec is not None else tele_lib.TelemetrySpec()
    vals = tele_lib.channel_scalars(spec, chans, Ws)
    if spec.epsilon:
        vals["epsilon"] = tele_lib.epsilon_round(proto, chans, Ws)
    return vals


def fleet_epsilon_report(proto, chans, Ws=None) -> dict:
    """The replicated privacy report: Theorem 4.1 on every round of every
    replicate ([R, T, N] in one evaluation), the worst receiver a round,
    heterogeneous composition per replicate, both accountants per
    replicate at the same total delta, and across-replicate means and
    CIs. ``chans`` leaves are [R, T, ...] (``FleetEngine.trajectory``,
    ``stack_rounds`` or ``trajectory.replicate_major`` of a fleet log);
    ``Ws`` [R, T, N, N] or a SparseW of [R, T, N, k] leaves."""
    from repro_torch.core import accounting, privacy
    eps_rtn = privacy.epsilon_trajectory_batched(
        proto.gamma, proto.clip, chans, proto.delta, Ws).cpu().numpy()
    per_round = eps_rtn.max(axis=2)                            # [R, T]
    eps_c, delta_c = privacy.compose_heterogeneous_batched(
        per_round, proto.delta)                                # [R], [R]
    mean, ci = mean_ci(eps_c)
    both = accounting.compose_trajectory(per_round, proto.delta,
                                         delta_ref=proto.delta)
    adv_mean, adv_ci = mean_ci(both["epsilon_advanced"])
    rdp_mean, rdp_ci = mean_ci(both["epsilon_rdp"])
    tot_mean, tot_ci = mean_ci(both["epsilon"])
    return {
        "replicates": int(eps_rtn.shape[0]),
        "rounds": int(eps_rtn.shape[1]),
        "epsilon_per_round": per_round,
        "epsilon_worst": float(per_round.max()),
        "epsilon_composed_per_replicate": eps_c,
        "delta_composed": float(delta_c.reshape(-1)[0]),
        "epsilon_composed_mean": mean,
        "epsilon_composed_ci95": ci,
        "epsilon_advanced_per_replicate": both["epsilon_advanced"],
        "epsilon_rdp_per_replicate": both["epsilon_rdp"],
        "epsilon_total_per_replicate": both["epsilon"],
        "epsilon_advanced_mean": adv_mean,
        "epsilon_advanced_ci95": adv_ci,
        "epsilon_rdp_mean": rdp_mean,
        "epsilon_rdp_ci95": rdp_ci,
        "epsilon_total_mean": tot_mean,
        "epsilon_total_ci95": tot_ci,
        "accountant_gap": float(np.mean(both["gap_ratio"])),
        "delta_total": float(both["delta"]),
        "accountant": proto.accountant,
        "saturated": bool(np.any(both["saturated"])),
    }
