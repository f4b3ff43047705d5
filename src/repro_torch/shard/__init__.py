"""repro_torch.shard — sharding of the persistent flat DWFL buffer, the
port of the reference's ``repro.shard``: over its columns (the model
axis, ``shard.round``) and over its worker rows (``shard.worker``).

``ShardLayout`` (``shard.layout``) is the pure geometry; the sharded
round and step factories are re-exported lazily (``shard.round`` imports
the protocol and the kernels, and ``exchange.FlatSpec`` imports this
package's layout: an eager re-export would cycle).
"""
from repro_torch.shard.layout import (LANES, Chunk, ChunkPlan, ShardLayout,
                                      plan_chunks)

_ROUND_EXPORTS = (
    "dp_mix_round_sharded",
    "full_buffer",
    "local_window",
    "make_fleet_sharded_step",
    "make_sharded_dynamic_flat_train_step",
    "make_sharded_flat_train_step",
    "shard_window_round",
)

_WORKER_EXPORTS = (
    "full_rows",
    "local_rows",
    "make_worker_sharded_dynamic_flat_train_step",
    "worker_window_round",
)

__all__ = ["LANES", "Chunk", "ChunkPlan", "ShardLayout", "plan_chunks",
           *_ROUND_EXPORTS, *_WORKER_EXPORTS]


def __getattr__(name):
    if name in _ROUND_EXPORTS:
        from repro_torch.shard import round as _round
        return getattr(_round, name)
    if name in _WORKER_EXPORTS:
        from repro_torch.shard import worker as _worker
        return getattr(_worker, name)
    raise AttributeError(f"module 'repro_torch.shard' has no attribute "
                         f"{name!r}")
