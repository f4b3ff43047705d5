"""The port's sharding rules (``repro_torch.launch.shardings``) against
the reference's (``repro.launch.shardings``), leaf for leaf, on the
single-pod (16, 16) and two-pod (2, 16, 16) meshes, for every arch:
``param_specs`` of the serving tree and of the worker-stacked tree,
``cache_specs`` of the decode cache at both shapes' batches, and
``batch_specs``; and ``per_device_bytes`` against a hand count. Specs
are compared exactly."""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.configs.registry import get_arch as ref_arch  # noqa: E402
from repro.core.protocol import init_worker_params as ref_init_workers  # noqa: E402
from repro.launch import shardings as ref_sh  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import protocol as P  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

OV = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


class _Mesh(AbstractMesh):
    @property
    def devices(self):
        return types.SimpleNamespace(shape=self.axis_sizes,
                                     size=int(np.prod(self.axis_sizes)))


def _ref_specs(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = tuple(leaf)
    return out


def _same(ref_tree, port_tree):
    want = _ref_specs(ref_tree)
    got = dict(sh.leaves_with_path(port_tree))
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for k, v in want.items():
        assert got[k] == v, (k, got[k], v)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_cache_and_batch_specs_match(arch, multi_pod):
    m = mesh_lib.production_mesh_shape(multi_pod)
    rmesh = _Mesh(m.sizes, m.axis_names)
    waxes = mesh_lib.worker_axes(multi_pod)
    rcfg = ref_arch(arch).replace(**OV)
    cfg = get_arch(arch).replace(**OV)
    key = jax.random.PRNGKey(0)
    # serving tree
    rp = jax.eval_shape(lambda k: RM.init_params(k, rcfg), key)
    p = M.init_params(torch.Generator(), cfg, "meta")
    _same(ref_sh.param_specs(rp, mesh=rmesh), sh.param_specs(p, mesh=m))
    # worker-stacked tree, 4 workers (the rules skip the worker dim)
    rw = jax.eval_shape(lambda k: ref_init_workers(k, rcfg, 4), key)
    w = P.init_worker_params(torch.Generator(), cfg, 4, "meta")
    _same(ref_sh.param_specs(rw, mesh=rmesh, worker_axes=waxes),
          sh.param_specs(w, mesh=m, worker_axes=waxes))
    # decode caches at the decode shapes' batches
    for B, S in ((128, 64), (1, 64)):
        rc = jax.eval_shape(lambda: RM.init_cache(rcfg, B, S))
        c = M.init_cache(cfg, B, S, "meta")
        dax = waxes if B >= mesh_lib.n_workers(m) else ()
        _same(ref_sh.cache_specs(rc, mesh=rmesh, data_axes=dax, batch_size=B),
              sh.cache_specs(c, mesh=m, data_axes=dax, batch_size=B))
    # batches: worker-stacked and serving
    for shape in ((16, 16, 128), (32, 128), (8, 128)):
        rb = {"tokens": jax.ShapeDtypeStruct(shape, np.int32)}
        b = {"tokens": torch.empty(shape, dtype=torch.int32, device="meta")}
        for kw in (dict(worker_axes=waxes), dict(data_axes=waxes), {}):
            _same(ref_sh.batch_specs(rb, mesh=rmesh, **kw),
                  sh.batch_specs(b, mesh=m, **kw))


def test_per_device_bytes_by_hand():
    """A [16, 4096, 1024] bfloat16 leaf over ("data", None, "model") on the
    (16, 16) mesh: 1 x 4096 x 64 x 2 bytes a device; a replicated float32
    [3, 5] adds 60; an int32 [10] over "model" is ceil(10 / 16) = 1 element,
    4 bytes."""
    m = mesh_lib.production_mesh_shape(False)
    tree = {"a": torch.empty(16, 4096, 1024, dtype=torch.bfloat16,
                             device="meta"),
            "b": [torch.empty(3, 5, device="meta"),
                  torch.empty(10, dtype=torch.int32, device="meta")],
            "none": None}
    specs = {"a": ("data", None, "model"), "b": [(None, None), ("model",)],
             "none": None}
    assert sh.per_device_bytes(tree, specs, m) == 4096 * 64 * 2 + 60 + 4
    m2 = mesh_lib.production_mesh_shape(True)
    specs2 = {"a": (("pod", "data"), None, "model"),
              "b": [(None, None), (None,)], "none": None}
    assert sh.per_device_bytes(tree, specs2, m2) == \
        1 * 4096 * 64 * 2 + 60 + 40


def test_flat_buffer_sharding_matches_the_layout():
    """The flat buffer's columns go over "model" exactly when its spec
    carries a ShardLayout of more than one window; the fleet's replicate
    axis leads."""
    from repro_torch.core import exchange as X
    wp = {"w": torch.zeros(4, 300)}
    assert sh.flat_buffer_sharding(X.make_flat_spec(wp)) == (None, None)
    spec2 = X.make_flat_spec(wp, n_shards=2)
    assert sh.flat_buffer_sharding(spec2) == (None, "model")
    fleet = X.make_flat_spec({"w": torch.zeros(2, 4, 300)}, lead_axes=2,
                             n_shards=2)
    assert sh.flat_buffer_sharding(fleet, "replicas") == \
        ("replicas", None, "model")


def test_mesh_shapes_and_axes():
    m1, m2 = (mesh_lib.production_mesh_shape(False),
              mesh_lib.production_mesh_shape(True))
    assert (mesh_lib.n_workers(m1), mesh_lib.model_size(m1),
            mesh_lib.n_chips(m1)) == (16, 16, 256)
    assert (mesh_lib.n_workers(m2), mesh_lib.model_size(m2),
            mesh_lib.n_chips(m2)) == (32, 16, 512)
    assert mesh_lib.worker_axes(True) == ("pod", "data")
    assert mesh_lib.axis_sizes(_Mesh((2, 3), ("data", "model"))) == \
        {"data": 2, "model": 3}
