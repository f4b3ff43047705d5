"""The port's dry-run cases (``repro_torch.launch.specs.build_case``)
against the reference's (``repro.launch.specs.build_case``), which still
builds every case through ``jax.eval_shape`` on an abstract mesh.

For every (arch x shape) pair on the single-pod (16, 16) mesh, and for
one pair of each kind on the two-pod mesh: ``n_params``, ``tokens`` and
``kind`` equal, ``model_flops`` within rel 1e-12, and every argument
leaf's shape and dtype equal, and its placement the reference's
``PartitionSpec``; the decode step's ``idx`` too, an int32 0-d tensor,
replicated. The train step's key has no tensor counterpart (a
``torch.Generator`` in the port) and is left out.
"""
from __future__ import annotations

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs.registry import ASSIGNED, SHAPES  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch import specs  # noqa: E402

MODEL_FLOPS_RTOL = 1e-12


class _Mesh(AbstractMesh):
    """An abstract mesh that the reference's rules read as a real one."""

    @property
    def devices(self):
        return types.SimpleNamespace(shape=self.axis_sizes,
                                     size=int(np.prod(self.axis_sizes)))


def ref_mesh(multi_pod: bool):
    m = mesh_lib.production_mesh_shape(multi_pod)
    return _Mesh(m.sizes, m.axis_names)


def _ref_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = leaf
    return out


def _dtype(x) -> str:
    return str(x.dtype).split(".")[-1]


def _check_args(ref_case, case):
    n = 4 if case.kind == "decode" else 2
    for i in range(n):
        want = _ref_leaves(ref_case.args[i])
        got = dict(sh.leaves_with_path(case.args[i]))
        spec = dict(sh.leaves_with_path(case.arg_specs[i]))
        assert sorted(got) == sorted(want), (i, sorted(set(got) ^ set(want)))
        for path, leaf in want.items():
            assert tuple(got[path].shape) == tuple(leaf.shape), (i, path)
            assert _dtype(got[path]) == _dtype(leaf), (i, path)
            assert spec[path] == tuple(leaf.sharding.spec) + (None,) * (
                leaf.ndim - len(leaf.sharding.spec)), (i, path)


def _compare(arch: str, shape: str, multi_pod: bool):
    ref = ref_specs.build_case(arch, shape, ref_mesh(multi_pod),
                               multi_pod=multi_pod)
    case = specs.build_case(arch, shape,
                            mesh_lib.production_mesh_shape(multi_pod),
                            "meta", multi_pod=multi_pod)
    assert case.n_params == ref.n_params
    assert case.tokens == ref.tokens
    assert case.kind == ref.kind
    assert case.model_flops == pytest.approx(ref.model_flops,
                                             rel=MODEL_FLOPS_RTOL)
    _check_args(ref, case)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_every_pair_matches_the_reference_single_pod(arch):
    for shape in SHAPES:
        _compare(arch, shape, multi_pod=False)


@pytest.mark.parametrize("arch,shape", [
    ("olmo-1b", "train_4k"), ("zamba2-7b", "prefill_32k"),
    ("deepseek-moe-16b", "decode_32k"), ("whisper-medium", "train_4k"),
    ("xlstm-1.3b", "long_500k")])
def test_two_pod_cases_match_the_reference(arch, shape):
    _compare(arch, shape, multi_pod=True)


def test_active_fraction_and_counts_match_the_reference():
    """``active_param_fraction`` of every arch at its own parameter count."""
    from repro.configs.registry import get_arch as ref_arch
    from repro_torch.configs.registry import get_arch
    for arch in ASSIGNED:
        n = 16_375_728_128
        assert specs.active_param_fraction(get_arch(arch), n) == \
            ref_specs.active_param_fraction(ref_arch(arch), n)


def test_overrides_give_smaller_rounds_of_the_same_shapes():
    """``workers`` and ``seq_len`` change W and S and keep the mesh's
    batch a worker (the dry run's fits)."""
    case = specs.build_case("olmo-1b", "train_4k", workers=3, seq_len=256)
    batch = case.args[1]["tokens"]
    assert tuple(batch.shape) == (3, 256 // 16, 256)
    assert case.seq_len == 256
    leaves = sh.leaves_with_path(case.args[0])
    assert all(leaf.shape[0] == 3 for _, leaf in leaves)
