"""The port's flash attention on the CPU (``repro_torch.kernels.
flash_attention``: ``flash_attention_plain`` and the ``ops.flash_attention``
wrapper, which takes the plain version for a CPU tensor) against the
reference: its exact oracle ``attention_ref`` with k and v repeated over
the GQA group, at the cases of tests/test_kernels.py::
test_flash_attention_sweep and the reference's tolerances (2e-5 float32,
2e-2 bfloat16), and its Pallas kernel in interpret mode at two small cases.
Inputs come from numpy and go to both packages.

The kernel itself runs only on a card: tests/test_torch_cuda.py holds it
against the plain version there. chip_smoke.py's count of the work and
bound of each route is checked here too.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.kernels.flash_attention import ops as ref_fa_ops
from repro.kernels.flash_attention import ref as ref_fa
from repro.models import layers as RL
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_plain
from repro_torch.models import layers as L

_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)

SWEEP = [
    (2, 256, 4, 2, 64, None),
    (1, 256, 4, 1, 64, 96),     # MQA + sliding window
    (2, 128, 2, 2, 32, None),
    (1, 512, 8, 4, 64, None),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, Hkv, hd, jdt, tdt, seed=0):
    """The same q, k, v for both packages (numpy float32, cast by each)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, n, hd), dtype=np.float32)
            for n in (H, Hkv, Hkv)]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.tensor(a).to(tdt) for a in arrs])


def _ref(jq, jk, jv, win):
    G = jq.shape[2] // jk.shape[2]
    return np.asarray(ref_fa.attention_ref(jq, jnp.repeat(jk, G, 2),
                                           jnp.repeat(jv, G, 2), causal=True,
                                           sliding_window=win), np.float32)


@pytest.mark.parametrize("impl", ["plain", "ops"])
@pytest.mark.parametrize("B,S,H,Hkv,hd,win", SWEEP)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_sweep(B, S, H, Hkv, hd, win, dtype, impl):
    jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (q, k, v) = _inputs(B, S, H, Hkv, hd, jdt, tdt)
    fn = flash_attention_plain if impl == "plain" else ops.flash_attention
    got = fn(q, k, v, causal=True, sliding_window=win)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), _ref(jq, jk, jv, win),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,Hkv,hd,win", [(1, 128, 2, 1, 32, None),
                                              (1, 128, 4, 2, 64, 40)])
def test_plain_matches_reference_interpret_kernel(B, S, H, Hkv, hd, win):
    """The reference's Pallas kernel in interpret mode (64-row blocks, so
    the window skips whole blocks) against the port's plain version."""
    (jq, jk, jv), (q, k, v) = _inputs(B, S, H, Hkv, hd, jnp.float32,
                                      torch.float32, seed=1)
    want = np.asarray(ref_fa_ops.flash_attention(
        jq, jk, jv, causal=True, sliding_window=win, block_q=64, block_k=64))
    got = ops.flash_attention(q, k, v, causal=True, sliding_window=win)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("win", [None, 30])
def test_ragged_sequence(win):
    """S = 100 is not a multiple of any tile: every row still sees exactly
    its causal (and window) keys."""
    (jq, jk, jv), (q, k, v) = _inputs(2, 100, 4, 2, 32, jnp.float32,
                                      torch.float32, seed=2)
    got = ops.flash_attention(q, k, v, causal=True, sliding_window=win)
    np.testing.assert_allclose(got.numpy(), _ref(jq, jk, jv, win),
                               rtol=2e-5, atol=2e-5)


def test_noncausal_matches_full_softmax():
    (_, _, _), (q, k, v) = _inputs(1, 40, 2, 1, 32, jnp.float32, torch.float32)
    got = ops.flash_attention(q, k, v, causal=False)
    kr, vr = (t.repeat_interleave(2, dim=2) for t in (k, v))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, kr) / 32 ** 0.5, -1)
    want = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_attention_matches_model_layer():
    """The port's counterpart of the reference's test of the same name:
    glm4-9b reduced, attention_apply with and without use_pallas, from the
    reference's parameters and inputs; and both against the reference's
    layer (tolerance 2e-4, the reference's)."""
    ref_cfg = ref_get_arch("glm4-9b").reduced(num_layers=1)
    cfg = get_arch("glm4-9b").reduced(num_layers=1)
    key = jax.random.PRNGKey(0)
    jp = RL.attention_init(key, ref_cfg, jnp.float32)
    x = np.asarray(jax.random.normal(key, (2, 256, cfg.d_model)) * 0.1)
    jpos = jnp.arange(256)[None].repeat(2, 0)
    want, _ = RL.attention_apply(jp, jnp.asarray(x), ref_cfg, jpos,
                                 mode="train", use_pallas=False)
    p = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    pos = torch.arange(256)[None].expand(2, 256)
    y1, _ = L.attention_apply(p, torch.tensor(x), cfg, pos, mode="train",
                              use_pallas=False)
    y2, _ = L.attention_apply(p, torch.tensor(x), cfg, pos, mode="train",
                              use_pallas=True)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(y2.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def _attention_params():
    """Attention parameters of gemma-2b reduced at d_model 64 (4 heads of
    64 over 1 KV head), as numpy arrays."""
    rng = np.random.default_rng(3)
    return {"wq": rng.standard_normal((64, 256), dtype=np.float32) * 0.1,
            "wk": rng.standard_normal((64, 64), dtype=np.float32) * 0.1,
            "wv": rng.standard_normal((64, 64), dtype=np.float32) * 0.1,
            "wo": rng.standard_normal((256, 64), dtype=np.float32) * 0.1}


def test_cpu_path_does_not_count_launches():
    """The CPU path runs the plain version and counts no launch, called
    directly or from the model's layer with use_pallas=True."""
    before = ops.flash_attention.launches
    (_, _, _), (q, k, v) = _inputs(1, 64, 2, 1, 64, jnp.float32, torch.float32)
    ops.flash_attention(q, k, v)
    cfg = get_arch("gemma-2b").reduced(d_model=64)
    y, cache = L.attention_apply(lm_params_from_jax(_attention_params(), "cpu"),
                                 torch.zeros((1, 8, 64)), cfg,
                                 torch.arange(8)[None], mode="prefill",
                                 use_pallas=True)
    assert y.shape == (1, 8, 64) and cache["k"].shape == (1, 8, 1, 64)
    assert ops.flash_attention.launches == before


@pytest.mark.parametrize("shapes,match", [
    (((1, 16, 6, 64), (1, 16, 4, 64)), "multiple"),   # H % Hkv != 0
    (((1, 16, 4, 48), (1, 16, 2, 48)), "head_dim"),   # hd not in HEAD_DIMS
    (((1, 16, 4, 64), (1, 8, 2, 64)), "match"),       # k's S differs
])
def test_wrapper_refuses_what_the_kernel_does_not_take(shapes, match):
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, k)
    with pytest.raises(TypeError):
        ops.flash_attention(torch.zeros((1, 16, 4, 64), dtype=torch.float64),
                            torch.zeros((1, 16, 2, 64), dtype=torch.float64),
                            torch.zeros((1, 16, 2, 64), dtype=torch.float64))


@pytest.mark.parametrize("S,window", [(1024, None), (300, None), (1024, 200),
                                      (77, 1), (130, 41), (64, 500)])
def test_kept_pairs_counts_the_mask(S, window):
    qpos, kpos = torch.arange(S)[:, None], torch.arange(S)[None, :]
    keep = kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    assert chip_smoke.kept_pairs(S, window) == int(keep.sum())


@pytest.mark.parametrize("shape,dtype,bound_ms,by,route_ms", [
    ((4, 1024, 8, 1, 256), torch.float32, 0.0347, "operations", 0.1042),
    ((4, 1024, 8, 1, 256), torch.bfloat16, 0.0174, "operations", 0.0261),
    ((4, 1024, 16, 16, 128), torch.float32, 0.0401, "bytes", 0.1042),
    ((4, 1024, 16, 16, 128), torch.bfloat16, 0.0200, "bytes", 0.0261),
], ids=["gemma-f32", "gemma-bf16", "olmo-f32", "olmo-bf16"])
def test_work_gives_each_route_its_bound(shape, dtype, bound_ms, by, route_ms):
    """The bound chip_smoke.py checks for each instantiation: 17.2 GFLOP
    over 495 TFLOP/s (split TF32) or 989 (bfloat16), or the bytes over 3.35
    TB/s where longer; the route's own products 3 or 1.5 times the
    function's."""
    w = chip_smoke.flash_work(*shape, torch.empty((), dtype=dtype).element_size())
    assert w.flops == 4 * shape[-1] * chip_smoke.kept_pairs(shape[1]) * shape[0] * shape[2]
    assert w.bound_by == by
    assert abs(1e3 * w.bound_s / bound_ms - 1) < 2e-3
    assert abs(1e3 * w.kernel_flops / w.rate / route_ms - 1) < 2e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_readable_asks_for_16_byte_rows(dtype):
    """ops._readable: what the kernel reads through strides as it is (the
    head_dim axis contiguous, the base and the strides 16-byte multiples);
    anything else is copied first."""
    B, S, H, Hkv, hd = 2, 16, 4, 2, 64
    qkv = torch.zeros((B, S, (H + 2 * Hkv) * hd), dtype=dtype)
    q = qkv[..., :H * hd].unflatten(-1, (H, hd))
    assert ops._readable(q) and ops._readable(torch.zeros(B, S, H, hd, dtype=dtype))
    assert not ops._readable(torch.zeros(B, S, hd, H, dtype=dtype).transpose(-1, -2))
    shifted = torch.zeros(1 + B * S * H * hd, dtype=dtype)[1:].view(B, S, H, hd)
    assert not ops._readable(shifted)
    odd_rows = torch.zeros((B, S, H * hd + 2), dtype=dtype)[..., :H * hd].unflatten(-1, (H, hd))
    assert not ops._readable(odd_rows)


def test_argtypes_follow_the_c_entry():
    """One ARGTYPES entry per parameter of flash_attention_launch, of the
    C parameter's kind (pointer, long long, int, float)."""
    import ctypes
    import re
    text = (ops._CSRC / "flash_attention.cu").read_text()
    sig = re.search(r"flash_attention_launch\(([^)]*)\)\s*\{", text).group(1)
    params = [" ".join(a.split()[:-1]) for a in sig.split(",")]
    assert len(params) == len(ops.ARGTYPES)
    for c_type, py in zip(params, ops.ARGTYPES):
        want = (ctypes.c_void_p if "*" in c_type else
                ctypes.c_longlong if "long long" in c_type else
                ctypes.c_float if "float" in c_type else ctypes.c_int)
        assert py is want, (c_type, py)
