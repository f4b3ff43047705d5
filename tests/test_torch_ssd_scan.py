"""The port's SSD scan on the CPU (``repro_torch.kernels.ssd_scan``: the
plain intra-chunk step ``ssd_intra_chunk_plain``, the ``ops`` wrappers,
which take the plain version for a CPU tensor, and ``models.ssm``'s
``ssd_chunked`` and ``ssd_decode_step``) against the reference: its Pallas
kernel ``ssd_intra_chunk`` in interpret mode, its wrapper ``ops.ssd_scan``
and its oracle ``models.ssm.ssd_chunked``, at the shapes of
tests/test_kernels.py::test_ssd_scan_sweep plus H < 8 with S equal to the
chunk, and chunk 256 with N = 128. Inputs come from numpy with a seed, drawn
as the reference's sweep draws them, and go to both packages.

Tolerance: the reference's own for its kernel against its oracle, rtol
1e-4 / atol 1e-5 (test_kernels.py); a bfloat16 y one bfloat16 step (2^-7
of its magnitude) further. The port's cumulative sum takes the reference's
float32 order and is checked bitwise.

The kernel itself runs only on a card: tests/test_torch_cuda.py holds it
against the plain version there. chip_smoke.py's count of the step's work
and bound is checked here against the tensors the step reads and writes.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as ref_ops
from repro.kernels.ssd_scan import ssd_scan as ref_kernel
from repro.models import ssm as RS
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ssd_scan import cumsum_f32, ssd_intra_chunk_plain
from repro_torch.models import ssm as S

_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)

# (B, S, H, P, N, chunk): the reference's sweep, H < 8 with S equal to the
# chunk, chunk 256 with N = 128
SWEEP = [
    (2, 128, 8, 16, 16, 32),
    (1, 256, 16, 32, 64, 64),
    (2, 64, 8, 64, 64, 32),
    (1, 96, 4, 16, 32, 96),
    (1, 512, 8, 32, 128, 256),
]
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S_, H, P, N, seed=0):
    """x, dt, A, Bm, Cm as numpy float32 (the reference sweep's scales)."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((B, S_, H, P))).astype(np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((B, S_, H))).astype(np.float32)
    A = (-np.exp(0.3 * rng.standard_normal(H))).astype(np.float32)
    Bm = (0.3 * rng.standard_normal((B, S_, N))).astype(np.float32)
    Cm = (0.3 * rng.standard_normal((B, S_, N))).astype(np.float32)
    return x, dt, A, Bm, Cm


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [1, 16, 24, 32, 100, 128, 200, 256])
def test_cumsum_is_the_references_bitwise(n):
    a = (-np.logaddexp(0.0, np.random.default_rng(n).standard_normal((3, n, 5)))
         * 1.7).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(a), axis=1))
    assert np.array_equal(cumsum_f32(torch.tensor(a), 1).numpy(), want)
    want1 = np.asarray(jnp.cumsum(jnp.asarray(a[0, :, 0])))
    assert np.array_equal(cumsum_f32(torch.tensor(a[0, :, 0]), 0).numpy(), want1)


@pytest.mark.parametrize("shape", SWEEP)
def test_plain_intra_chunk_matches_reference_kernel(shape):
    """The plain step against the reference's Pallas kernel (interpret
    mode) on y_diag, the chunk states ([B,nc,H,P,N]) and decays."""
    B, S_, H, P, N, chunk = shape
    x, dt, A, Bm, Cm = _inputs(B, S_, H, P, N)
    dA = dt * A[None, None, :]
    want = ref_kernel.ssd_intra_chunk(*map(jnp.asarray, (x, dt, dA, Bm, Cm)),
                                      chunk=chunk, interpret=True)
    got = ssd_intra_chunk_plain(*map(torch.tensor, (x, dt, dA, Bm, Cm)),
                                chunk=chunk)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w)


def test_plain_intra_chunk_bfloat16_matches_reference_kernel():
    B, S_, H, P, N, chunk = SWEEP[1]
    x, dt, A, Bm, Cm = _inputs(B, S_, H, P, N, seed=1)
    dA = dt * A[None, None, :]
    j16 = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    t16 = lambda a: torch.tensor(a).to(torch.bfloat16)
    want = ref_kernel.ssd_intra_chunk(j16(x), jnp.asarray(dt), jnp.asarray(dA),
                                      j16(Bm), j16(Cm), chunk=chunk, interpret=True)
    got = ssd_intra_chunk_plain(t16(x), torch.tensor(dt), torch.tensor(dA),
                                t16(Bm), t16(Cm), chunk=chunk)
    assert got[0].dtype == torch.bfloat16
    y, w = got[0].float().numpy(), np.asarray(want[0], np.float32)
    step = 2.0 ** -7 * np.maximum(np.abs(y), np.abs(w))
    assert (np.abs(y - w) <= ATOL + RTOL * np.abs(w) + step).all()
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)


@pytest.mark.parametrize("shape", SWEEP)
def test_scan_matches_reference(shape):
    """ops.ssd_scan (the plain step, the recurrence over the chunks and the
    off-diagonal term) and ssd_chunked against the reference's ops.ssd_scan
    and its oracle ssd_chunked."""
    B, S_, H, P, N, chunk = shape
    arrs = _inputs(B, S_, H, P, N)
    jy, js = ref_ops.ssd_scan(*map(jnp.asarray, arrs), chunk=chunk)
    oy, os_ = RS.ssd_chunked(*map(jnp.asarray, arrs), chunk=chunk)
    y, st = ops.ssd_scan(*map(torch.tensor, arrs), chunk=chunk)
    cy, cst = S.ssd_chunked(*map(torch.tensor, arrs), chunk=chunk)
    assert y.shape == (B, S_, H, P) and st.shape == (B, H, P, N)
    for got, want in ((y, jy), (y, oy), (cy, oy), (cy, jy)):
        _close(got, want)
    for got, want in ((st, js), (st, os_), (cst, os_)):
        _close(got, want)


def test_scan_with_an_initial_state():
    B, S_, H, P, N, chunk = SWEEP[0]
    arrs = _inputs(B, S_, H, P, N, seed=2)
    h0 = (0.1 * np.random.default_rng(3).standard_normal((B, H, P, N))).astype(np.float32)
    jy, js = ref_ops.ssd_scan(*map(jnp.asarray, arrs), chunk=chunk,
                              initial_state=jnp.asarray(h0))
    y, st = ops.ssd_scan(*map(torch.tensor, arrs), chunk=chunk,
                         initial_state=torch.tensor(h0))
    _close(y, jy)
    _close(st, js)
    cy, cst = S.ssd_chunked(*map(torch.tensor, arrs), chunk=chunk,
                            initial_state=torch.tensor(h0))
    _close(cy, jy)
    _close(cst, js)


def test_chunk_is_clamped_to_the_sequence():
    """chunk > S runs one chunk of S rows, as the reference's min(chunk, S)."""
    arrs = _inputs(1, 48, 8, 16, 16, seed=4)
    jy, js = ref_ops.ssd_scan(*map(jnp.asarray, arrs), chunk=128)
    y, st = ops.ssd_scan(*map(torch.tensor, arrs), chunk=128)
    _close(y, jy)
    _close(st, js)


def test_chunk_invariance():
    """The chunk size is an implementation detail: results must not depend
    on it (the reference's test of the same name, on the port)."""
    arrs = [torch.tensor(a) for a in _inputs(1, 128, 4, 16, 16, seed=5)]
    y32, s32 = S.ssd_chunked(*arrs, chunk=32)
    y128, s128 = S.ssd_chunked(*arrs, chunk=128)
    torch.testing.assert_close(y32, y128, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(s32, s128, rtol=RTOL, atol=ATOL)
    k16, ks16 = ops.ssd_scan(*arrs, chunk=16)
    torch.testing.assert_close(k16, y128, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(ks16, s128, rtol=RTOL, atol=ATOL)


def test_no_overflow_above_the_diagonal():
    """A fast decay makes cs_i - cs_j large and positive above the diagonal;
    its exp overflows, so the mask has to come before it: every output
    stays finite and equals the chunked oracle."""
    x, dt, A, Bm, Cm = _inputs(1, 128, 8, 16, 16, seed=6)
    dt = dt * 40.0                       # |dA| up to ~200 a step
    arrs = [torch.tensor(a) for a in (x, dt, A, Bm, Cm)]
    dA = arrs[1] * arrs[2]
    outs = ssd_intra_chunk_plain(arrs[0], arrs[1], dA, arrs[3], arrs[4], chunk=64)
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    y, st = ops.ssd_scan(*arrs, chunk=64)
    jy, js = RS.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=64)
    assert bool(torch.isfinite(y).all())
    _close(y, jy)
    _close(st, js)


def test_decode_after_a_chunked_prefill_matches_the_chunked_tail():
    """Prefill 24 tokens chunked, then feed the last 8 one by one through
    the recurrent step: the outputs and the final state equal the chunked
    scan over all 32 (state-space duality; test_models.py's test, on the
    port, from a chunked prefill)."""
    B, S_, H, P, N = 1, 32, 4, 8, 8
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in _inputs(B, S_, H, P, N, seed=7))
    y_par, s_par = S.ssd_chunked(x, dt, A, Bm, Cm, chunk=8)
    _, state = S.ssd_chunked(x[:, :24], dt[:, :24], A, Bm[:, :24], Cm[:, :24],
                             chunk=8)
    ys = []
    for t in range(24, S_):
        y1, state = S.ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], state)
        ys.append(y1)
    torch.testing.assert_close(torch.stack(ys, 1), y_par[:, 24:], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(state, s_par, rtol=RTOL, atol=ATOL)
    # and the reference's own decode step on the same state and inputs
    jy, js = RS.ssd_decode_step(*(jnp.asarray(t.numpy()) for t in (
        x[:, 31], dt[:, 31], A, Bm[:, 31], Cm[:, 31])), jnp.asarray(s_par.numpy()))
    y1, s1 = S.ssd_decode_step(x[:, 31], dt[:, 31], A, Bm[:, 31], Cm[:, 31], s_par)
    _close(y1, jy)
    _close(s1, js)


def _z(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("case,match", [
    (dict(S_=512, chunk=512), "chunk 512 outside"),
    (dict(S_=96, chunk=64), "not a multiple of the chunk"),
    (dict(N=130), r"N = 130 and P = 64 must be in \[1, 128\]"),
    (dict(P=160), r"N = 16 and P = 160 must be in \[1, 128\]"),
    (dict(H=12), r"H = 12 is not a multiple of min\(8, H\)"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(mixed=True), "of one dtype"),
])
def test_contract_raises_value_error(case, match):
    B, S_, H, P, N = 1, case.get("S_", 64), case.get("H", 8), case.get("P", 64), case.get("N", 16)
    dtype = case.get("dtype", torch.float32)
    x = _z(B, S_, H, P, dtype=dtype)
    Bm = _z(B, S_, N, dtype=torch.bfloat16 if case.get("mixed") else dtype)
    Cm = _z(B, S_, N, dtype=dtype)
    dt = _z(B, S_, H)
    with pytest.raises(ValueError, match=match):
        ops.ssd_intra_chunk(x, dt, dt, Bm, Cm, chunk=case.get("chunk", 32))
    if "chunk" in case and case["chunk"] <= S_:
        with pytest.raises(ValueError, match=match):
            ops.ssd_scan(x, dt, _z(H), Bm, Cm, chunk=case["chunk"])


def test_ragged_sequence_raises_in_the_oracle():
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in _inputs(1, 40, 4, 8, 8))
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        S.ssd_chunked(x, dt, A, Bm, Cm, chunk=16)


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_work_counts_what_the_scan_reads_and_writes(shape, dtype):
    """chip_smoke.ssd_work: its bytes are those of the step's inputs and of
    its outputs with cs (as the scan launches it), its route's own work
    three TF32 products for each product over the causal pairs."""
    B, S_, H, P, N, q = shape
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in _inputs(B, S_, H, P, N))
    x, Bm, Cm = x.to(dtype), Bm.to(dtype), Cm.to(dtype)
    dA = dt * A
    outs = ops.ssd_intra_chunk(x, dt, dA, Bm, Cm, chunk=q)
    cs = cumsum_f32(dA.reshape(B, S_ // q, q, H), dim=2)
    w = chip_smoke.ssd_work(shape, x.element_size())
    assert w.nbytes == sum(t.numel() * t.element_size()
                           for t in (x, dt, dA, Bm, Cm, *outs, cs))
    pairs = int(torch.ones(q, q).tril().sum())
    products = B * (S_ // q) * (pairs * 2 * (N + H * P) + q * H * 2 * P * N)
    assert w.kernel_flops == 3 * products
    assert products < w.flops < 2 * products


@pytest.mark.parametrize("shape,elem,bound_ms,route_ms", [
    ((4, 1024, 112, 64, 64, 128), 4, 0.0899, 0.0459),
    ((4, 1024, 112, 64, 64, 128), 2, 0.0545, 0.0459),
    ((1, 4096, 64, 64, 128, 256), 4, 0.0523, 0.0530),
], ids=["zamba2-f32", "zamba2-bf16", "bound-case-f32"])
def test_ssd_work_gives_the_route_its_bound(shape, elem, bound_ms, route_ms):
    """The bounds chip_smoke.py prints and PERF.md states: the bytes over
    3.35 TB/s, longer than the operations over 495 TFLOP/s (split TF32)."""
    w = chip_smoke.ssd_work(shape, elem)
    assert w.bound_by == "bytes"
    assert abs(1e3 * w.bound_s / bound_ms - 1) < 2e-3
    assert abs(1e3 * w.kernel_flops / w.rate / route_ms - 1) < 2e-3


def test_argtypes_follow_the_c_entry():
    """One ARGTYPES entry per parameter of ssd_scan_launch, of the C
    parameter's kind (pointer, long long, int): a missing or extra entry
    shifts every argument after it."""
    import ctypes
    import re
    text = (ops._CSRC / "ssd_scan.cu").read_text()
    sig = re.search(r"ssd_scan_launch\(([^)]*)\)\s*\{", text).group(1)
    params = [" ".join(a.split()[:-1]) for a in sig.split(",")]
    assert len(params) == len(ops.ARGTYPES)
    for c_type, py in zip(params, ops.ARGTYPES):
        want = (ctypes.c_void_p if "*" in c_type else
                ctypes.c_longlong if "long long" in c_type else ctypes.c_int)
        assert py is want, (c_type, py)
