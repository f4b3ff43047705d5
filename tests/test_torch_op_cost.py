"""The recorder (``repro_torch.utils.trace``), its cost count
(``utils.op_cost``), the H100 roofline (``utils.roofline``) and the
kernels' declared work (``kernels.work``).

* A three-GEMM chain counts the FLOPs ``repro.utils.hlo_cost.analyze``
  counts on the reference's compiled loop-free program: both 2 |out| K,
  exactly.
* The ring factors are ``repro.utils.hlo._ALGO_FACTOR``'s, exactly.
* A reduced dwfl-paper flat round counts the same FLOPs, bytes and ops on
  the CPU and on the meta device, and the recorder's pointwise shortcut
  on meta changes nothing against PyTorch's own meta kernels: exact.
* The roofline's three terms are the reference's formulas with the
  H100's peaks passed in (rel 1e-12).
* The moved work formulas give PERF.md's bounds to the digits it prints.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import work as W
from repro_torch.utils import op_cost, roofline as rl
from repro_torch.utils.trace import Recorder


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REL = 1e-12


def _chain(a, b, c, d):
    return ((a @ b) @ c) @ d


def test_gemm_chain_flops_equal_the_reference_hlo_cost():
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.utils import hlo_cost
    shapes = [(64, 96), (96, 48), (48, 80), (80, 32)]
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    hlo = jax.jit(lambda *x: _chain(*x)).lower(
        *[jnp.asarray(a) for a in arrs]).compile().as_text()
    want = hlo_cost.analyze(hlo).flops
    _, cost = op_cost.count(_chain, *[torch.as_tensor(a) for a in arrs])
    want_formula = 2 * (64 * 48 * 96 + 64 * 80 * 48 + 64 * 32 * 80)
    assert cost.flops == want == want_formula
    assert cost.flops_by_class == {"f32": want_formula}
    # bytes: each product reads its operands and writes its output once
    nb = lambda *s: 4 * math.prod(s)
    assert cost.bytes == (nb(64, 96) + nb(96, 48) + nb(64, 48)
                          + nb(64, 48) + nb(48, 80) + nb(64, 80)
                          + nb(64, 80) + nb(80, 32) + nb(64, 32))


def test_ring_factors_equal_the_reference():
    pytest.importorskip("jax")
    from repro.utils.hlo import _ALGO_FACTOR
    assert set(op_cost.RING_FACTOR) == set(_ALGO_FACTOR)
    for op, f in _ALGO_FACTOR.items():
        for g in range(1, 9):
            assert op_cost.RING_FACTOR[op](g) == f(g)


def test_views_and_in_place_ops_are_not_counted_twice():
    x = torch.randn(8, 16)
    y = torch.randn(8, 16)
    out = torch.empty(8, 16)
    with Recorder() as rec:
        x.view(16, 8).t()                # views: no bytes
        x.add_(y)                        # reads x, y; writes x once
        torch.add(x, y, out=out)
    by = {o.name: o.nbytes for o in rec.ops}
    n = 8 * 16 * 4
    assert by["aten.view.default"] == 0 and by["aten.t.default"] == 0
    assert by["aten.add_.Tensor"] == 3 * n
    assert by["aten.add.out"] == 3 * n      # x, y read; out written


def _flat_round_cost(device: str):
    from repro_torch.analysis import registry as R
    prog, = R.build_programs(["static-flat"], hidden=16, device=device)
    from repro_torch.core import trajectory as TJ
    with Recorder(keep_ops=False) as rec:
        carry, out = TJ.run_chunk(prog.body, prog.carry, 2)
    return rec.cost


def test_flat_round_counts_the_same_on_cpu_and_meta(monkeypatch):
    import repro_torch.utils.trace as T
    cpu = _flat_round_cost("cpu").as_dict()
    fast = _flat_round_cost("meta").as_dict()
    monkeypatch.setattr(T, "_FAST", frozenset())    # PyTorch's meta kernels
    meta = _flat_round_cost("meta").as_dict()
    assert cpu == meta == fast
    # the clip's row sums count the card's three reductions on every
    # device; only dp_mix is a kernel call
    assert cpu["kernel_calls"] == {"dp_mix_round": 2}
    assert cpu["flops"] > 0 and cpu["bytes"] > 0


def test_row_sum_squares_counts_the_card_s_ops_on_the_cpu():
    from repro_torch.core.privacy import row_sum_squares
    x = torch.randn(3, 5000)
    with Recorder() as cpu:
        out = row_sum_squares(x)
    xm = x.to("meta")
    with Recorder() as meta:
        row_sum_squares(xm)
    names = [o.name for o in cpu.ops]
    assert names == [o.name for o in meta.ops]
    # the padded square, the zero fill of its tail, the three sums
    assert names.count("aten.pow.Tensor_Scalar_out") == 1
    assert names.count("aten.fill_.Scalar") == 1
    assert names.count("aten.sum.dim_IntList") == 3
    assert cpu.cost.as_dict() == meta.cost.as_dict()
    # the CPU's value is its own single reduction, exact
    assert torch.equal(out, torch.sum(x ** 2, dim=1))


def test_wrappers_on_meta_give_the_cpu_s_shapes_and_work():
    """Each wrapper takes a meta tensor through its plain version (shapes
    only) and declares the work it declares on the CPU."""
    from repro_torch.kernels.dp_perturb import ops as pops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    g = torch.Generator().manual_seed(0)

    def calls(device):
        t = lambda *s, dt=torch.float32: torch.randn(
            s, generator=g).to(dt).to(device)
        out = []
        with Recorder() as rec:
            out.append(fops.flash_attention(t(1, 64, 4, 32), t(1, 64, 2, 32),
                                            t(1, 64, 2, 32)))
            out += pops.sgd_update_leaves([t(3, 5), t(3, 7)],
                                          [t(3, 5), t(3, 7)], 0.1)
            out += list(pops.dp_perturb(t(4, 9), t(4, 9), 7, gamma=0.1,
                                        sigma=1.0, s_sig=0.5, s_noise=2.0))
            x, Bm = t(1, 64, 8, 16), t(1, 64, 16)
            out += list(sops.ssd_scan(x, t(1, 64, 8).abs(), -t(8).abs(), Bm,
                                      Bm, chunk=32))
        return out, [(k.name, k.work) for k in rec.kernels]

    cpu, kc = calls("cpu")
    meta, km = calls("meta")
    assert kc == km and [n for n, _ in kc] == [
        "flash_attention", "sgd_update_leaves", "dp_perturb",
        "ssd_intra_chunk"]
    for a, b in zip(cpu, meta):
        assert b.device.type == "meta"
        assert (a.shape, a.dtype) == (b.shape, b.dtype)


def test_peak_counts_live_storages():
    with Recorder() as rec:
        a = torch.empty(1000)            # 4000 bytes
        b = torch.empty(500)             # 2000
        del a
        c = torch.empty(250)             # 1000
    assert rec.peak_bytes == 6000
    assert rec.live_bytes == 3000
    del b, c


def test_roofline_terms_are_the_reference_s_with_the_h100_peaks(monkeypatch):
    pytest.importorskip("jax")
    from repro.utils import roofline as ref
    monkeypatch.setattr(ref, "PEAK_FLOPS_BF16", rl.BF16_TC_FLOP_PER_S)
    monkeypatch.setattr(ref, "HBM_BW", rl.HBM_BYTES_PER_S)
    monkeypatch.setattr(ref, "ICI_BW", rl.NVLINK_BYTES_PER_S)
    chips, flops, nbytes, link = 256, 7.4e18, 3.1e15, 2.2e13
    cost = op_cost.Cost(flops_by_class={"bf16": flops}, bytes=nbytes,
                        link_bytes=link)
    mine = rl.from_cost("x", cost, model_flops=5.0e18, n_chips=chips)
    want = ref.from_analysis("x", {"flops": flops / chips,
                                   "bytes accessed": nbytes / chips},
                             link / chips, model_flops=5.0e18, n_chips=chips)
    for k in ("compute_s", "memory_s", "collective_s", "useful_flop_ratio",
              "mfu_bound", "step_time_s"):
        assert getattr(mine, k) == pytest.approx(getattr(want, k), rel=REL)
    assert mine.dominant == want.dominant
    assert rl.model_flops_estimate(10, 3, "train") == \
        ref.model_flops_estimate(10, 3, "train")
    # a float32 GEMM without TF32 runs on the CUDA cores
    f32 = rl.from_cost("y", op_cost.Cost(flops_by_class={"f32": 67e12}))
    assert f32.compute_s == pytest.approx(1.0, rel=REL)
    meta = rl.from_cost("z", cost, collectives=False)
    assert meta.collective_s is None and "meta" in meta.collective_note


def _ms(seconds: float) -> float:
    return 1e3 * seconds


MLP_LEAVES = [(10, 256), (10, 3072, 256), (10, 256), (10, 256, 256),
              (10, 10), (10, 256, 10)]
OLMO_ELEMENTS = 2 * 1_176_764_416


def test_moved_formulas_reproduce_perf_bounds():
    """PERF.md section 6's bound column, to the digits it prints."""
    fa = W.flash_work(4, 1024, 8, 1, 256, 4)
    assert round(_ms(fa.bound_s), 4) == 0.0347 and fa.bound_by == "operations"
    fb = W.flash_work(4, 1024, 8, 1, 256, 2)
    assert round(_ms(fb.bound_s), 4) == 0.0174
    ssd = W.ssd_work((4, 1024, 112, 64, 64, 128), 4)
    assert round(_ms(ssd.bound_s), 4) == 0.0899 and ssd.bound_by == "bytes"
    numel = sum(math.prod(s) for s in MLP_LEAVES)
    assert round(_ms(W.perturb_work(numel, 4, False, 1).bound_s), 4) == 0.0306
    assert round(_ms(W.perturb_work(OLMO_ELEMENTS, 4, False, 1).bound_s),
                 3) == 8.431
    assert round(_ms(W.dp_mix_bytes(10, 855_050, 4) / rl.HBM_BYTES_PER_S),
                 4) == 0.0306
    # the declared works' rates land in the roofline's classes
    assert (fa.compute_class, fb.compute_class, ssd.compute_class,
            W.dp_mix_work(10, 99, 4).compute_class) == (
        "tf32", "bf16", "tf32", "f32")
    # dp_mix's large-N route at the path's d: bytes up to N = 256, then its
    # products at the TF32 peak; its own split work three times those
    large = {N: W.dp_mix_work(N, 855_050, 4) for N in (64, 128, 256, 2048)}
    assert [round(_ms(large[N].bound_s), 4) for N in (64, 128, 256)] == [
        0.1960, 0.3921, 0.7842]
    assert [large[N].bound_by for N in (64, 128, 256, 2048)] == [
        "bytes", "bytes", "bytes", "operations"]
    assert round(_ms(large[2048].bound_s), 2) == 14.49
    assert round(_ms(large[2048].kernel_flops / large[2048].rate), 2) == 43.47
    assert round(_ms(large[2048].nbytes / rl.HBM_BYTES_PER_S), 2) == 6.28


@pytest.mark.parametrize("N,cls", [(3, "f32"), (10, "f32"), (50, "f32"),
                                   (51, "tf32"), (64, "tf32"),
                                   (2048, "tf32")])
def test_dp_mix_declares_the_route_an_h100_takes(N, cls):
    """The column route (N <= 50 on an H100) declares its mix on the CUDA
    cores, the large-N route in split TF32: the products at the TF32
    peak, its own work three TF32 products a product."""
    w = W.dp_mix_work(N, 1001, 4, R=2)
    assert w.compute_class == cls
    assert w.flops == 2 * 2 * N * N * 1001
    assert w.kernel_flops == (3 if cls == "tf32" else 1) * w.flops
    assert W.dp_mix_columns_route(N) == (cls == "f32")


def test_dp_mix_route_figures_follow_the_kernel_source():
    """work.py's copy of columns_route reads the column route's block
    (kThreads, kCols, kMinWarps) from dp_mix.cu, and its shared memory is
    columns_smem_bytes's formula: at N = 50, 16 N + 4 (N round4(N) + 2 N
    kThreads kCols); on an H100, N <= 50 (chip_smoke.py holds it to the C
    launch's route on the card)."""
    from pathlib import Path
    src = (Path(W.__file__).parent / "dp_mix" / "csrc" / "dp_mix.cu").read_text()
    assert [W._cu_constant(src, n) for n in ("kThreads", "kCols",
                                             "kMinWarps")] == [
        W.COLUMN_THREADS, W.COLUMN_COLS, W.COLUMN_MIN_WARPS] == [128, 2, 8]
    assert "sizeof(float4) * n +" in src and \
        "sizeof(float) * (n * np + staged(noisy) * (size_t)n * kTileCols)" in src
    assert W.dp_mix_columns_smem(50) == 16 * 50 + 4 * (50 * 52 + 2 * 50 * 256)
    assert [W.dp_mix_columns_route(N) for N in (50, 51)] == [True, False]
