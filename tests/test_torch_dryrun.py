"""The dry run (``repro_torch.launch.dryrun``) on the meta device.

* Its fits are exact: a train round counted at W = 2, 3, 4 and
  extrapolated to W = 5 gives the FLOPs, bytes and op counts of the
  round run at W = 5; with a per-step recurrence (xLSTM's sLSTM) also
  over S, and a recurrent prefill over S. Reduced configs, the fits'
  points scaled down with the chunk; exact equality.
* The CLI writes a record a pair with the reference's OK / SKIP / FAIL
  lines and exit code.
* The bfloat16 decode step of zamba2's Mamba2 block (which the dry run
  reaches) promotes as the reference's jnp.einsum does: equal to the
  reference's ``ssd_decode_step`` within float32 rounding (rtol 1e-6).
The full dry run at the production shapes takes minutes of host time:
chip_smoke.py runs it, not these tests.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.specs import DRYRUN_OVERRIDES, build_case
from repro_torch.utils.trace import Recorder


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(DRYRUN_OVERRIDES, num_layers=2, d_model=64, num_heads=4,
             num_kv_heads=4, d_ff=128, vocab_size=128)
XSMALL = dict(DRYRUN_OVERRIDES, num_layers=2, d_model=64, vocab_size=128,
              slstm_every=2, ssm_chunk=16)
MSMALL = dict(SMALL, num_experts=4, num_experts_per_tok=2,
              num_shared_experts=1, moe_d_ff=32, first_dense_layers=1)


def _direct(case):
    with Recorder(keep_ops=False) as r:
        case.fn(*case.args)
    return D._fields(r.cost)


@pytest.mark.parametrize("arch,shape,ov,S", [
    ("olmo-1b", "train_4k", SMALL, None),
    ("deepseek-moe-16b", "train_4k", MSMALL, None),
    ("xlstm-1.3b", "train_4k", XSMALL, 80),
    ("xlstm-1.3b", "prefill_32k", XSMALL, 80)])
def test_fits_are_exact(arch, shape, ov, S, monkeypatch):
    monkeypatch.setitem(D.FIT, "train-loop",
                        [(2, 32), (3, 32), (4, 32), (2, 48), (2, 64)])
    monkeypatch.setitem(D.FIT, "prefill-loop", [(None, 32), (None, 48)])
    mesh = mesh_lib.MeshShape(("data", "model"), (5, 2))
    case = build_case(arch, shape, mesh, "meta", overrides=ov, seq_len=S)
    cost, peak, how = D.count_case(case, arch, shape, False, "meta",
                                   overrides=ov)
    assert how["how"] == "fit" and peak is None
    assert D._fields(cost) == _direct(case)


def test_cli_records_a_pair(tmp_path, capsys):
    assert D.main(["--arch", "gemma-2b", "--shape", "decode_32k",
                   "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "OK    gemma-2b" in out and "1 ok, 0 designed skips, 0 failures" \
        in out
    rec = json.loads((tmp_path / "gemma-2b__decode_32k__singlepod.json")
                     .read_text())
    assert rec["ok"] and rec["counted"] == {"how": "direct"}
    assert rec["n_chips"] == 256 and rec["kind"] == "decode"
    assert rec["roofline"]["collective_s"] is None
    assert rec["memory"]["arguments_fit_h100_80gb"]
    assert rec["op_cost"]["flops"] > 0 and rec["memory"]["peak_live_bytes"]
    assert D.main(["--arch", "olmo-1b", "--shape", "long_500k",
                   "--out", str(tmp_path)]) == 0
    assert "SKIP  olmo-1b" in capsys.readouterr().out


def test_cli_fails_on_a_failing_pair(tmp_path, capsys, monkeypatch):
    import repro_torch.launch.specs as specs

    def broken(*a, **k):
        raise RuntimeError("no such step")

    monkeypatch.setattr(specs, "build_case", broken)
    assert D.main(["--arch", "gemma-2b", "--shape", "decode_32k",
                   "--out", str(tmp_path)]) == 1
    assert "FAIL  gemma-2b" in capsys.readouterr().out


def test_bf16_ssd_decode_step_promotes_as_the_reference():
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.models.ssm import ssd_decode_step as ref_step
    from repro_torch.models.ssm import ssd_decode_step
    rng = np.random.default_rng(0)
    B, H, P, N = 2, 3, 4, 5
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = np.abs(rng.standard_normal((B, H))).astype(np.float32)
    A = -np.abs(rng.standard_normal(H)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, N)).astype(np.float32)
              for _ in range(2))
    st = rng.standard_normal((B, H, P, N)).astype(np.float32)
    bf = lambda a: torch.as_tensor(a).to(torch.bfloat16)
    y, s = ssd_decode_step(bf(x), torch.as_tensor(dt), torch.as_tensor(A),
                           bf(Bm), bf(Cm), torch.as_tensor(st))
    jb = lambda a: jnp.asarray(a, dtype=jnp.bfloat16)
    ry, rs = ref_step(jb(x), jnp.asarray(dt), jnp.asarray(A), jb(Bm), jb(Cm),
                      jnp.asarray(st))
    assert y.dtype == torch.float32 and str(ry.dtype) == "float32"
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-6,
                               atol=1e-6)
