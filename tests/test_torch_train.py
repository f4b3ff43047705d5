"""The port's train step, trajectory and CLI against the reference, and the
port's independence from JAX.

One round of ``make_flat_train_step`` matches the reference's round given
the same buffer, batch and noise seed (``seed_from_key(k_n)``). A T-round
trajectory replaying the reference's per-round seeds and data uniforms
stays within DRIFT_BOUND of the reference's: each round adds float32
rounding differences of the gradient products and the 3N-term mix, and
the round contracts them. Measured on the CPU (4 workers, hidden 16,
6 rounds, 3 seeds): at most 6.0e-8 after one round and 8.9e-8 after six,
on parameters of magnitude <= 0.92; the bound leaves a factor ~10.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.dwfl_paper import CONFIG as REF_CFG
from repro.core import exchange as RX
from repro.core import protocol as RP
from repro.core import trajectory as RTJ
from repro.data import device as ref_device
from repro_torch.configs import DWFL_PAPER
from repro_torch.convert import params_from_jax
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.core import trajectory as TJ
from repro_torch.data import (ClassificationStore, classification_dataset,
                              dirichlet_partition)
from repro_torch.kernels.dp_mix import ops
from repro_torch.launch import train
from repro_torch.runtime import resolve_device

ROOT = Path(__file__).resolve().parents[1]
N, B, HIDDEN = 4, 8, 16
DRIFT_BOUND = 1e-6
KW = dict(n_workers=N, gamma=0.01, eta=0.4, clip=1.0, target_epsilon=1.0)
# fixed sigma: DP noise of the order of the parameters
NOISY = dict(KW, target_epsilon=0.0, sigma=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(seed=0, kw=KW):
    """Reference step/buffer/store and the port's, on the same numbers."""
    rcfg = REF_CFG.replace(d_model=HIDDEN)
    wp = RP.init_worker_params(jax.random.PRNGKey(seed), rcfg, N)
    rspec = RX.FlatSpec(wp)
    rstep = jax.jit(RP.make_flat_train_step(rcfg, RP.ProtocolConfig(**kw),
                                            rspec.unravel_row))
    flat, _, spec = params_from_jax(jax.tree_util.tree_map(np.asarray, wp),
                                    device="cpu")
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    step = P.make_flat_train_step(cfg, P.ProtocolConfig(**kw), spec, "cpu")
    x, y = classification_dataset(400, seed=seed)
    parts = dirichlet_partition(y, N, seed=seed)
    rstore = ref_device.ClassificationStore.build(x, y, parts, B)
    store = ClassificationStore.build(x, y, parts, B, device="cpu")
    return rstep, rspec.flatten(wp), rstore, step, flat, store


def _seed(k_step):
    return ops.seed_from_key(np.asarray(jax.random.split(k_step, 3)[0]))


@pytest.mark.parametrize("kw", [KW, NOISY], ids=["eps1", "sigma0.5"])
def test_one_step_matches_reference(kw):
    rstep, rflat, rstore, step, flat, store = _both(0, kw)
    key = jax.random.PRNGKey(11)
    k_data, k_step = jax.random.split(key)
    rout, rm = rstep(rflat, rstore.sample(k_data), k_step)
    u = torch.from_numpy(np.array(jax.random.uniform(k_data, (N, B))))
    out, m = step(flat, store.sample(u), _seed(k_step))
    err = float(np.abs(out.numpy() - np.asarray(rout)).max())
    assert err < 1e-6 * (1.0 + float(np.abs(np.asarray(rout)).max())), err
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                  rel=1e-4)
    assert float(m["param_norm"]) == pytest.approx(float(rm["param_norm"]),
                                                   rel=1e-5)


def test_trajectory_replay_stays_within_drift_bound():
    rstep, rflat, rstore, step, flat, store = _both(1)
    key = jax.random.PRNGKey(3)
    drift = []
    for _ in range(6):      # the reference body's key discipline
        key, sk = jax.random.split(key)
        k_data, k_step = jax.random.split(sk)
        rflat, _ = rstep(rflat, rstore.sample(k_data), k_step)
        u = torch.from_numpy(np.array(jax.random.uniform(k_data, (N, B))))
        flat, _ = step(flat, store.sample(u), _seed(k_step))
        drift.append(float(np.abs(flat.numpy() - np.asarray(rflat)).max()))
    assert max(drift) < DRIFT_BOUND, drift
    assert np.isfinite(flat.numpy()).all()


def test_trajectory_chunks_do_not_change_the_stream():
    """Chunk boundaries are invisible: 5 rounds as 2+3 or 1+1+3 give the
    same buffer as 5 in one chunk (one generator, drawn in round order)."""
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    wp = P.init_worker_params(torch.Generator().manual_seed(2), cfg, N, "cpu")
    spec = X.FlatSpec(wp)
    flat = spec.flatten(wp)
    x, y = classification_dataset(400, seed=2)
    store = ClassificationStore.build(x, y, dirichlet_partition(y, N, seed=2),
                                      B, device="cpu")
    body = TJ.make_round_body(cfg, P.ProtocolConfig(**KW), store, spec, "cpu")
    finals = []
    for parts in ((5,), (2, 3), (1, 1, 3)):
        carry = TJ.TrajCarry(torch.Generator().manual_seed(9), flat.clone())
        losses = []
        for k in parts:
            carry, out = TJ.run_chunk(body, carry, k)
            losses.append(out["metrics"]["loss"])
        assert torch.cat(losses).shape == (5,)
        finals.append(carry.params)
    for f in finals[1:]:
        torch.testing.assert_close(f, finals[0], rtol=0, atol=0)


@pytest.mark.parametrize("total,k,every", [(51, 25, 25), (11, 3, 5),
                                           (7, 10, 0), (1, 1, 1), (30, 7, 4)])
def test_plan_chunks_and_auto_chunk_equal_reference(total, k, every):
    assert TJ.plan_chunks(total, k, every) == RTJ.plan_chunks(total, k, every)
    assert TJ.auto_chunk(every) == RTJ.auto_chunk(every)


def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--hidden", "16", "--workers", "4", "--steps", "3",
         "--dataset-size", "2000", *argv],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)


def test_cli_runs_on_cpu():
    """Without --flat-buffer the CLI runs the worker-tree round, as the
    reference's does."""
    r = _cli()
    assert r.returncode == 0, r.stderr
    assert "[train] dwfl-paper scheme=dwfl N=4 eps=" in r.stdout
    assert "[train] params/worker: 0.05M\n" in r.stdout
    assert "[train] step=    0 loss=" in r.stdout


def test_cli_runs_on_cpu_flat_buffer():
    r = _cli("--flat-buffer")
    assert r.returncode == 0, r.stderr
    assert "[train] dwfl-paper scheme=dwfl N=4 eps=" in r.stdout
    assert "[train] params/worker: 0.05M (flat dp_mix buffer)" in r.stdout
    assert "[train] step=    0 loss=" in r.stdout


@pytest.mark.parametrize("argv,item", [
    (["--replicates", "2", "--sparse-neighbors", "4", "--channel-model",
      "dynamic"], "A20"),
    (["--arch", "whisper-medium"], "A16")])
def test_cli_names_the_roadmap_item_of_unported_flags(argv, item):
    """What the CLI cannot run exits naming its ROADMAP item. The sparse
    fleet (A20) was refused here and now parses."""
    if item == "A20":
        assert train.parse_args(argv).replicates == 2
        return
    with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
        train.parse_args(argv)


@pytest.mark.parametrize("argv,want", [
    (["--arch", "olmo-1b", "--reduced"],
     dict(name="olmo-1b", num_layers=2, d_model=256)),
    (["--arch", "gemma-2b", "--seq-len", "256"],
     dict(name="gemma-2b", num_layers=18, d_model=2048)),
    (["--arch", "gemma-2b"], dict(name="gemma-2b", vocab_size=256000))],
    ids=["reduced", "seq-len", "arch"])
def test_cli_takes_the_lm_flags(argv, want):
    """--reduced, --seq-len and every registry --arch, which the CLI once
    refused: the model configuration the run trains (the reference's
    get_arch, reduced() under --reduced)."""
    from repro.configs.registry import get_arch as ref_arch
    args = train.parse_args(argv)
    cfg = train.model_config(args)
    ref = ref_arch(args.arch)
    ref = ref.reduced() if args.reduced else ref
    for k, v in want.items():
        assert getattr(cfg, k) == v == getattr(ref, k)
    assert args.seq_len == (256 if "--seq-len" in argv else 128)


def test_cuda_is_the_default_and_never_falls_back():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()
        with pytest.raises(RuntimeError, match="cuda"):
            train.run(["--workers", "2", "--steps", "1"])


def test_import_leaves_jax_out():
    code = ("import pkgutil, importlib, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr


def test_no_source_imports_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    assert {"simulator.py", "fading.py", "geometry.py"} <= {
        f.name for f in files if f.parent.name == "net"}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f, name)
