"""``examples/port_serve_batched.py`` against the reference example's
loop (``examples/serve_batched.py``) at reduced gemma-2b size: the
reference's parameters converted with ``convert.lm_params_from_jax``, its
two waves' prompts (``build_prompt_batch`` under ``fold_in(key, wave)``)
replayed into the port. Each wave's greedy tokens are equal, its last
logits within 1e-4 of their largest magnitude (``_torch_parity.close``,
as the serve parity tests), and its printed stop lengths the reference's
(``np.random.default_rng(wave)``). The CLI runs on the CPU and prints the
reference's lines."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import _torch_parity as TP  # noqa: E402
from repro.configs.registry import get_arch as ref_arch  # noqa: E402
from repro.launch.serve import build_prompt_batch as ref_prompts  # noqa: E402
from repro.launch.serve import splice_cache as ref_splice  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_EX = Path(__file__).resolve().parents[1] / "examples" / "port_serve_batched.py"
_SPEC = importlib.util.spec_from_file_location("port_serve_batched", _EX)
example = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(example)

B, S, G, WAVES = 2, 16, 6, 2


def _reference_waves(rcfg, params):
    """The reference example's loop, as its main() runs it."""
    key = jax.random.PRNGKey(0)
    prefill = jax.jit(lambda p, b: RM.prefill(p, b, rcfg))
    decode = jax.jit(lambda p, b, c, i: RM.decode_step(p, b, c, i, rcfg))
    out = []
    for w in range(WAVES):
        batch = ref_prompts(rcfg, B, S, jax.random.fold_in(key, w))
        logits, pf = prefill(params, batch)
        cache = ref_splice(RM.init_cache(rcfg, B, S + G), pf)
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        stops = np.random.default_rng(w).integers(G // 2, G, B)
        toks = [tok]
        for i in range(G - 1):
            logits, cache = decode(params, {"tokens": tok}, cache, S + i)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks.append(tok)
        out.append({"batch": batch, "tokens": np.concatenate(toks, 1),
                    "logits": logits, "stops": stops})
    return out


def test_waves_equal_the_reference_example_loop():
    rcfg, cfg = ref_arch("gemma-2b").reduced(), get_arch("gemma-2b").reduced()
    jp, tp = TP.ref_params(rcfg, 0)
    want = _reference_waves(rcfg, jp)
    prompts = [{k: torch.tensor(np.asarray(v)) for k, v in w["batch"].items()}
               for w in want]
    got = list(example.serve_waves(cfg, tp, prompts, G, "cpu"))
    assert len(got) == WAVES
    for g, w in zip(got, want):
        assert g["tokens"].tolist() == w["tokens"].tolist()
        TP.close(g["logits"], w["logits"], 1e-4)
        assert g["stops"].tolist() == w["stops"].tolist()


def test_cli_prints_the_reference_s_lines(capsys):
    example.main(["--device", "cpu", "--requests", "3", "--batch", "2",
                  "--prompt-len", "8", "--gen", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[batched] wave 0: 2 requests, stop lens [")
    assert lines[1].startswith("[batched] wave 1: 2 requests, stop lens [")
    assert lines[2].startswith("[batched] served 4 requests in ")
