"""The port's encoder-decoder family on the CPU (``repro_torch.models.
encdec``, the audio branch of ``models.model``, the learned positions in
``models.layers`` and the serve driver's prompt batch) against the
reference: ``encode``, and whisper-medium at ``reduced()`` (2 encoder and
2 decoder layers, 64 encoder frames), the reference's ``init_params``
converted with ``lm_params_from_jax``: train, prefill (logits, the
encoder's output and the self-attention k/v) and 4 decode steps, and the
loss. Then the port on its own: RoPE left out under learned positions,
the init and cache layouts, decode against the parallel forward, the
prompt batch and the serve CLI.

Tolerances: the encoder's output and the logits within 1e-4 of their
largest magnitude (measured ~1e-6), caches 1e-5, the loss 1e-5
relative; the port's decode against its parallel forward 2e-3, the
reference's bound for the dense transformer (its tests have none for
this family).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (close, own_prefill_then_decode, ref_params,
                           same_layout, serve_both)
from repro.configs.registry import get_arch as ref_get_arch
from repro.models import encdec as RE
from repro.models import model as RM
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models import model as M

ROOT = Path(__file__).resolve().parents[1]
B, S, EXTRA = 2, 24, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (ref_get_arch("whisper-medium").reduced(),
            get_arch("whisper-medium").reduced())


def _inputs(cfg, seed, n):
    """Encoder frames and n decoder tokens, as each package's batches of
    the tokens [a, b) (the frames ride along)."""
    rng = np.random.default_rng(seed)
    e = (0.02 * rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model))
         ).astype(np.float32)
    t = rng.integers(0, cfg.vocab_size, (B, n))
    return (lambda a, b: {"embeds": jnp.asarray(e),
                          "tokens": jnp.asarray(t[:, a:b], jnp.int32)},
            lambda a, b: {"embeds": torch.tensor(e),
                          "tokens": torch.tensor(t[:, a:b])})


def test_encode_matches_reference():
    rcfg, cfg = _cfgs()
    jp, tp = ref_params(rcfg)
    jb, tb = _inputs(cfg, 1, 1)
    want = RE.encode(jp, jb(0, 1)["embeds"], rcfg)
    got = encdec.encode(tp, tb(0, 1)["embeds"], cfg)
    assert tuple(got.shape) == (B, 64, cfg.d_model)
    close(got, want, 1e-4)


def test_train_prefill_decode_match_reference():
    rcfg, cfg = _cfgs()
    jp, tp = ref_params(rcfg)
    assert M.count_params(tp) == RM.count_params(jp)
    assert tuple(tp["embed"]["pos"].shape) == (65536, cfg.d_model)
    jb, tb = _inputs(cfg, 1, S + EXTRA)

    want, _, _ = RM.forward(jp, jb(0, S + EXTRA), rcfg, mode="train")
    got, cache = M.forward(tp, tb(0, S + EXTRA), cfg, mode="train")
    assert cache is None
    close(got, want, 1e-4)
    # decode steps take the tokens alone: the frames are in the cache
    serve_both(rcfg, cfg, jp, tp, jb,
               lambda a, b: tb(a, b) if a == 0 else {"tokens": tb(a, b)["tokens"]},
               S, EXTRA, B)


def test_loss_matches_reference():
    rcfg, cfg = _cfgs()
    jp, tp = ref_params(rcfg)
    jb, tb = _inputs(cfg, 3, 16)
    want = float(RM.loss_fn(jp, jb(0, 16), rcfg))
    got = float(M.loss_fn(tp, tb(0, 16), cfg))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_rotate_leaves_q_and_k_alone_under_learned_positions():
    cfg = get_arch("whisper-medium").reduced()
    assert cfg.learned_pos_emb
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((B, 8, 4, 64), generator=gen)
    k = torch.randn((B, 8, 4, 64), generator=gen)
    pos = torch.arange(8)[None].expand(B, 8) + 5
    q2, k2 = L._rotate(q, k, cfg, pos)
    assert torch.equal(q2, q) and torch.equal(k2, k)
    q3, _ = L._rotate(q, k, cfg.replace(learned_pos_emb=False), pos)
    assert not torch.equal(q3, q)


def test_own_init_and_cache_have_the_references_layout():
    rcfg, cfg = _cfgs()
    ref = jax.eval_shape(lambda k: RM.init_params(k, rcfg), jax.random.PRNGKey(0))
    params = M.init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    same_layout(params, ref)
    same_layout(M.init_cache(cfg, B, 40, "cpu"), RM.init_cache(rcfg, B, 40))


def test_learned_positions_table_sizes():
    """65536 positions for an encoder-decoder, 32768 otherwise (the
    reference's embed_init)."""
    gen = torch.Generator().manual_seed(0)
    cfg = get_arch("gemma-2b").reduced(learned_pos_emb=True)
    assert L.embed_init(gen, cfg, torch.float32, "cpu")["pos"].shape == \
        (32768, cfg.d_model)
    assert "pos" not in L.embed_init(gen, get_arch("gemma-2b").reduced(),
                                     torch.float32, "cpu")


def test_decode_matches_parallel_encdec():
    cfg = get_arch("whisper-medium").reduced()
    frames = torch.randn((B, cfg.encoder_seq_len, cfg.d_model),
                         generator=torch.Generator().manual_seed(9)) * 0.02
    got, want = own_prefill_then_decode(
        cfg, 4, S, EXTRA, B, batch_of=lambda t: {"embeds": frames, "tokens": t})
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


def test_prompt_batch_has_frames_and_tokens():
    cfg = get_arch("whisper-medium").reduced()
    batch = serve.build_prompt_batch(cfg, 3, 10, torch.Generator().manual_seed(0),
                                     "cpu")
    assert tuple(batch["embeds"].shape) == (3, cfg.encoder_seq_len, cfg.d_model)
    assert tuple(batch["tokens"].shape) == (3, 10)
    assert batch["tokens"].dtype == torch.int64


def test_serve_starts_decoding_after_the_prompt():
    """The prompt's length is the decoder tokens' (10), not the encoder
    frames' (64): the cache holds 10 + gen positions."""
    cfg = get_arch("whisper-medium").reduced()
    gen = torch.Generator().manual_seed(1)
    params = M.init_params(gen, cfg, "cpu")
    batch = serve.build_prompt_batch(cfg, 2, 10, gen, "cpu")
    res = serve.serve(cfg, params, batch, 3, device="cpu")
    assert tuple(res["prefill_logits"].shape) == (2, 10, cfg.vocab_size)
    assert tuple(res["tokens"].shape) == (2, 3)
    # the last decode step's logits, recomputed by the parallel forward
    toks = torch.cat([batch["tokens"], res["tokens"][:, :2]], dim=1)
    full, _ = M.forward(params, {"embeds": batch["embeds"], "tokens": toks}, cfg)
    torch.testing.assert_close(res["logits"][:, 0], full[:, -1],
                               rtol=2e-3, atol=2e-3)


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c",
                        "import torch\n"
                        "from repro_torch.launch import serve\n"
                        "res = serve.run(['--device', 'cpu', '--arch', "
                        "'whisper-medium', '--batch', '2', '--prompt-len', '12'])\n"
                        "print('shape', tuple(res['prefill_logits'].shape))\n"
                        "assert bool(torch.isfinite(res['logits']).all())\n"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[serve] OK" in r.stdout and "[serve] prefill 2x12" in r.stdout
    assert "shape (2, 12, 512)" in r.stdout
