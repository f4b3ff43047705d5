"""The decode step's cache position as an int32 0-d tensor (the reference's
traced ``jnp.int32`` scalar) on the CPU, against the reference's
``decode_step`` under ``jax.jit``, for every LM family at ``reduced()``
size: dense, vlm (M-RoPE), hybrid, MoE, xLSTM and encoder-decoder. After
the port's prefill, each family decodes a few steps with a
``torch.int32`` index, the reference from the same cache;
the same steps with a Python-int index are bitwise the same (logits and
every cache leaf). A dense config whose window is shorter than its cache
decodes past the wrap, so the ring slot comes round. Each family's decode
step runs on the meta device, where any host read of a tensor's value
fails. ``launch.serve.DecodeRunner`` on the CPU is the eager loop,
bitwise, and refuses another params tree or a cache of other shapes.

Tolerance as in ``tests/test_torch_serve.py``: logits within 1e-4 of
their largest magnitude, caches within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, close_tree, ref_params
from repro.configs.registry import get_arch as ref_get_arch
from repro.models import model as RM
from repro_torch.configs.registry import get_arch
from repro_torch.core import exchange as X
from repro_torch.core import trajectory as TJ
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.obs import RetraceError

B, S, EXTRA = 2, 8, 3
FAMILIES = {"dense": "gemma-2b", "vlm": "qwen2-vl-2b", "hybrid": "zamba2-7b",
            "moe": "deepseek-moe-16b", "xlstm": "xlstm-1.3b",
            "encdec": "whisper-medium"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, seed: int, n: int):
    """Each package's batch of positions [a, b) of n: token ids, a vlm's
    embeddings, or the encoder-decoder's frames and tokens."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, (B, n))
    if cfg.is_encoder_decoder:
        f = (0.02 * rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model))
             ).astype(np.float32)
        return (lambda a, b: {"embeds": jnp.asarray(f),
                              "tokens": jnp.asarray(t[:, a:b], jnp.int32)},
                lambda a, b: {"embeds": torch.tensor(f),
                              "tokens": torch.tensor(t[:, a:b])})
    if cfg.embedding_inputs:
        e = (0.02 * rng.standard_normal((B, n, cfg.d_model))).astype(np.float32)
        return (lambda a, b: {"embeds": jnp.asarray(e[:, a:b])},
                lambda a, b: {"embeds": torch.tensor(e[:, a:b])})
    return (lambda a, b: {"tokens": jnp.asarray(t[:, a:b], jnp.int32)},
            lambda a, b: {"tokens": torch.tensor(t[:, a:b])})


def _decode_batch(batch):
    """A decode step's batch: the encoder-decoder's tokens alone."""
    return {"tokens": batch["tokens"]} if "tokens" in batch else batch


def _bitwise(a, b) -> bool:
    la, lb = X.tree_flatten(a)[0], X.tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        (x is None and y is None) or torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tensor_index_matches_the_jitted_reference(family):
    """Prefill S positions, then EXTRA decode steps: the port's step with a
    torch.int32 index against the reference's jitted step with a
    jnp.int32 index (logits each step, the cache at the end), and the
    port's step with a Python int bitwise its step with the tensor."""
    arch = FAMILIES[family]
    rcfg, cfg = ref_get_arch(arch).reduced(), get_arch(arch).reduced()
    jp, tp = ref_params(rcfg)
    jb, tb = _inputs(cfg, 3, S + EXTRA)
    _, tc = M.prefill(tp, tb(0, S), cfg)
    tc = serve.splice_cache(M.init_cache(cfg, B, S + EXTRA, "cpu"), tc)
    # the reference decodes from the port's prefilled cache (the prefills
    # are held against each other in the families' own tests)
    jc = jax.tree_util.tree_map(lambda t: jnp.array(t.numpy(), copy=True), tc)
    twin = TJ.copy_tree(tc)
    ref_decode = jax.jit(lambda p, b, c, i: RM.decode_step(p, b, c, i, rcfg))
    for i in range(EXTRA):
        pos = S + i
        want, jc = ref_decode(jp, _decode_batch(jb(pos, pos + 1)), jc,
                              jnp.int32(pos))
        got, tc = M.decode_step(tp, _decode_batch(tb(pos, pos + 1)), tc,
                                torch.tensor(pos, dtype=torch.int32), cfg)
        close(got, want, 1e-4)
        as_int, twin = M.decode_step(tp, _decode_batch(tb(pos, pos + 1)),
                                     twin, pos, cfg)
        assert torch.equal(as_int, got)
    close_tree(tc, jc, 1e-5)
    assert _bitwise(twin, tc)


def test_ring_buffer_past_its_window_matches_the_jitted_reference():
    """gemma-2b with a window of 32 (its long_500k config, reduced) and a
    cache of 36 positions, so the cache is a 32-slot ring: 36 steps from
    the empty cache, the last 4 writing slots 0-3 again. Each step's
    logits, and the ring's k, v and slot positions at the end, against
    the reference's jitted step; the Python-int steps bitwise."""
    rcfg = ref_get_arch("gemma-2b", "long_500k").reduced()
    cfg = get_arch("gemma-2b", "long_500k").reduced()
    assert cfg.sliding_window == 32
    n = 36
    jp, tp = ref_params(rcfg, seed=1)
    jb, tb = _inputs(cfg, 4, n)
    jc, tc = RM.init_cache(rcfg, B, n), M.init_cache(cfg, B, n, "cpu")
    assert tuple(tc["pos"].shape) == (cfg.num_layers, 32)
    twin = TJ.copy_tree(tc)
    ref_decode = jax.jit(lambda p, b, c, i: RM.decode_step(p, b, c, i, rcfg))
    for pos in range(n):
        want, jc = ref_decode(jp, jb(pos, pos + 1), jc, jnp.int32(pos))
        got, tc = M.decode_step(tp, tb(pos, pos + 1), tc,
                                torch.tensor(pos, dtype=torch.int32), cfg)
        close(got, want, 1e-4)
        as_int, twin = M.decode_step(tp, tb(pos, pos + 1), twin, pos, cfg)
        assert torch.equal(as_int, got)
    assert tc["pos"][0].tolist() == list(range(32, 36)) + list(range(4, 32))
    close_tree(tc, jc, 1e-5)
    assert _bitwise(twin, tc)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_step_runs_on_the_meta_device(family):
    """One decode step of each family on the meta device, where reading a
    tensor's value on the host (int, .item(), a Python branch) raises:
    with a meta int32 index and with a Python int."""
    cfg = get_arch(FAMILIES[family]).reduced()
    params = M.init_params(torch.Generator(), cfg, "meta")
    cache = M.init_cache(cfg, B, S, "meta")
    batch = ({"embeds": torch.empty((B, 1, cfg.d_model), device="meta")}
             if cfg.embedding_inputs and not cfg.is_encoder_decoder else
             {"tokens": torch.empty((B, 1), dtype=torch.long, device="meta")})
    idx = torch.empty((), dtype=torch.int32, device="meta")
    for index in (idx, S - 1):
        logits, out = M.decode_step(params, batch, cache, index, cfg)
        assert logits.device.type == "meta"
        assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
        assert out is cache


def _served(seed: int = 5):
    """gemma-2b reduced, the port's own init: params, a prompt's first
    token and the spliced cache of 8 + 6 positions."""
    cfg = get_arch("gemma-2b").reduced()
    gen = torch.Generator().manual_seed(seed)
    params = M.init_params(gen, cfg, "cpu")
    batch = serve.build_prompt_batch(cfg, B, 8, gen, "cpu")
    logits, pf = M.prefill(params, batch, cfg)
    cache = serve.splice_cache(M.init_cache(cfg, B, 14, "cpu"), pf)
    return cfg, params, torch.argmax(logits[:, -1:], dim=-1), cache


def _greedy(decode, params, tok, cache, steps: int = 5):
    out = []
    for i in range(steps):
        logits, cache = decode(params, {"tokens": tok}, cache, 8 + i)
        tok = torch.argmax(logits, dim=-1)
        out.append(logits)
    return torch.cat(out, dim=1), cache


def test_decode_runner_on_the_cpu_is_the_eager_loop():
    """``DecodeRunner`` on the CPU: five greedy steps bitwise the eager
    ``decode_step`` loop's (logits and cache), twice over (a second wave
    on a new cache of the same shape), and no capture."""
    cfg, params, tok, cache = _served()
    want, wcache = _greedy(lambda *a: M.decode_step(*a, cfg), params, tok,
                           TJ.copy_tree(cache))
    runner = serve.DecodeRunner(cfg)
    for _ in range(2):
        got, gcache = _greedy(runner, params, tok, TJ.copy_tree(cache))
        assert torch.equal(got, want) and _bitwise(gcache, wcache)
    assert runner.trace_counts() == {}


def test_decode_runner_refuses_another_params_tree_or_cache_shape():
    """A runner serves one params tree and one cache shape: the same
    weights in other tensors, or a cache of another length, would need a
    second capture on the card, and raise RetraceError on any device."""
    cfg, params, tok, cache = _served()
    runner = serve.DecodeRunner(cfg)
    _, cache = runner(params, {"tokens": tok}, cache, 8)
    with pytest.raises(RetraceError, match="params tree of other tensors"):
        runner(TJ.copy_tree(params), {"tokens": tok}, cache, 9)
    longer = M.init_cache(cfg, B, 15, "cpu")
    with pytest.raises(RetraceError, match="other shapes"):
        runner(params, {"tokens": tok}, longer, 9)
    logits, _ = runner(params, {"tokens": tok}, cache, 9)
    assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
