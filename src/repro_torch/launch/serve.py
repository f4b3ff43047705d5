"""Batched serving driver: prefill a prompt batch, then decode tokens
greedily (the reference's ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch gemma-2b --full
    python -m repro_torch.launch.serve --device cpu --arch zamba2-7b
    python -m repro_torch.launch.serve --device cpu --arch whisper-medium

Runs on the card by default and raises without one; ``--device cpu``
runs the plain PyTorch versions. As in the reference, the CLI leaves
``use_pallas`` off: the kernels' path (flash_attention in the dense
transformer, ssd_scan in zamba2's Mamba2 blocks) is the library call
``model.prefill(params, batch, cfg, use_pallas=True)``, which
``serve(..., use_pallas=True)`` takes. The MoE, xLSTM and
encoder-decoder families take ``use_pallas`` and launch no kernel, as in
the reference. The weights are random, drawn from ``--seed``. On the
card the decode runs as one CUDA graph of the step (``DecodeRunner``, the
reference's jitted decode program), captured at the second step and
replayed for every later one.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.exchange import tree_flatten
from repro_torch.models import model as M
from repro_torch.runtime import capture_graph, resolve_device


def build_prompt_batch(cfg, B: int, S: int, generator: torch.Generator,
                       device="cuda"):
    """Random prompts: token ids, embeddings for the embedding-input (vlm)
    families, or for the encoder-decoder both: encoder frames [B,
    encoder_seq_len, d] and decoder tokens [B, S]."""
    dev = resolve_device(device)
    if cfg.is_encoder_decoder:
        embeds = torch.randn((B, cfg.encoder_seq_len, cfg.d_model),
                             generator=generator, device=dev) * 0.02
        return {"embeds": embeds,
                "tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=generator, device=dev)}
    if cfg.embedding_inputs:
        return {"embeds": torch.randn((B, S, cfg.d_model), generator=generator,
                                      device=dev) * 0.02}
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                    generator=generator, device=dev)}


def splice_cache(full, prefill):
    """Copy the prefill's k/v into the (longer) serving cache, in place;
    returns the serving cache. The two trees must have the same keys; a
    None leaf (zamba2's absent trailing layers) stays None, and a leaf of
    the same shape (an SSM state or conv history) is replaced."""
    if full is None or prefill is None:
        if full is not None or prefill is not None:
            raise ValueError("cache trees differ: one leaf is None")
        return None
    if isinstance(full, dict):
        if full.keys() != prefill.keys():
            raise ValueError(f"cache keys differ: {sorted(full)} vs "
                             f"{sorted(prefill)}")
        for k in full:
            full[k] = splice_cache(full[k], prefill[k])
        return full
    if full.shape == prefill.shape:
        return prefill.to(full.dtype)
    full[tuple(slice(0, s) for s in prefill.shape)] = prefill
    return full


def _shapes(tree):
    """A tree's structure and its tensors' (shape, dtype, device)s."""
    leaves, structure = tree_flatten(tree)
    return structure, [None if t is None else (tuple(t.shape), t.dtype,
                                               t.device) for t in leaves]


class DecodeRunner:
    """The reference's jitted decode program (``jax.jit(lambda p, b, c, i:
    M.decode_step(p, b, c, i, cfg))``, with the cache donated):
    ``runner(params, batch, cache, cache_index)`` returns
    ``M.decode_step``'s (logits, cache). ``trace_counts()`` is
    {"decode_step": 1} once the graph is captured, {} before.

    The cache's device decides how a step runs:

    * on the CPU (or the meta device), ``decode_step`` eagerly;
    * on a card, one CUDA graph of the step, replayed. The runner's first
      step runs eagerly: CUDA, cuBLAS and the allocator set themselves up
      there, which no capture may do. It is a real step of the sequence.
      The graph is captured at the second step, and that step and every
      later one is a replay.

    The graph reads and rewrites static buffers. The batch (the [B, 1]
    tokens, or a vlm's [B, 1, d] embeddings) and the int32 position are
    the runner's, written before each replay. The cache is adopted from
    the caller at the capture: the cache passed in is consumed (the
    reference's ``donate_argnums=(2,)``), and the cache returned is the
    runner's, rewritten in place by the next step. A cache that is not
    the runner's (a new wave's) is copied into it. The parameters are held
    by reference, never copied. The logits are copied out of the graph's
    pool.

    One runner serves one parameter tree and one batch and cache shape: a
    params tree of other tensors, or a batch or cache of other shapes or
    dtypes, raises ``obs.RetraceError`` (it would need a second capture).
    A capture that fails raises, naming ROADMAP A7b; nothing falls back to
    the eager step on the card."""

    def __init__(self, cfg):
        self.cfg = cfg
        self._params = self._held = self._shapes = None
        self._stream = self._graph = self._logits = None
        self._batch = self._index = self._cache = None

    def trace_counts(self) -> dict:
        # one capture: anything that would need a second raises in _check
        return {} if self._graph is None else {"decode_step": 1}

    def __call__(self, params, batch, cache, cache_index):
        self._check(params, batch, cache)
        dev = M.cache_device(cache)
        if dev.type != "cuda":
            return M.decode_step(params, batch, cache, cache_index, self.cfg)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            return M.decode_step(params, batch, cache, cache_index, self.cfg)
        if self._graph is None:
            self._capture(batch, cache, dev)
        for name, t in batch.items():
            self._batch[name].copy_(t)
        if torch.is_tensor(cache_index):
            self._index.copy_(cache_index)
        else:
            self._index.fill_(cache_index)
        for s, t in zip(tree_flatten(self._cache)[0], tree_flatten(cache)[0]):
            if s is not t:
                s.copy_(t)
        self._graph.replay()
        return self._logits.clone(), self._cache

    def _check(self, params, batch, cache) -> None:
        from repro_torch.obs.guard import RetraceError
        held = [(t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                for t in tree_flatten(params)[0] if torch.is_tensor(t)]
        shapes = (_shapes(batch), _shapes(cache))
        if self._held is None:
            self._params, self._held, self._shapes = params, held, shapes
            return
        if held != self._held:
            raise RetraceError("DecodeRunner: a params tree of other tensors "
                               "than its graph reads (it would be captured "
                               "a second time)")
        if shapes != self._shapes:
            raise RetraceError("DecodeRunner: a batch or cache of other "
                               "shapes than its graph's buffers (it would "
                               "be captured a second time)")

    def _capture(self, batch, cache, dev) -> None:
        self._batch = {name: t.clone() for name, t in batch.items()}
        self._index = torch.zeros((), dtype=torch.int32, device=dev)
        self._cache = cache
        self._graph, self._logits = capture_graph(
            lambda: M.decode_step(self._params, self._batch, self._cache,
                                  self._index, self.cfg)[0],
            self._stream, what=f"DecodeRunner's {self.cfg.name} decode step")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, params, batch, gen: int, *, use_pallas: bool = False,
          device="cuda"):
    """Prefill ``batch``, then decode ``gen - 1`` tokens greedily through a
    ``DecodeRunner`` (on the card one CUDA graph of the step). Returns
    {"prefill_s", "decode_s", "tokens" [B, gen], "prefill_logits",
    "logits" (the last decode step's)}. Times are host clock around work
    that ends in a device synchronize."""
    dev = resolve_device(device)
    # the prompt's length: the decoder tokens' where there are tokens (the
    # encoder-decoder's embeds are its encoder frames)
    x = batch["tokens"] if "tokens" in batch else batch["embeds"]
    B, S = x.shape[0], x.shape[1]

    _sync(dev)
    t0 = time.perf_counter()
    logits, pf_cache = M.prefill(params, batch, cfg, use_pallas=use_pallas)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    cache = splice_cache(M.init_cache(cfg, B, S + gen, dev), pf_cache)
    del pf_cache
    prefill_logits = logits
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = [tok]
    decode = DecodeRunner(cfg)
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode(params, {"tokens": tok}, cache, S + i)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"prefill_s": t_prefill, "decode_s": t_decode,
            "tokens": torch.cat(out, dim=1), "prefill_logits": prefill_logits,
            "logits": logits}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="gemma-2b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """The CLI's run; returns serve()'s result with the config."""
    args = parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "mlp":
        raise SystemExit("dwfl-paper is a classifier; nothing to decode")
    dev = resolve_device(args.device)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(gen, cfg, dev)
    B, S, G = args.batch, args.prompt_len, args.gen
    batch = build_prompt_batch(cfg, B, S, gen, dev)
    res = serve(cfg, params, batch, G, device=dev)

    t_prefill, t_dec = res["prefill_s"], res["decode_s"]
    print(f"[serve] prefill {B}x{S}: {t_prefill*1e3:.1f} ms "
          f"({B*S/t_prefill:.0f} tok/s)")
    print(f"[serve] decode {G-1} steps: {t_dec*1e3:.1f} ms "
          f"({B*(G-1)/max(t_dec, 1e-9):.0f} tok/s)")
    print(f"[serve] sample output ids[0]: {res['tokens'][0, :16].tolist()}")
    if not bool(torch.isfinite(res["logits"]).all()):
        raise SystemExit("[serve] non-finite logits")
    print("[serve] OK")
    res["cfg"] = cfg
    return res


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
