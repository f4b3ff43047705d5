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
the reference. The weights are random, drawn from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.models import model as M
from repro_torch.runtime import resolve_device


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, params, batch, gen: int, *, use_pallas: bool = False,
          device="cuda"):
    """Prefill ``batch``, then decode ``gen - 1`` tokens greedily. Returns
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
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = M.decode_step(params, {"tokens": tok}, cache, S + i, cfg)
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
