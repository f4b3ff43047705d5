"""Serve a small model with batched requests on the PyTorch port: waves
of prompts, each prefilled, spliced into a longer cache and decoded
greedily (the serving-side example; the reference's
``examples/serve_batched.py``).

    PYTHONPATH=src python examples/port_serve_batched.py --arch gemma-2b
    PYTHONPATH=src python examples/port_serve_batched.py --device cpu

Runs on the card by default and raises without one. As in the
reference, the config is reduced, each wave prints its requests'
per-request stop lengths (drawn from ``np.random.default_rng(wave)``),
and every request decodes gen - 1 steps: the stops are printed, not
applied. ``serve_waves`` is the loop, a function of the config, so a
caller can run it at full size. Every wave decodes through one
``DecodeRunner`` (the reference's one jitted decode program): on the card
the waves share one CUDA graph of the step, captured in the first wave.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.launch.serve import (DecodeRunner, build_prompt_batch,
                                      splice_cache)
from repro_torch.models import model as M
from repro_torch.runtime import resolve_device


def random_prompts(cfg, waves: int, B: int, S: int, seed: int = 0,
                   device="cuda"):
    """One random prompt batch a wave, wave w's from a generator seeded
    seed + w."""
    dev = resolve_device(device)
    for w in range(waves):
        gen = torch.Generator(device=dev).manual_seed(seed + w)
        yield build_prompt_batch(cfg, B, S, gen, dev)


def serve_waves(cfg, params, prompts, gen: int, device="cuda"):
    """For each prompt batch of ``prompts`` (one a wave): prefill, splice
    the prefill's cache into a cache of S + gen positions, take the
    greedy token, then decode gen - 1 steps, every wave through one
    ``DecodeRunner``. Yields {"wave", "tokens" [B, gen], "logits" (the
    last step's), "stops" [B]}."""
    dev = resolve_device(device)
    decode = DecodeRunner(cfg)
    for w, batch in enumerate(prompts):
        x = batch["tokens"] if "tokens" in batch else batch["embeds"]
        B, S = x.shape[0], x.shape[1]
        logits, pf = M.prefill(params, batch, cfg)
        cache = splice_cache(M.init_cache(cfg, B, S + gen, dev), pf)
        del pf
        tok = torch.argmax(logits[:, -1:], dim=-1)
        # per-request stop lengths simulate heterogeneous requests
        stops = np.random.default_rng(w).integers(gen // 2, gen, B)
        out = [tok]
        for i in range(gen - 1):
            logits, cache = decode(params, {"tokens": tok}, cache, S + i)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
        yield {"wave": w, "tokens": torch.cat(out, dim=1), "logits": logits,
               "stops": stops}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b",
                    choices=[a for a in ARCHS if a != "dwfl-paper"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).reduced()
    dev = resolve_device(args.device)
    params = M.init_params(torch.Generator(device=dev).manual_seed(args.seed),
                           cfg, dev)
    B, S, G = args.batch, args.prompt_len, args.gen
    waves = -(-args.requests // B)
    done = 0
    t0 = time.time()
    for res in serve_waves(cfg, params,
                           random_prompts(cfg, waves, B, S, args.seed + 1,
                                          dev), G, dev):
        if not bool(torch.isfinite(res["logits"]).all()):
            raise SystemExit(f"[batched] wave {res['wave']}: non-finite "
                             f"logits")
        done += B
        print(f"[batched] wave {res['wave']}: {B} requests, stop lens "
              f"{res['stops'].tolist()}")
    dt = time.time() - t0
    print(f"[batched] served {done} requests in {dt:.1f}s "
          f"({done * (S + G) / dt:,.0f} tok/s incl. prefill)")


if __name__ == "__main__":
    main()
