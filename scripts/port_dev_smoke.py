"""Dev loop on the PyTorch port: the forward, backward, prefill and one
decode step of every architecture at its reduced size (the reference's
``scripts/dev_smoke.py``).

    PYTHONPATH=src python scripts/port_dev_smoke.py [arch ...]
    PYTHONPATH=src python scripts/port_dev_smoke.py --device cpu gemma-2b olmo-1b

Per arch: the parameter count, the training loss and its gradient's norm
(``autograd.grad`` of ``model.loss_fn``) and whether both are finite;
then, for the LMs, the prefill and one decode step from a serving cache
of 128 positions holding the prefill's (``launch.serve.splice_cache``),
and whether its logits are finite. Random parameters and batches from
seeded generators (params 42, batch 0). Runs on the card by default and
raises without one. ``smoke`` is one arch's run, returning what it
printed.
"""
import argparse

import torch

from repro_torch.configs import INPUT_DIM
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core import exchange as X
from repro_torch.launch.serve import splice_cache
from repro_torch.models import model as M
from repro_torch.runtime import resolve_device

B, S, CACHE_LEN = 2, 64, 128


def batch_for(cfg, generator, device, B: int = B, S: int = S) -> dict:
    """A training batch of ``cfg``'s inputs: the classifier's features and
    labels, an encoder-decoder's frames and tokens, an embedding-input
    model's embeddings and labels, else tokens."""
    dev = resolve_device(device)
    if cfg.family == "mlp":
        return {"x": torch.randn((B, INPUT_DIM), generator=generator,
                                 device=dev),
                "y": torch.zeros((B,), dtype=torch.int64, device=dev)}
    tokens = lambda: torch.randint(0, cfg.vocab_size, (B, S),
                                   generator=generator, device=dev)
    if cfg.embedding_inputs and cfg.is_encoder_decoder:
        return {"embeds": torch.randn((B, cfg.encoder_seq_len, cfg.d_model),
                                      generator=generator, device=dev) * 0.02,
                "tokens": tokens()}
    if cfg.embedding_inputs:
        return {"embeds": torch.randn((B, S, cfg.d_model), generator=generator,
                                      device=dev) * 0.02,
                "labels": tokens()}
    return {"tokens": tokens()}


def smoke(name: str, device="cuda") -> dict:
    """One arch at reduced(): params, loss, gradient norm, finiteness; for
    an LM the decode step's logits' shape and finiteness."""
    dev = resolve_device(device)
    cfg = get_arch(name).reduced()
    params = M.init_params(torch.Generator(device=dev).manual_seed(42), cfg,
                           dev)
    n = M.count_params(params)
    batch = batch_for(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    leaves, structure = X.tree_flatten(params)
    with torch.enable_grad():
        ps = [l.detach().requires_grad_(l.is_floating_point())
              for l in leaves]
        loss = M.loss_fn(X.tree_unflatten(structure, ps), batch, cfg)
        grads = torch.autograd.grad(
            loss, [p for p in ps if p.requires_grad], allow_unused=True)
    loss = loss.detach()
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads
                           if g is not None))
    rec = {"arch": name, "params": n, "loss": float(loss),
           "gnorm": float(gnorm)}
    rec["finite"] = bool(torch.isfinite(loss)) and bool(torch.isfinite(gnorm))
    print(f"{name:24s} params={n/1e6:7.2f}M loss={rec['loss']:8.4f} "
          f"gnorm={rec['gnorm']:9.3f} finite={rec['finite']}", flush=True)
    if cfg.family == "mlp":
        return rec
    # prefill + one decode step from a longer serving cache
    with torch.no_grad():
        _, pf = M.prefill(params, batch, cfg)
        S_in = batch.get("tokens", batch.get("embeds")).shape[1]
        cache = splice_cache(M.init_cache(cfg, B, CACHE_LEN, dev), pf)
        del pf
        if cfg.is_encoder_decoder:
            dec = {"tokens": batch["tokens"][:, :1]}
        else:
            dec = {k: v[:, :1] for k, v in batch.items()
                   if k in ("tokens", "embeds")}
        lg, _ = M.decode_step(params, dec, cache, S_in, cfg)
    rec["decode_shape"] = list(lg.shape)
    rec["decode_finite"] = bool(torch.isfinite(lg).all())
    print(f"{'':24s} decode logits {tuple(lg.shape)} "
          f"finite={rec['decode_finite']}", flush=True)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*", help="default: every arch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return [smoke(name, args.device) for name in (args.archs or list(ARCHS))]


if __name__ == "__main__":
    main()
