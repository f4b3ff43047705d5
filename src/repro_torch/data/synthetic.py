"""Deterministic offline synthetic data — numpy copies of the reference's
``repro.data.synthetic``, bitwise equal to it: ``classification_dataset``,
a CIFAR-shaped (3072-dim, 10-class) task from a random linear-softmax
teacher over correlated Gaussian features plus label noise, and
``lm_dataset``, a token stream from a sparse random bigram chain for the
LM architectures."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def classification_dataset(n: int, input_dim: int = 3072, num_classes: int = 10,
                           seed: int = 0, label_noise: float = 0.05,
                           teacher_rank: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x [n, input_dim], y [n] int32). x is float64, as the
    reference's is: numpy promotes the float32 product divided by the
    float64 np.sqrt(teacher_rank)."""
    rng = np.random.default_rng(seed)
    mix = rng.normal(size=(teacher_rank, input_dim)).astype(np.float32)
    z = rng.normal(size=(n, teacher_rank)).astype(np.float32)
    x = (z @ mix) / np.sqrt(teacher_rank)
    teacher = rng.normal(size=(teacher_rank, num_classes)).astype(np.float32)
    logits = z @ teacher + 0.5 * rng.normal(size=(n, num_classes)).astype(np.float32)
    y = logits.argmax(-1).astype(np.int32)
    flip = rng.random(n) < label_noise
    y[flip] = rng.integers(0, num_classes, flip.sum(), dtype=np.int32)
    return x, y


def lm_dataset(n_tokens: int, vocab_size: int, seed: int = 0) -> np.ndarray:
    """[n_tokens] int32 token stream from a sparse random bigram chain
    (each token has min(32, vocab) successors). The chain is walked in a
    Python loop, as the reference walks it: its draws, and so its tokens,
    are the reference's at the same seed."""
    rng = np.random.default_rng(seed)
    branch = min(32, vocab_size)
    nxt = rng.integers(0, vocab_size, size=(vocab_size, branch))
    toks = np.empty(n_tokens, np.int32)
    t = rng.integers(0, vocab_size)
    choices = rng.integers(0, branch, size=n_tokens)
    for i in range(n_tokens):
        toks[i] = t
        t = nxt[t, choices[i]]
    return toks
