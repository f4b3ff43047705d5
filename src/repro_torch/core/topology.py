"""Gossip topologies beyond the complete graph — a numpy copy of the
reference's ``repro.core.topology``.

The paper's W = ((1)_N - I)/(N - 1) is the complete graph; its
convergence lemmas hold for any doubly-stochastic W. A wireless worker
hears only its radio neighborhood, so this module gives the ring and the
2-D torus, their spectral contraction and the eta that maximizes it.
Privacy consequence (privacy.epsilon_dwfl_topology): receiver i is masked
by its deg(i) neighbors' noises only.
"""
from __future__ import annotations

import numpy as np


def complete(N: int) -> np.ndarray:
    return (np.ones((N, N)) - np.eye(N)) / (N - 1)


def ring(N: int, k: int = 1) -> np.ndarray:
    """Each worker hears k neighbors on each side."""
    W = np.zeros((N, N))
    for i in range(N):
        for d in range(1, k + 1):
            W[i, (i + d) % N] = 1.0
            W[i, (i - d) % N] = 1.0
    return W / (2 * k)


def torus2d(rows: int, cols: int) -> np.ndarray:
    """4-neighbor 2-D torus over N = rows * cols workers."""
    N = rows * cols
    W = np.zeros((N, N))
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for (dr, dc) in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                j = ((r + dr) % rows) * cols + (c + dc) % cols
                W[i, j] += 1.0
    return W / W.sum(1, keepdims=True)


def make(kind: str, N: int, **kw) -> np.ndarray:
    if kind == "complete":
        return complete(N)
    if kind == "ring":
        return ring(N, k=kw.get("k", 1))
    if kind == "torus":
        rows = kw.get("rows") or int(np.sqrt(N))
        if N % rows:
            raise ValueError(f"torus: {N} workers do not fill {rows} rows")
        return torus2d(rows, N // rows)
    raise ValueError(kind)


def check_doubly_stochastic(W: np.ndarray, tol: float = 1e-9) -> bool:
    return (np.allclose(W.sum(0), 1.0, atol=tol)
            and np.allclose(W.sum(1), 1.0, atol=tol)
            and np.allclose(W, W.T, atol=tol))


def contraction(W: np.ndarray, eta: float) -> float:
    """Per-round contraction of worker disagreement under
    Psi = (1 - eta) I + eta W: the largest |eigenvalue| of Psi past the
    consensus one."""
    lam = np.linalg.eigvalsh((1 - eta) * np.eye(len(W)) + eta * W)
    return float(np.sort(np.abs(lam))[-2])


def optimal_eta(W: np.ndarray) -> float:
    """eta* = 2 / (2 - lambda_2 - lambda_N): equalizes the extreme
    disagreement eigenvalues of Psi (symmetric gossip)."""
    lam = np.sort(np.linalg.eigvalsh(W))
    return float(np.clip(2.0 / (2.0 - lam[-2] - lam[0]), 0.0, 1.0))


def degrees(W: np.ndarray) -> np.ndarray:
    return (W > 0).sum(1)
