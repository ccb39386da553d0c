"""Deterministic synthetic stand-in for MNIST-784 (a numpy copy of
``repro/data/synthetic.py:mnist_like``; the port keeps its own copy so it
never imports the reference).

10 class manifolds in 784-D: each class is an affine map of a low intrinsic
dimension gaussian latent through smooth blob bases on the 28x28 grid,
clipped to [0, 1] and unit-normalized as the paper normalizes MNIST.  The
same seed gives the same arrays as the reference.
"""
from __future__ import annotations

import numpy as np


def mnist_like(n: int = 60_000, n_test: int = 2_000, d: int = 784,
               n_classes: int = 10, intrinsic_dim: int = 12,
               noise: float = 0.02, seed: int = 0
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (db (n, d), db_labels, queries (n_test, d), query_labels)."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(d))
    yy, xx = np.mgrid[0:side, 0:side]
    bases = np.zeros((n_classes, intrinsic_dim, d), np.float32)
    for c in range(n_classes):
        for j in range(intrinsic_dim):
            cx, cy = rng.uniform(4, side - 4, 2)
            sx, sy = rng.uniform(1.5, 5.0, 2)
            blob = np.exp(-((xx - cx) ** 2 / (2 * sx**2)
                            + (yy - cy) ** 2 / (2 * sy**2)))
            bases[c, j] = blob.reshape(-1)
    mean = np.zeros((n_classes, d), np.float32)
    for c in range(n_classes):
        cx, cy = rng.uniform(8, side - 8, 2)
        blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 6.0**2))
        mean[c] = 0.5 * blob.reshape(-1)

    def sample(m: int, labels: np.ndarray) -> np.ndarray:
        z = rng.normal(size=(m, intrinsic_dim)).astype(np.float32) * 0.35
        x = mean[labels] + np.einsum("mi,mid->md", z, bases[labels])
        x += noise * rng.normal(size=(m, d)).astype(np.float32)
        x = np.clip(x, 0.0, 1.0)
        x /= np.linalg.norm(x, axis=1, keepdims=True) + 1e-12
        return x.astype(np.float32)

    db_labels = rng.integers(0, n_classes, size=n)
    q_labels = rng.integers(0, n_classes, size=n_test)
    return sample(n, db_labels), db_labels, sample(n_test, q_labels), q_labels
