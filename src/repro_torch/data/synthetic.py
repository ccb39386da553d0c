"""Deterministic synthetic stand-ins for the paper's two datasets, and
clustered test rows (numpy copies of ``repro/data/synthetic.py``'s
``mnist_like``, ``iss_like`` and ``clustered_gaussians``; the port keeps
its own copies so it never imports the reference).  The same seed gives
the same arrays as the reference.

``mnist_like``: 10 class manifolds in 784-D, each an affine map of a low
intrinsic dimension gaussian latent through smooth blob bases on the 28x28
grid, clipped to [0, 1] and unit-normalized as the paper normalizes MNIST.

``clustered_gaussians``: generic clustered rows for tests and retrieval
corpora.

``iss_like``: non-negative 595-D histograms, one sparse prototype per
vehicle model with multiplicative gamma noise, each row summing to 1 (the
ISS-595 shape descriptors, compared under chi-square).
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


def iss_like(n: int = 250_000, n_test: int = 2_000, d: int = 595,
             n_models: int = 72, sparsity: float = 0.15, seed: int = 1
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (db (n, d), db_labels, queries (n_test, d), query_labels)."""
    rng = np.random.default_rng(seed)
    protos = rng.gamma(2.0, 1.0, size=(n_models, d)).astype(np.float32)
    mask = rng.uniform(size=(n_models, d)) < sparsity
    protos = protos * mask
    protos /= protos.sum(axis=1, keepdims=True) + 1e-12

    def sample(m: int, labels: np.ndarray) -> np.ndarray:
        g = rng.gamma(8.0, 1.0 / 8.0, size=(m, d)).astype(np.float32)
        x = protos[labels] * g
        extra = rng.uniform(size=(m, d)) < 0.01
        x += extra * rng.gamma(1.5, 0.002, size=(m, d))
        x /= x.sum(axis=1, keepdims=True) + 1e-12
        return x.astype(np.float32)

    db_labels = rng.integers(0, n_models, size=n)
    q_labels = rng.integers(0, n_models, size=n_test)
    return sample(n, db_labels), db_labels, sample(n_test, q_labels), q_labels


def clustered_gaussians(n: int, d: int, n_clusters: int = 64,
                        cluster_std: float = 0.15, seed: int = 0
                        ) -> np.ndarray:
    """(n, d) float32 rows around ``n_clusters`` standard-normal centres."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    labels = rng.integers(0, n_clusters, size=n)
    x = centers[labels] + cluster_std * rng.normal(size=(n, d)).astype(
        np.float32)
    return x.astype(np.float32)
