"""Distance metrics used by the paper (port of ``repro/core/distances.py``).

The paper evaluates with Euclidean distance (MNIST-784) and the Chi-Square
divergence (ISS-595):  chi2(x, y) = sum_k (x_k - y_k)^2 / (x_k + y_k).
Smaller is always more similar: the inner product is negated and cosine is
``1 - cos``.
"""
from __future__ import annotations

from typing import Callable

import torch

EPS = 1e-12

# ---------------------------------------------------------------------------
# point-to-point / point-to-set forms (broadcasting over leading axes)
# ---------------------------------------------------------------------------


def l2_sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance along the last axis."""
    d = x - y
    return torch.sum(d * d, dim=-1)


def chi2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Chi-square divergence along the last axis (non-negative inputs)."""
    return torch.sum((x - y) ** 2 / (x + y + EPS), dim=-1)


def neg_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Negative inner product (smaller == more similar)."""
    return -torch.sum(x * y, dim=-1)


def cosine_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + EPS)
    yn = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + EPS)
    return 1.0 - torch.sum(xn * yn, dim=-1)


METRICS: dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "l2": l2_sq,
    "chi2": chi2,
    "dot": neg_dot,
    "cosine": cosine_dist,
}

# user-facing aliases -> the canonical kernel spelling
METRIC_ALIASES: dict[str, str] = {
    "ip": "dot",
    "inner_product": "dot",
    "euclidean": "l2",
}


def canonical_metric(name: str) -> str:
    """Alias-resolve and validate a metric name."""
    m = METRIC_ALIASES.get(name, name)
    if m not in METRICS:
        known = sorted(set(METRICS) | set(METRIC_ALIASES))
        raise ValueError(f"unknown metric {name!r} (known: {known})")
    return m

# ---------------------------------------------------------------------------
# pairwise (Q, d) x (N, d) -> (Q, N) forms
# ---------------------------------------------------------------------------


def pairwise_l2_sq(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Via the |q|^2 - 2 q.c + |c|^2 expansion, clamped at 0."""
    qn = torch.sum(q * q, dim=-1)[:, None]
    dn = torch.sum(db * db, dim=-1)[None, :]
    return torch.clamp_min(qn - 2.0 * (q @ db.T) + dn, 0.0)


def pairwise_chi2(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    return chi2(q[:, None, :], db[None, :, :])


def pairwise_dot(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    return -(q @ db.T)


def pairwise_cosine(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    return 1.0 - normalize_rows(q) @ normalize_rows(db).T


PAIRWISE: dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "l2": pairwise_l2_sq,
    "chi2": pairwise_chi2,
    "dot": pairwise_dot,
    "cosine": pairwise_cosine,
}


def pairwise(q: torch.Tensor, db: torch.Tensor, metric: str = "l2"
             ) -> torch.Tensor:
    """(Q, d) x (N, d) -> (Q, N) distances under ``metric``."""
    return PAIRWISE[metric](q, db)


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Unit-normalize rows (the paper normalizes MNIST vectors to norm 1)."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + EPS)
