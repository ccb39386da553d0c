"""MNIST-like rows, made on the device from a generator.

The distribution of the port's ``data/synthetic.mnist_like`` (a torch
rewrite, not the same numbers): ``classes`` manifolds in d = side * side
dimensions, each an affine map of a gaussian latent of ``intrinsic``
dimensions (scale 0.35) through gaussian blobs on the side x side grid,
plus ``noise`` times a gaussian, clipped to [0, 1] and unit-normalized, as
the paper normalizes MNIST.  The blobs come from the configuration's
``structure_seed``; rows and queries are drawn alike from the run's seed,
with uniform labels.
"""
from __future__ import annotations

import math

import torch

from bench.data import structure_generator


def _blobs(gen, device, count: int, side: int, lo: float, hi: float,
           s_lo: float, s_hi: float) -> torch.Tensor:
    """(count, side * side) gaussian blobs, centres uniform in [lo, hi),
    widths uniform in [s_lo, s_hi) (s_lo == s_hi: fixed)."""
    c = lo + (hi - lo) * torch.rand((count, 2), generator=gen, device=device)
    s = s_lo + (s_hi - s_lo) * torch.rand((count, 2), generator=gen,
                                          device=device)
    grid = torch.arange(side, dtype=torch.float32, device=device)
    gx = (grid[None, :] - c[:, :1]) ** 2 / (2 * s[:, :1] ** 2)   # (count, x)
    gy = (grid[None, :] - c[:, 1:]) ** 2 / (2 * s[:, 1:] ** 2)   # (count, y)
    return torch.exp(-(gy[:, :, None] + gx[:, None, :])).reshape(count, -1)


def make(params: dict, n: int, n_queries: int, d: int,
         gen: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows (n, d), queries (n_queries, d)) float32 on ``device``."""
    side = int(math.isqrt(d))
    if side * side != d:
        raise ValueError(f"mnist_like needs a square d, got {d}")
    classes, intrinsic = params["classes"], params["intrinsic"]
    sgen = structure_generator(params, device)
    bases = _blobs(sgen, device, classes * intrinsic, side, 4, side - 4,
                   1.5, 5.0).reshape(classes, intrinsic, d)
    mean = 0.5 * _blobs(sgen, device, classes, side, 8, side - 8, 6.0, 6.0)

    def sample(m: int) -> torch.Tensor:
        labels = torch.randint(0, classes, (m,), generator=gen, device=device)
        z = params["latent_scale"] * torch.randn(
            (m, intrinsic), generator=gen, device=device)
        x = mean[labels]
        for c in range(classes):
            sel = (labels == c).nonzero()[:, 0]
            x[sel] += z[sel] @ bases[c]
        x += params["noise"] * torch.randn((m, d), generator=gen,
                                           device=device)
        x.clamp_(0.0, 1.0)
        x /= torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-12
        return x

    return sample(n), sample(n_queries)
