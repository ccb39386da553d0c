"""ISS-595-like rows, made on the device from a generator.

The distribution of the port's ``data/synthetic.iss_like`` (a torch
rewrite, not the same numbers): non-negative d-dimensional histograms, one
sparse prototype per vehicle model (gamma(2, 1) entries, each kept with
probability ``sparsity``, normalized), each row its model's prototype times
gamma(8, 1/8) noise, plus gamma(1.5, 0.002) in 1% of the entries, summing
to 1.  Compared under chi-square.  The prototypes come from the
configuration's ``structure_seed``; rows and queries are drawn alike from
the run's seed, with uniform model labels.
"""
from __future__ import annotations

import torch

from bench.data import structure_generator


def _gamma(shape, alpha: float, scale: float, gen, device) -> torch.Tensor:
    a = torch.full(shape, alpha, dtype=torch.float32, device=device)
    return scale * torch._standard_gamma(a, generator=gen)


def make(params: dict, n: int, n_queries: int, d: int,
         gen: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows (n, d), queries (n_queries, d)) float32 on ``device``."""
    models = params["models"]
    sgen = structure_generator(params, device)
    protos = _gamma((models, d), 2.0, 1.0, sgen, device)
    protos *= torch.rand((models, d), generator=sgen,
                         device=device) < params["sparsity"]
    protos /= protos.sum(dim=1, keepdim=True) + 1e-12

    def sample(m: int) -> torch.Tensor:
        labels = torch.randint(0, models, (m,), generator=gen, device=device)
        x = protos[labels] * _gamma((m, d), 8.0, 1.0 / 8.0, gen, device)
        extra = torch.rand((m, d), generator=gen, device=device) < 0.01
        x += extra * _gamma((m, d), 1.5, 0.002, gen, device)
        x /= x.sum(dim=1, keepdim=True) + 1e-12
        return x

    return sample(n), sample(n_queries)
