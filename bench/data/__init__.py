"""See ``bench/__init__.py``."""
from __future__ import annotations

import torch


def structure_generator(params: dict, device) -> torch.Generator:
    """The generator of the distribution's structure (its prototypes),
    seeded with the configuration's ``structure_seed``: every run draws its
    rows and queries from the run's seed, out of one distribution, as a
    deployment serves one dataset."""
    return torch.Generator(device=device).manual_seed(
        params["structure_seed"])
