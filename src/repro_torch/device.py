"""Device resolution for the port's entry points: CUDA by default, never a
quiet fall back to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU; without one this raises and names the way out
    (``device="cpu"``) instead of carrying on slowly on the host.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
