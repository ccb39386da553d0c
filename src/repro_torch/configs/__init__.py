"""Architecture registry (port of ``repro/configs/__init__.py``): --arch <id>
-> ArchSpec (config + shape cells).

``mind_bag`` is not an architecture: it holds the MIND history bag's shapes
that ``chip_smoke.py`` gives kernel H.
"""
from __future__ import annotations

from repro_torch.configs import (autoint, dlrm_mlperf, gemma3_4b,
                                 granite_moe_1b, llama4_maverick_400b,
                                 mace_arch, mind, rpf_iss595, rpf_mnist784,
                                 smollm_135m, stablelm_12b, wide_deep)
from repro_torch.configs.base import ArchSpec

_MODULES = [
    llama4_maverick_400b, granite_moe_1b, smollm_135m, stablelm_12b,
    gemma3_4b, mace_arch, mind, dlrm_mlperf, autoint, wide_deep,
    rpf_mnist784, rpf_iss595,
]

REGISTRY: dict[str, ArchSpec] = {m.ARCH.arch_id: m.ARCH for m in _MODULES}

# the 10 assigned architectures (the 2 rpf-* entries are the paper's own)
ASSIGNED = [
    "llama4-maverick-400b-a17b", "granite-moe-1b-a400m", "smollm-135m",
    "stablelm-12b", "gemma3-4b", "mace", "mind", "dlrm-mlperf", "autoint",
    "wide-deep",
]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def list_archs() -> list[str]:
    return sorted(REGISTRY)
