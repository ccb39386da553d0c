"""Carry a forest built elsewhere into the port.

``forest_from_numpy`` takes the eight ``Forest`` fields of the reference
package as numpy arrays -- for example ``jax.device_get(index.forest)`` --
and ``index_from_numpy`` wraps them with their rows as a queryable ``rpf``
index without building one, so both packages can query the same forest.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.forest import Forest
from repro_torch.device import resolve_device
from repro_torch.index.api import get_backend
from repro_torch.index.params import IndexSpec

_DTYPES = {"proj_idx": torch.int32, "proj_coef": torch.float32,
           "thresh": torch.float32, "child_base": torch.int32,
           "perm": torch.int32, "leaf_offset": torch.int32,
           "leaf_count": torch.int32, "n_nodes": torch.int32}


def forest_from_numpy(arrays: Mapping[str, Any] | Any,
                      device: str | torch.device | None = None) -> Forest:
    """The port's ``Forest`` from a mapping (or NamedTuple) of the eight
    field arrays, on ``device`` (the GPU unless ``device="cpu"``)."""
    dev = resolve_device(device)
    if hasattr(arrays, "_asdict"):
        arrays = arrays._asdict()
    missing = set(Forest._fields) - set(arrays)
    if missing:
        raise KeyError(f"forest arrays lack {sorted(missing)}")
    return Forest(**{
        name: torch.tensor(np.asarray(arrays[name]), dtype=_DTYPES[name],
                           device=dev)
        for name in Forest._fields})


def index_from_numpy(db, forest_arrays, spec: IndexSpec,
                     device: str | torch.device | None = None):
    """A queryable ``rpf`` index over rows ``db`` (N, d) and a forest built
    over exactly those rows with ``spec.forest``."""
    dev = resolve_device(device)
    rows = torch.as_tensor(np.asarray(db, np.float32), device=dev)
    forest = forest_from_numpy(forest_arrays, dev)
    if forest.perm.shape[1] != rows.shape[0]:
        raise ValueError(f"forest indexes {forest.perm.shape[1]} rows, db "
                         f"holds {rows.shape[0]}")
    if forest.n_trees != spec.forest.n_trees:
        raise ValueError(f"forest has {forest.n_trees} trees, spec says "
                         f"{spec.forest.n_trees}")
    cls = get_backend(spec.backend)
    return cls(cls.engine_cls(spec, rows.contiguous(), forest=forest), spec)
