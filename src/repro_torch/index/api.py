"""The index API (port of ``repro/index/api.py``): ``build_index`` and
``Index.search`` over one pristine segment.

``build_index(db, spec)`` dispatches on ``spec.backend`` through the
backend registry; ``Index.search(queries, params)`` goes straight to the
segment's engine, the reference's path for a pristine index
(``IndexView.search``).  Mutation, save/load, tuning and serving are later
slices of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.index.params import IndexSpec, SearchParams

_BACKENDS: dict[str, type["Index"]] = {}


def register_backend(name: str):
    """Class decorator: register an Index subclass under ``name``."""

    def deco(cls: type["Index"]) -> type["Index"]:
        cls.backend = name
        _BACKENDS[name] = cls
        return cls

    return deco


def get_backend(name: str) -> type["Index"]:
    import repro_torch.index.backends  # noqa: F401  (registers on import)
    if name not in _BACKENDS:
        raise KeyError(f"unknown index backend {name!r} (known: "
                       f"{sorted(_BACKENDS)})")
    return _BACKENDS[name]


def build_index(db, spec: IndexSpec | None = None, *,
                device: str | torch.device | None = None,
                generator: torch.Generator | None = None, draws=None,
                **spec_kw) -> "Index":
    """Build an index over ``db`` (N, d) per ``spec`` (or
    ``IndexSpec(**spec_kw)``) on ``device`` (the GPU unless
    ``device="cpu"``).

    The forest draws from ``generator``, else from a generator seeded with
    ``spec.seed``; ``draws`` injects each level's draws instead (see
    ``core.forest.build_forest``).
    """
    spec = spec if spec is not None else IndexSpec(**spec_kw)
    dev = resolve_device(device)
    rows = torch.as_tensor(np.asarray(db, np.float32), device=dev)
    if generator is None and draws is None:
        generator = torch.Generator(device=dev).manual_seed(spec.seed)
    cls = get_backend(spec.backend)
    return cls(cls.engine_cls(spec, rows.contiguous(), generator=generator,
                              draws=draws), spec)


class Index:
    """One pristine segment behind the search surface.

    Subclasses set ``engine_cls``: built as ``engine_cls(spec, rows, ...)``
    and answering ``search(q, params)``.
    """

    backend: str = ""
    engine_cls: type | None = None

    def __init__(self, engine, spec: IndexSpec):
        self.engine = engine
        self.spec = spec

    @property
    def device(self) -> torch.device:
        return self.engine.db.device

    def search(self, queries, params: SearchParams | None = None,
               **params_kw) -> tuple[torch.Tensor, torch.Tensor]:
        """queries (B, d) or (d,) -> (dists (B, k), ids (B, k)) on the
        index's device; invalid slots: +inf / -1."""
        params = params if params is not None else SearchParams(**params_kw)
        params.require()
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        return self.engine.search(torch.atleast_2d(q).contiguous(), params)
