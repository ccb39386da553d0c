"""IndexSpec / SearchParams, the value types of the index API (port of
``repro/index/params.py``).

``SearchParams`` keeps the reference's fields, so an operating point carried
across stays valid.  The port serves ``k``, ``metric`` (aliases
included), ``mode``, ``dedup``, ``chunk``, ``n_probes``, ``n_trees``,
``expand`` (the int8 shortlist width k' = expand*k on ``rpf+int8``) and
``min_candidates`` (the cascade's stopping count on ``lsh-cascade``); as in
the reference, a knob that does not apply to a backend is inert
(``expand`` on ``rpf``, the forest knobs on ``bruteforce`` and
``lsh-cascade``, ``min_candidates`` off ``lsh-cascade``).  The knobs of
later slices raise ``NotImplementedError`` in ``require``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.distances import METRIC_ALIASES, canonical_metric
from repro_torch.core.forest import ForestConfig
from repro_torch.kernels.ops import canonical_mode

# knob -> the ROADMAP.md item that ports it
_NOT_PORTED = {
    "adaptive_wave": "queue 1 item 7 (query knobs: core/adaptive.py)",
    "probe_schedule": "queue 1 item 7 (query knobs: core/schedule.py)",
    "filter": "queue 1 item 7 (query knobs: filter/)",
}


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Every query-time knob (see ``repro.index.params.SearchParams``).

    mode: auto | kernel | ref ("pallas" is an alias of "kernel").
    """

    k: int = 10
    metric: str = "l2"
    mode: str = "auto"
    dedup: bool = True
    expand: int = 4
    adaptive_wave: int = 0
    tol: float = 0.01
    chunk: int = 0
    min_candidates: int = 1
    n_probes: int = 1
    n_trees: int = 0
    probe_schedule: int = 0
    filter: Any = None

    def __post_init__(self):
        object.__setattr__(self, "mode", canonical_mode(self.mode))
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.expand < 1:
            raise ValueError(f"expand must be >= 1, got {self.expand}")
        if self.n_probes < 1:
            raise ValueError(f"n_probes must be >= 1, got {self.n_probes}")
        if self.n_trees < 0:
            raise ValueError(f"n_trees must be >= 0, got {self.n_trees}")
        object.__setattr__(self, "metric",
                           METRIC_ALIASES.get(self.metric, self.metric))

    def require(self) -> "SearchParams":
        """Raise unless this slice of the port can serve these params."""
        canonical_metric(self.metric)
        for knob, item in _NOT_PORTED.items():
            if getattr(self, knob) not in (0, None):
                raise NotImplementedError(
                    f"{knob}={getattr(self, knob)!r} is not ported yet "
                    f"(ROADMAP.md {item})")
        return self


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Build-time description of an index: backend + build config.

    backend          registry key: ``rpf``, ``rpf+int8``, ``lsh-cascade``
                     or ``bruteforce``
    forest           ForestConfig of the forest (rpf backends only)
    lsh_radii        cascade radii, increasing (``lsh-cascade``)
    lsh_tables       tables per cascade level (L)
    lsh_bits         concatenated hashes per table (K)
    lsh_width_scale  bucket width = width_scale * radius
    seed             seed of the builder's generator when none is
                     supplied; the LSH projections' numpy seed
    """

    backend: str = "rpf"
    forest: ForestConfig = ForestConfig()
    lsh_radii: tuple[float, ...] = (0.4, 0.53, 0.63, 0.88)
    lsh_tables: int = 10
    lsh_bits: int = 12
    lsh_width_scale: float = 1.0
    seed: int = 0
