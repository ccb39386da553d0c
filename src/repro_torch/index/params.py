"""IndexSpec / SearchParams, the value types of the index API (port of
``repro/index/params.py``), and the capability matrix.

``SearchParams`` keeps the reference's fields, so an operating point carried
across stays valid, and ``capabilities(context)`` gives the reference's
verdicts in each of its three contexts.  The port serves every knob:
``k``, ``metric`` (aliases included), ``mode``, ``dedup``, ``chunk``,
``n_probes``, ``n_trees``, ``expand`` (the int8 shortlist width k' =
expand*k on ``rpf+int8``, which refuses k' = 0 at the search),
``min_candidates`` (the cascade's stopping count on ``lsh-cascade``),
``probe_schedule`` (``core/schedule.py``), ``adaptive_wave`` and ``tol``
(``core/adaptive.py``) and ``filter`` (a ``repro_torch.filter``
predicate); as in the reference, a knob that does not apply to a backend
is inert.

``CAPABILITY_MATRIX`` is the API's contract as the reference states it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.distances import METRIC_ALIASES, METRICS
from repro_torch.core.forest import ForestConfig
from repro_torch.filter.predicate import Predicate
from repro_torch.filter.predicate import from_dict as predicate_from_dict
from repro_torch.kernels.ops import canonical_mode

#: The capability contexts a SearchParams can be checked against:
#: ``local`` (``Index.search`` / ``IndexView.search``), ``sharded`` (a
#: sharded index over a device mesh) and ``serving`` (a serving runtime's
#: batched path).
CONTEXTS = ("local", "sharded", "serving")

# the reference's spelling of a mode the port renames, for dicts read by it
_MODE_OUT = {"kernel": "pallas"}


@dataclasses.dataclass(frozen=True)
class Violation:
    """One capability the given context cannot honor for a params.

    ``str(v)`` renders the message (and hint); structured callers read
    ``knob`` / ``context`` / ``hint``.
    """

    knob: str       # the SearchParams field (or index property) at fault
    context: str    # which CONTEXTS entry rejected it
    message: str    # human text, normally starting "knob=value (...)"
    hint: str = ""  # what to do instead, if anything

    def __str__(self) -> str:
        return self.message + (f" — {self.hint}" if self.hint else "")


class CapabilityError(ValueError):
    """A params asked for capabilities its context cannot honor; carries
    the structured entries in ``.violations``."""

    def __init__(self, violations, context: str = "local",
                 prefix: str = "params cannot be served"):
        self.violations = tuple(violations)
        self.context = context
        super().__init__(
            f"{prefix} [{context}]: "
            + "; ".join(str(v) for v in self.violations))


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Every query-time knob (see ``repro.index.params.SearchParams``).

    mode: auto | kernel | ref ("pallas" is an alias of "kernel").  Unknown
    metric names survive construction and are reported by
    :meth:`capabilities`, which every search path checks.
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
        if self.n_probes < 1:
            raise ValueError(f"n_probes must be >= 1, got {self.n_probes}")
        if self.n_trees < 0:
            raise ValueError(f"n_trees must be >= 0, got {self.n_trees}")
        if self.probe_schedule < 0:
            raise ValueError(f"probe_schedule must be >= 0, got "
                             f"{self.probe_schedule}")
        object.__setattr__(self, "metric",
                           METRIC_ALIASES.get(self.metric, self.metric))

    def capabilities(self, context: str = "local") -> list[Violation]:
        """Capability violations of this operating point in ``context``
        (empty = servable there): the reference's matrix."""
        if context not in CONTEXTS:
            raise ValueError(f"context must be one of {CONTEXTS}, "
                             f"got {context!r}")
        bad: list[Violation] = []
        if self.metric not in METRICS:
            known = sorted(set(METRICS) | set(METRIC_ALIASES))
            bad.append(Violation(
                "metric", context,
                f"metric={self.metric!r} (known: {known})"))
        if self.probe_schedule and self.adaptive_wave:
            bad.append(Violation(
                "probe_schedule", context,
                f"probe_schedule={self.probe_schedule} with "
                f"adaptive_wave={self.adaptive_wave} (pick one "
                f"convergence-gated axis)"))
        if self.filter is not None and not isinstance(self.filter,
                                                      Predicate):
            bad.append(Violation(
                "filter", context,
                f"filter must be a repro_torch.filter Predicate, got "
                f"{type(self.filter).__name__}"))
        if context == "sharded":
            if self.adaptive_wave:
                bad.append(Violation(
                    "adaptive_wave", context,
                    f"adaptive_wave={self.adaptive_wave} (host-side wave "
                    f"loop with a data-dependent round count)"))
            if self.min_candidates != 1:
                bad.append(Violation(
                    "min_candidates", context,
                    f"min_candidates={self.min_candidates} (the lsh "
                    f"cascade is not built sharded)"))
            if self.n_trees:
                bad.append(Violation(
                    "n_trees", context,
                    f"n_trees={self.n_trees} (trees are a build-time "
                    f"shard property)"))
        return bad

    def require(self, context: str = "local") -> "SearchParams":
        """Raise :class:`CapabilityError` unless servable in ``context``;
        returns self so it chains."""
        bad = self.capabilities(context)
        if bad:
            raise CapabilityError(bad, context)
        return self

    def violations(self) -> list[str]:
        """Deprecated shim: ``capabilities("local")`` as strings."""
        return [str(v) for v in self.capabilities("local")]

    def sharded_violations(self) -> list[str]:
        """Deprecated shim: ``capabilities("sharded")`` as strings."""
        return [str(v) for v in self.capabilities("sharded")]

    def sharded(self) -> "SearchParams":
        """This operating point projected onto the sharded-legal knobs:
        ``adaptive_wave=0``, ``min_candidates=1``, ``n_trees=0``; keeps
        ``probe_schedule`` and ``filter``."""
        return dataclasses.replace(self, adaptive_wave=0, min_candidates=1,
                                   n_trees=0)

    def to_dict(self) -> dict[str, Any]:
        """JSON-ready dict in the reference's spelling (``mode="kernel"``
        is written as its alias ``"pallas"``), so either package reads it;
        a predicate serializes through its tagged form."""
        d = dataclasses.asdict(self)
        d["mode"] = _MODE_OUT.get(self.mode, self.mode)
        if self.filter is not None:
            d["filter"] = self.filter.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SearchParams":
        """Inverse of :meth:`to_dict`; unknown keys are ignored, and a
        filter's tagged form (written by either package) rebuilds as a
        ``repro_torch.filter`` predicate."""
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        if d.get("filter") is not None:
            d["filter"] = predicate_from_dict(d["filter"])
        return cls(**d)


# The reference's capability matrix (the API's contract) row for row:
# knob, per-context verdicts, notes.
CAPABILITY_MATRIX: tuple[dict[str, str], ...] = (
    {"knob": "`metric` (l2 / chi2 / cosine / ip)",
     "local": "yes", "sharded": "yes", "serving": "yes",
     "notes": "aliases canonicalize at construction; unknown names are a "
              "violation in every context"},
    {"knob": "`k` / `expand` / `chunk` / `mode` / `dedup`",
     "local": "yes", "sharded": "yes", "serving": "yes",
     "notes": "per-cell knobs: compiled straight into every query step"},
    {"knob": "`n_probes` (fixed multiprobe)",
     "local": "yes", "sharded": "yes", "serving": "yes",
     "notes": "descends each tree once per probe; sharded cells probe "
              "their local trees"},
    {"knob": "`probe_schedule` (per-query probes)",
     "local": "yes", "sharded": "yes — host-scheduled rounds over "
              "per-width mesh steps", "serving": "yes",
     "notes": "does not compose with `adaptive_wave` (same convergence "
              "signal); raw `make_query_fn` compiles one fixed program "
              "and points at `ShardedIndex.search`"},
    {"knob": "`filter` (metadata predicate)",
     "local": "yes", "sharded": "yes — host bitmap ANDed onto the "
              "row-sharded validity argument", "serving": "yes",
     "notes": "needs a metadata-carrying index (a structured "
              "`CapabilityError` names the entry otherwise); never "
              "silently stripped"},
    {"knob": "`adaptive_wave` (tree waves)",
     "local": "yes", "sharded": "no", "serving": "yes",
     "notes": "host wave loop with a data-dependent round count; "
              "`sharded()` neutralizes it"},
    {"knob": "`min_candidates` ≠ 1 (lsh cascade)",
     "local": "yes", "sharded": "no", "serving": "yes",
     "notes": "the lsh cascade is not built sharded; `sharded()` "
              "neutralizes it"},
    {"knob": "`n_trees` (forest prefix)",
     "local": "yes", "sharded": "no", "serving": "yes",
     "notes": "trees are a build-time shard property; `sharded()` "
              "neutralizes it"},
)


def capability_table_md() -> str:
    """Render :data:`CAPABILITY_MATRIX` as a markdown table."""
    lines = [
        "| knob | local `Index.search` | sharded `ShardedIndex.search` | "
        "`ServingRuntime` | notes |",
        "|---|---|---|---|---|",
    ]
    for row in CAPABILITY_MATRIX:
        lines.append(f"| {row['knob']} | {row['local']} | {row['sharded']} "
                     f"| {row['serving']} | {row['notes']} |")
    return "\n".join(lines)


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
    tree_chunk       > 0 builds the forest's trees in chunks of this many
                     (bounds the builder's memory; the forest is the same)
    seed             seed of the builder's generator when none is
                     supplied; the LSH projections' numpy seed
    delta_cap        seal the delta buffer into a sealed segment once it
                     holds this many rows (0: rebuild_frac * sealed rows)
    rebuild_frac     the seal threshold as a share of the sealed rows when
                     delta_cap is 0
    """

    backend: str = "rpf"
    forest: ForestConfig = ForestConfig()
    lsh_radii: tuple[float, ...] = (0.4, 0.53, 0.63, 0.88)
    lsh_tables: int = 10
    lsh_bits: int = 12
    lsh_width_scale: float = 1.0
    tree_chunk: int = 0
    seed: int = 0
    delta_cap: int = 0
    rebuild_frac: float = 0.1

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["forest"] = dict(self.forest._asdict())
        d["lsh_radii"] = list(self.lsh_radii)
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "IndexSpec":
        d = dict(d)
        d["forest"] = ForestConfig(**d.get("forest", {}))
        d["lsh_radii"] = tuple(d.get("lsh_radii", ()))
        return cls(**d)
