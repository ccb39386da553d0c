"""The comparison that decides ``correct``: the program's answers against
the reference's.

Search answers (one query's (distances, ids) row, k long), against the
reference's top-k computed in float64 from its own forest:

  id_faults  count of slots whose id is -1 where the reference has one (or
             the reverse), lies outside the rows, is not among the query's
             candidates in the reference's forest, or repeats in its row;
             exact, limit 0
  rank_gap   the widest gap between the float64 distance of the id the
             program puts at rank r and the reference's rank-r distance,
             over the query's k-th reference distance
  dist_err   the widest gap between the distance the program returns and
             the float64 distance of the id it returns, over the same scale

A forest (set-up's, or a rebuild's): ``forest_diff``, the entries in which
the program's arrays differ from the reference's build from the same rows
and seed; exact, limit 0.

Every number is reported beside its limit; a number that is not finite is
reported as 1e300, which fails every limit.
"""
from __future__ import annotations

import math

import torch

from bench.reference.search import distance

HUGE = 1e300


def finite(x: float) -> float:
    return float(x) if math.isfinite(x) else HUGE


def search_numbers(p_dist: torch.Tensor, p_ids: torch.Tensor,
                   queries: torch.Tensor, rows: torch.Tensor,
                   r_dist: torch.Tensor, r_ids: torch.Tensor,
                   cand: torch.Tensor, metric: str) -> dict:
    """The three numbers of one block of answers (all (B, k) but ``cand``,
    the reference's (B, M) candidates with -1 slots)."""
    n = rows.shape[0]
    p_ids = p_ids.long()
    r_ids = r_ids.long()
    p_ok = (p_ids >= 0) & (p_ids < n)
    r_ok = r_ids >= 0
    faults = (p_ids >= 0) != r_ok
    faults |= p_ids >= n
    cs = torch.sort(cand.long(), dim=1)[0]
    pos = torch.searchsorted(cs, p_ids.clamp(0, n - 1).contiguous())
    found = torch.gather(cs, 1, pos.clamp(max=cs.shape[1] - 1)) == p_ids
    faults |= p_ok & ~found
    ps, order = torch.sort(torch.where(p_ok, p_ids, -1 - torch.arange(
        p_ids.shape[1], device=p_ids.device)), dim=1)
    rep = torch.zeros_like(p_ok)
    rep[:, 1:] = (ps[:, 1:] == ps[:, :-1]) & (ps[:, 1:] >= 0)
    faults |= torch.zeros_like(rep).scatter_(1, order, rep)

    e = distance(queries.double()[:, None, :],
                 rows[p_ids.clamp(0, n - 1)].double(), metric)
    last = torch.where(r_ok, r_dist.double(), float("-inf")).amax(dim=1)
    scale = torch.where(torch.isfinite(last) & (last > 0), last, 1.0)[:, None]
    both = p_ok & r_ok
    gap = torch.where(both, (e - r_dist.double()).abs() / scale, 0.0)
    err = torch.where(p_ok, (p_dist.double() - e).abs() / scale, 0.0)
    return {"id_faults": int(faults.sum()),
            "rank_gap": finite(float(gap.max()) if gap.numel() else 0.0),
            "dist_err": finite(float(err.max()) if err.numel() else 0.0)}


def merge(acc: dict, new: dict) -> dict:
    """Counts add up, widest gaps take the larger."""
    out = dict(acc)
    for key, value in new.items():
        if key not in out:
            out[key] = value
        elif isinstance(value, int):
            out[key] += value
        else:
            out[key] = max(out[key], value)
    return out


def verdict(numbers: dict, limits: dict) -> list[dict]:
    """[{name, value, limit, ok}] for every number; each must have a
    limit."""
    out = []
    for name, value in numbers.items():
        if name not in limits:
            raise KeyError(f"no limit for the compared number {name!r}")
        out.append({"name": name, "value": value, "limit": limits[name],
                    "ok": bool(value <= limits[name])})
    return out
