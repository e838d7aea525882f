"""The comparisons that decide ``correct``.

A check is ``(name, value, limit)``; a run is correct when every value is
at most its limit (and not NaN).  The limits are the configuration's
(its ``limits``), set from the readings ``PERF.md`` gives."""

from __future__ import annotations

import math
import statistics

import torch


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest elementwise gap over the largest reference magnitude;
    a shape that differs reads infinite."""
    if got.shape != want.shape:
        return math.inf
    g, w = got.double(), want.double()
    scale = float(w.abs().max())
    gap = float((g - w).abs().max())
    if not math.isfinite(gap):
        return math.inf
    return gap / scale if scale > 0 else (0.0 if gap == 0 else math.inf)


def leaf_gaps(got: dict[str, float], want: dict[str, float],
              keep: set[str] | None = None) -> dict[str, float]:
    """Each leaf's gap between two norms of it: ``|got - want|`` over the
    larger of the leaf's reference norm and the median leaf's (a leaf
    ``got`` lacks reads NaN, so infinite).  ``keep``: the leaves compared
    (default: all)."""
    med = statistics.median(want.values())
    out = {}
    for n in sorted(want if keep is None else keep):
        scale = max(want[n], med)
        d = abs(got.get(n, math.nan) - want[n])
        d = d / scale if scale > 0 else d
        out[n] = d if math.isfinite(d) else math.inf
    return out


def moved_leaves(grad_norms: dict[str, float],
                 floor: float = 1e-3) -> set[str]:
    """The leaves whose reference gradient is more than ``floor`` times
    the median leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(grad_norms.values())
    return {n for n, v in grad_norms.items() if v > floor * med}


def judge(checks: list[tuple[str, float, float]]) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)
