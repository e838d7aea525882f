"""The result line and the checks on the process that prints it."""

from __future__ import annotations

import json
import sys

#: top-level module names that may not be loaded in a run: JAX and the
#: JAX package the port was made from (``repro``; the port, ``repro_torch``,
#: is another name).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check_lines(checks) -> list[str]:
    return [f"check {name} = {value!r} (limit {limit!r}) "
            f"{'ok' if value <= limit else 'FAILED'}"
            for name, value, limit in checks]


def _num(v):
    """A number for JSON: a non-finite one as its name."""
    return v if v == v and abs(v) != float("inf") else str(v)


def line(correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, checks, breakdown: dict | None = None) -> str:
    """The JSON object of the last line of standard output; the compared
    numbers come last, under ``checks``."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": _num(value), "limit": limit}
                     for name, value, limit in checks}
    return json.dumps(out)
