"""The structured event bus (counterpart of ``repro.obs.events``).

The port's introspection surfaces (conv ``dispatch_events``, the tuner's
``plan_events``, ``inject.fired_events``, the serve engines' counters,
the guard) each keep their own dict; every recording chokepoint
(``conv._record_event``, ``ops._count_event``, ``inject.fault_point``
...) ALSO calls :func:`emit` here, so a live run sees one ordered,
timestamped, tagged stream, while the legacy dicts stay the source of
truth and behave the same when telemetry is off.

Disarmed idiom (the ``ft/inject.py`` contract): the sink is a module
global that is ``None`` when ``config.telemetry`` is off, and every
:func:`emit` starts with ``if _SINK is None: return``.  No allocation, no
timestamp, no dict on the disabled path.

Consistency contract: the legacy ``reset_*`` functions call :func:`drop`
for their kind (a no-op when disabled), so the bus-backed views
(:func:`counters`) never desync from the legacy dicts under any reset
pattern.  ``repro_torch.obs.report()`` checks this invariant.
"""

from __future__ import annotations

import time

#: registered event kinds -> (emitting modules of the port, description).
#: The kinds and descriptions are the JAX package's; ``emit`` with an
#: unregistered kind raises (when enabled).  ``halo`` is emitted by the
#: mesh-parallel conv (ROADMAP A13), not ported yet.
KINDS: dict[str, tuple[str, str]] = {
    "dispatch": (
        "core/conv.py, dist/conv_parallel.py",
        "engine dispatch, degradation, quarantine/probe/recover, and "
        "mesh lowering drops/fallbacks (the dispatch_events names)"),
    "plan": (
        "kernels/ops.py, kernels/autotune.py",
        "tile-plan outcomes per role (pallas/fallback) and autotune "
        "hit/miss/stale/poisoned/measure_failed"),
    "fault": (
        "ft/inject.py",
        "every injected fault that fired (site, action, step, pattern)"),
    "halo": (
        "dist/conv_parallel.py",
        "per-exchange mesh halo ppermute traffic with modeled byte counts"),
    "serve": (
        "serve/engine.py, serve/continuous.py",
        "request lane lifecycle: admit, insert, wave, finalize with "
        "per-request latency"),
    "ckpt": (
        "ckpt/checkpoint.py",
        "checkpoint writes/restores (step, path, skipped)"),
    "train": (
        "launch/train.py",
        "training-loop level events (guard trips, rollbacks)"),
}

#: hard cap on buffered events; beyond it new events are counted as
#: dropped, never silently lost (report() surfaces the number).
MAX_EVENTS = 65536

_SINK: list[dict] | None = None   # None == telemetry off (disarmed idiom)
_DROPPED = 0
_SEQ = 0


def enabled() -> bool:
    """True when the bus is recording (``config.telemetry`` is on)."""
    return _SINK is not None


def emit(kind: str, name: str, **tags) -> None:
    """Record one event.  Free (a single ``is None`` check) when off."""
    global _SEQ, _DROPPED
    if _SINK is None:
        return
    if kind not in KINDS:
        raise ValueError(
            f"unregistered event kind {kind!r}; known kinds: {tuple(KINDS)}")
    if len(_SINK) >= MAX_EVENTS:
        _DROPPED += 1
        return
    _SEQ += 1
    _SINK.append({"seq": _SEQ, "ts": time.time(), "kind": kind,
                  "name": name, "tags": tags})


def events(kind: str | None = None) -> list[dict]:
    """The recorded events (optionally filtered by kind), oldest first."""
    if _SINK is None:
        return []
    if kind is None:
        return list(_SINK)
    return [e for e in _SINK if e["kind"] == kind]


def counters(kind: str) -> dict[str, int]:
    """Bus-backed counter view: event name -> occurrence count.  For
    ``kind="dispatch"`` / ``"plan"`` this is the shape of the legacy
    ``conv.dispatch_events()`` / ``ops.plan_events()`` dicts, and
    ``repro_torch.obs.report()`` asserts they agree."""
    out: dict[str, int] = {}
    if _SINK is not None:
        for e in _SINK:
            if e["kind"] == kind:
                out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def dropped() -> int:
    """Events discarded because the buffer hit :data:`MAX_EVENTS`."""
    return _DROPPED


def drop(kind: str) -> None:
    """Discard all events of one kind.  Called by the legacy ``reset_*``
    functions (no-op when disabled) so bus views track legacy resets."""
    global _SINK
    if _SINK is not None:
        _SINK = [e for e in _SINK if e["kind"] != kind]


def reset() -> None:
    """Clear the bus (buffer, sequence and dropped count); keeps the
    enabled/disabled state."""
    global _SINK, _DROPPED, _SEQ
    if _SINK is not None:
        _SINK = []
    _DROPPED = 0
    _SEQ = 0


def sync_from_config() -> None:
    """(Re-)arm from ``repro_torch.core.config``: telemetry on installs a
    sink if none is active; telemetry off drops it."""
    global _SINK
    from repro_torch.core.config import config
    if config.telemetry:
        if _SINK is None:
            _SINK = []
    else:
        _SINK = None


sync_from_config()
