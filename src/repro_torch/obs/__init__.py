"""Unified telemetry of the port: event bus + span tracer + metrics stream
(counterpart of ``repro.obs``).

One subsystem behind three ``repro_torch.core.config`` fields:

====================  =====================  ==================================
field                 env alias              effect
====================  =====================  ==================================
``telemetry``         ``REPRO_TELEMETRY``    master switch; off (default) is
                                             the zero-overhead disarmed path
``trace_path``        ``REPRO_TRACE_PATH``   Perfetto trace_event JSON output
``metrics_path``      ``REPRO_METRICS_PATH`` per-step metrics JSONL output
====================  =====================  ==================================

Usage::

    from repro_torch.core.config import config
    from repro_torch import obs

    config.update(telemetry=True, trace_path="out.json",
                  metrics_path="m.jsonl")
    ...                        # run: dispatch/plan/fault/serve events flow
    report = obs.finalize()    # writes the trace, closes the stream
    assert not report["divergences"]

The legacy introspection surfaces (``conv.dispatch_events()``,
``ops.plan_events()``, ``inject.fired_events()`` ...) are the source of
truth; with telemetry on, the same chokepoints also emit to the bus, and
:func:`report` cross-checks that every legacy counter agrees with its
bus-backed view (``events.counters(kind)``).
"""

from __future__ import annotations

import sys

from repro_torch.obs import events, metrics, trace

__all__ = ["events", "metrics", "trace", "enabled", "sync_from_config",
           "reset_all", "report", "finalize"]


def enabled() -> bool:
    """True when the event bus is recording (``config.telemetry``)."""
    return events.enabled()


def sync_from_config() -> None:
    """Re-sync all three subsystems from the config (called by
    ``config.update``/``override`` whenever a telemetry field changes)."""
    events.sync_from_config()
    trace.sync_from_config()
    metrics.sync_from_config()


#: every legacy reset surface of the port (module -> functions), reached
#: through sys.modules: a module that was never imported has nothing to
#: reset, and reset_all imports nothing.
_RESET_SURFACES: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("repro_torch.core.conv", ("reset_dispatch_events", "clear_quarantine")),
    ("repro_torch.kernels.ops", ("reset_plan_events",)),
    ("repro_torch.ft.inject", ("reset_events",)),
    ("repro_torch.ckpt.checkpoint", ("reset_skipped_checkpoints",)),
)


def reset_all() -> None:
    """One reset covering every introspection surface of the port: the
    legacy counters (dispatch/plan/fault/quarantine/checkpoint) and the
    obs bus/trace/metrics window.  Does NOT clear the plan memos or the
    tuner's cache (plan state, not introspection state)."""
    for mod_name, fns in _RESET_SURFACES:
        mod = sys.modules.get(mod_name)
        if mod is not None:
            for fn in fns:
                getattr(mod, fn)()
    events.reset()
    trace.reset()
    metrics.reset_window()


def _diff_counters(legacy: dict, view: dict) -> list[str]:
    problems = []
    for name in sorted(set(legacy) | set(view)):
        if legacy.get(name, 0) != view.get(name, 0):
            problems.append(
                f"{name}: legacy={legacy.get(name, 0)} "
                f"bus={view.get(name, 0)}")
    return problems


def report() -> dict:
    """End-of-run summary: event totals by kind, trace/metrics shape, the
    legacy counters, and any divergence between a legacy counter dict and
    its bus-backed view.  Divergences are only checked while telemetry
    is on and the bus has not saturated."""
    conv = sys.modules.get("repro_torch.core.conv")
    ops = sys.modules.get("repro_torch.kernels.ops")
    inject = sys.modules.get("repro_torch.ft.inject")

    divergences: list[str] = []
    if events.enabled() and events.dropped() == 0:
        if conv is not None:
            for p in _diff_counters(conv.dispatch_events(),
                                    events.counters("dispatch")):
                divergences.append(f"dispatch:{p}")
        if ops is not None:
            for p in _diff_counters(ops.plan_events(),
                                    events.counters("plan")):
                divergences.append(f"plan:{p}")
        if inject is not None:
            fired = inject.fired_events()
            n_bus = len(events.events("fault"))
            if len(fired) != n_bus:
                divergences.append(
                    f"fault: legacy fired={len(fired)} bus={n_bus}")

    by_kind = {k: len(events.events(k)) for k in events.KINDS}
    return {
        "telemetry": events.enabled(),
        "events_total": sum(by_kind.values()),
        "events_by_kind": by_kind,
        "events_dropped": events.dropped(),
        "divergences": divergences,
        "consistent": not divergences,
        "trace": trace.summary(),
        "metrics": metrics.summary(),
        "legacy": {
            "dispatch": dict(conv.dispatch_events()) if conv else {},
            "plan": dict(ops.plan_events()) if ops else {},
            "faults_fired": len(inject.fired_events()) if inject else 0,
        },
    }


def finalize() -> dict:
    """End of run: export the trace file (if configured), close the
    metrics stream, and return :func:`report`."""
    rep = report()
    rep["trace_file"] = trace.export()
    metrics.close()
    return rep


sync_from_config()
