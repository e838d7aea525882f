"""Span tracer emitting Chrome/Perfetto ``trace_event`` JSON (counterpart
of ``repro.obs.trace``).

Spans wrap the structural moments of a run -- each conv pass per engine
(annotated with the ConvDims geometry, ``taps{real, materialized}``,
``skip_ratio`` and the modeled ``bytes_moved``), autotune candidate
timing, checkpoint writes, serve prefill/insert/decode and training
steps -- and export as one ``{"traceEvents": [...]}`` file that
chrome://tracing and ui.perfetto.dev load.  While a trace is active each
span also enters ``torch.profiler.record_function(name)``, so the same
names label the host ranges of a ``torch.profiler`` trace.

Disarmed idiom (``ft/inject.py`` contract): the buffer global is ``None``
when tracing is off and :func:`span` returns one shared pre-allocated
null context manager -- no per-call allocation, no timestamp.

Events use the Duration form: paired ``"ph": "B"`` / ``"ph": "E"`` records
per (pid, tid) with microsecond ``ts`` from ``perf_counter``, so nesting
is positional and ``scripts/validate_trace.py`` checks balance.  Spans
read the host clock and never synchronize the device: a conv span
measures the host's enqueue of the pass (the kernel runs later), which is
where the engine resolution, the degradation ladder and the plan lookups
live.
"""

from __future__ import annotations

import json
import os
import threading
import time

from torch.profiler import record_function

MAX_TRACE_EVENTS = 200_000

_BUF: list[dict] | None = None    # None == tracing off (disarmed idiom)
_DROPPED = 0
_PID = os.getpid()


class _NullSpan:
    """The shared do-nothing context manager returned when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "_rf")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args

    def _record(self, event: dict) -> None:
        global _DROPPED
        buf = _BUF
        if buf is not None:
            if len(buf) < MAX_TRACE_EVENTS:
                event.update(name=self.name, pid=_PID,
                             tid=threading.get_ident(),
                             ts=time.perf_counter() * 1e6)
                buf.append(event)
            else:
                _DROPPED += 1

    def __enter__(self):
        self._record({"ph": "B", "args": self.args})
        self._rf = record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        self._record({"ph": "E"})
        return False


def active() -> bool:
    """True when spans are being recorded."""
    return _BUF is not None


def span(name: str, **args):
    """A context manager recording one B/E span pair.  When tracing is off
    this returns the shared null singleton (a single ``is None`` check)."""
    if _BUF is None:
        return _NULL
    return _Span(name, args)


def conv_annotations(d, transposed: bool = False) -> dict:
    """The paper-facing annotation dict for one conv pass: geometry,
    real-vs-materialized taps, zero-space ``skip_ratio`` and the modeled
    compact-layout traffic ``bytes_moved`` (f32 activations + compact
    weights + outputs: the implicit-im2col traffic, NOT a measured
    number).  Equal to the JAX package's for the same ``ConvDims``."""
    real = d.k_taps_h * d.k_taps_w
    if transposed:
        # Mirror-conv identity: the materialized alternative zero-inserts
        # stride phases too, so the denominator is s*K per axis.
        materialized = (d.s_h * d.K_h) * (d.s_w * d.K_w)
    else:
        materialized = d.K_h * d.K_w
    itemsize = 4
    elems = (d.B * d.C * d.H_i * d.W_i          # source activations
             + d.N * d.C * real                 # compact weight taps
             + d.B * d.N * d.H_o * d.W_o)       # outputs
    return {
        "dims": {"B": d.B, "C": d.C, "H_i": d.H_i, "W_i": d.W_i,
                 "N": d.N, "K_h": d.K_h, "K_w": d.K_w,
                 "s_h": d.s_h, "s_w": d.s_w, "D_h": d.D_h, "D_w": d.D_w},
        "taps": {"real": real, "materialized": materialized},
        "skip_ratio": round(1.0 - real / materialized, 6),
        "bytes_moved": elems * itemsize,
    }


def dispatch_span(pkey: str, engine: str, d):
    """Span around one conv engine run (``core/conv.py _execute``).
    ``pkey`` is the dispatch pass key (``forward``/``input_grad``/
    ``weight_grad`` with an ``_T`` suffix for transposed convs)."""
    if _BUF is None:
        return _NULL
    args = {"pass": pkey, "engine": engine}
    args.update(conv_annotations(d, transposed=pkey.endswith("_T")))
    return _Span(f"conv:{pkey}:{engine}", args)


def dropped() -> int:
    return _DROPPED


def summary() -> dict:
    """Shape of the recorded trace (for ``obs.report()``)."""
    buf = _BUF if _BUF is not None else []
    names: dict[str, int] = {}
    for e in buf:
        if e["ph"] == "B":
            key = e["name"].split(":", 1)[0]
            names[key] = names.get(key, 0) + 1
    return {"active": _BUF is not None, "events": len(buf),
            "spans_by_prefix": names, "dropped": _DROPPED}


def export(path: str | None = None) -> str | None:
    """Write the Chrome/Perfetto ``trace_event`` JSON.  ``path`` defaults
    to ``config.trace_path``; returns the path written, or None when
    tracing is off or no path is configured."""
    if _BUF is None:
        return None
    if path is None:
        from repro_torch.core.config import config
        path = config.trace_path
    if path is None:
        return None
    doc = {"traceEvents": list(_BUF),
           "displayTimeUnit": "ms",
           "otherData": {"producer": "repro_torch.obs.trace",
                         "dropped_events": _DROPPED}}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def reset() -> None:
    """Clear the buffer; keeps the active/inactive state."""
    global _BUF, _DROPPED
    if _BUF is not None:
        _BUF = []
    _DROPPED = 0


def sync_from_config() -> None:
    """Tracing is active iff ``telemetry`` is on AND a ``trace_path`` is
    set (spans exist to be exported; the bus alone needs no buffer)."""
    global _BUF
    from repro_torch.core.config import config
    if config.telemetry and config.trace_path:
        if _BUF is None:
            _BUF = []
    else:
        _BUF = None


sync_from_config()
