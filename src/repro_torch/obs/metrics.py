"""Per-step metrics stream: one JSON line per training step / serve tick
(counterpart of ``repro.obs.metrics``, the same line shapes).

Active iff ``config.telemetry`` is on AND ``config.metrics_path`` is set;
every emitter starts with the ``if _STREAM is None: return`` disarmed
check (the ``ft/inject.py`` idiom).  Tensor values become floats only
while the stream is active: a disarmed run adds no ``.item()`` and no
device synchronization.

Line shapes (all lines carry ``ts`` and ``kind``):

``kind="train_step"`` -- per optimizer step: ``step``, ``loss``,
    ``grad_norm``, guard state (``guard_bad``/``guard_streak``/
    ``guard_clipped``), wall ``step_s``, the conv ``dispatch_mix``
    (engine -> dispatch count so far) and the hit rate of the analytic
    plan memo (``plan_cache_hit_rate``; None while no plan was asked for,
    as on the CPU).

``kind="serve_tick"`` -- per decode tick of either serving engine:
    ``engine``, ``decode_steps``, ``tokens``, lane ``occupancy``,
    ``decode_tok_s``, latency ``p50_s``/``p99_s`` over finalized
    requests, ``timed_out``/``failed`` counts.

The file is JSONL, flushed per line, so a crashed run keeps everything
emitted before the crash.
"""

from __future__ import annotations

import json
import sys
import time

MAX_LATENCIES = 100_000

_STREAM = None                 # open file object, or None == off
_PATH: str | None = None
_LINES = 0
_LATENCIES: list[float] = []   # finalized-request latencies (seconds)


def active() -> bool:
    return _STREAM is not None


def emit(kind: str, **payload) -> None:
    """Write one metrics line.  Free (one ``is None`` check) when off."""
    global _LINES
    if _STREAM is None:
        return
    line = {"ts": time.time(), "kind": kind}
    line.update(payload)
    _STREAM.write(json.dumps(line) + "\n")
    _STREAM.flush()
    _LINES += 1


def train_step(step: int, metrics: dict, *, step_s: float | None = None,
               **extra) -> None:
    """Per-training-step line.  ``metrics`` is the train step's metrics
    dict (loss / grad_norm / lr / guard_*; tensors or numbers); the
    dispatch mix and the plan memo's hit rate are sampled from the live
    counters (through sys.modules: emitting metrics must not import the
    kernel stack)."""
    if _STREAM is None:
        return
    payload: dict = {"step": int(step)}
    for key in ("loss", "grad_norm", "lr", "guard_bad", "guard_streak",
                "guard_clipped"):
        if key in metrics:
            payload[key] = float(metrics[key])
    if step_s is not None:
        payload["step_s"] = round(float(step_s), 6)
    conv = sys.modules.get("repro_torch.core.conv")
    if conv is not None:
        mix: dict[str, int] = {}
        for name, n in conv.dispatch_events().items():
            parts = name.split(":")
            if len(parts) == 2 and "->" not in parts[1]:
                mix[parts[1]] = mix.get(parts[1], 0) + n
        payload["dispatch_mix"] = mix
    ops = sys.modules.get("repro_torch.kernels.ops")
    if ops is not None:
        info = ops.plan_cache_info()
        total = info.hits + info.misses
        payload["plan_cache_hit_rate"] = (
            round(info.hits / total, 4) if total else None)
    payload.update(extra)
    emit("train_step", **payload)


def record_latency(latency_s: float) -> None:
    """Register one finalized request latency for the serve percentiles."""
    if _STREAM is None:
        return
    if len(_LATENCIES) < MAX_LATENCIES:
        _LATENCIES.append(latency_s)


def _percentile(sorted_vals: list[float], q: float) -> float | None:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return round(sorted_vals[idx], 6)


def serve_tick(engine) -> None:
    """Per-decode-tick line for either serving engine (they share the
    counters/stats vocabulary, see ``serve/engine.py run_summary``)."""
    if _STREAM is None:
        return
    c, st = engine.counters, engine.stats
    decode_steps = c.get("decode_steps", 0)
    lane_steps = st.get("lane_steps", 0)
    occupancy = (lane_steps / (decode_steps * engine.max_batch)
                 if decode_steps else 0.0)
    decode_s = st.get("decode_s", 0.0)
    lat = sorted(_LATENCIES)
    emit("serve_tick",
         engine=getattr(engine, "engine_kind", "?"),
         decode_steps=decode_steps,
         tokens=st.get("tokens", 0),
         occupancy=round(occupancy, 4),
         decode_tok_s=round(st.get("tokens", 0) / decode_s, 2)
         if decode_s else None,
         p50_s=_percentile(lat, 0.50),
         p99_s=_percentile(lat, 0.99),
         completed=c.get("completed", 0),
         timed_out=c.get("timed_out", 0),
         failed=c.get("failed", 0))


def lines_written() -> int:
    return _LINES


def summary() -> dict:
    return {"active": _STREAM is not None, "path": _PATH, "lines": _LINES,
            "latencies": len(_LATENCIES)}


def reset_window() -> None:
    """Clear the in-memory aggregation window (latencies).  Does not touch
    the output file."""
    _LATENCIES.clear()


def close() -> None:
    global _STREAM, _PATH
    if _STREAM is not None:
        _STREAM.close()
        _STREAM = None
        _PATH = None


def sync_from_config() -> None:
    """Open/close/rotate the JSONL stream to match the config."""
    global _STREAM, _PATH, _LINES
    from repro_torch.core.config import config
    want = config.metrics_path if config.telemetry else None
    if want == _PATH and (want is None) == (_STREAM is None):
        return
    close()
    if want is not None:
        _STREAM = open(want, "w")
        _PATH = want
        _LINES = 0
        _LATENCIES.clear()


sync_from_config()
