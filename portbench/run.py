"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix,
driver and per-layer metrics are found by name (``lib/bench.py``).  A run:

1. set-up (timed as ``setup_s``, from the start of this script): the
   driver makes the inputs from ``--seed`` on the card, builds what the
   program needs and runs the steps that warm every shape the window
   uses;
2. the window: steps dispatched back to back for ``--seconds`` seconds
   by the host clock, then one ``synchronize()``; the rate is the work of
   every step over the whole time, the memory peak the window's;
3. with ``--trace 1``, after the window, three stretches of the
   traffic's ``trace_steps`` / ``enqueue_steps`` steady steps: under
   ``torch.profiler`` tracing the device only, so that the host runs as
   in the window (busy and idle time, the device operations that take
   most time); under the profiler tracing the host too, with the
   program's spans on (``config.telemetry``: the device time of the conv
   spans, the idle gaps with what the host was doing); and steps each
   started after a ``synchronize()`` whose conv spans time the host's
   enqueue.  The per-layer metrics' readers take their numbers from these
   and from the window;
4. the program's state is freed, and what the timed path produced is
   compared with the plain reference (``check`` of the cell's
   ``drivers/`` module).

The last line of standard output is the result (``lib/result.py``), the
compared numbers beside their limits the last lines of standard error.
The run fails, and prints no result, without a card, or when JAX or the
JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench.lib import bench, compare, profile, result  # noqa: E402


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""
    cell: object                 # the driver's cell object
    window: dict                 # steps, seconds, units of the window
    stretch: profile.Stretch | None = None        # device only
    spans_stretch: profile.Stretch | None = None  # with the host's ranges
    stretch_steps: int = 0
    conv_spans: list = dataclasses.field(default_factory=list)
    enqueue_ms: list = dataclasses.field(default_factory=list)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _spans(path: str) -> list[dict]:
    """The program's exported spans as ``{name, args, start, end}`` (µs)."""
    from repro_torch import obs
    obs.trace.export(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    open_, out = {}, []
    for e in events:
        key = (e["tid"], e["name"])
        if e["ph"] == "B":
            open_.setdefault(key, []).append(e)
        elif e["ph"] == "E":
            b = open_[key].pop()
            out.append({"name": e["name"], "args": b.get("args", {}),
                        "start": b["ts"], "end": e["ts"]})
    return sorted(out, key=lambda s: s["start"])


def _traced(c, cell: bench.Cell, device, ctx: Context) -> None:
    """The traced stretches of a ``--trace 1`` run (module docstring)."""
    from repro_torch import obs
    from repro_torch.core.config import config
    n = int(cell.traffic["trace_steps"])
    _sync(device)
    with profile.traced(device, host=False) as quiet:
        for _ in range(n):
            c.step()
    ctx.stretch, ctx.stretch_steps = quiet.stretch, n
    path = os.path.join(tempfile.gettempdir(),
                        f"portbench-spans-{os.getpid()}.json")
    config.update(telemetry=True, trace_path=path)
    try:
        obs.trace.reset()
        with profile.traced(device, host=True) as held:
            for _ in range(n):
                c.step()
        ctx.spans_stretch = held.stretch
        ctx.conv_spans = [s for s in _spans(path)
                          if s["name"].startswith("conv:")]
        obs.trace.reset()
        for _ in range(int(cell.traffic.get("enqueue_steps", 0))):
            _sync(device)
            with obs.trace.span("portbench:step"):
                c.step()
        spans = _spans(path)
        for s in spans:
            if s["name"] == "portbench:step":
                inside = [t for t in spans if t["name"].startswith("conv:")
                          and s["start"] <= t["start"] <= s["end"]]
                ctx.enqueue_ms.append(
                    sum(t["end"] - t["start"] for t in inside) * 1e-3)
    finally:
        config.update(telemetry=False, trace_path=None)


def run_cell(cell: bench.Cell, seed: int, seconds: float, trace: bool,
             device, t0: float | None = None, program=None) -> dict:
    """One run of ``cell``; returns the fields of the result line.
    ``program``, a factory, replaces the driver's program (its controls
    and faults, ``portbench/calibrate.py``)."""
    import torch
    device = torch.device(device)
    cuda = device.type == "cuda"
    t0 = time.perf_counter() if t0 is None else t0
    drv = cell.driver()
    c = drv.Cell(cell.config, cell.traffic, seed, device,
                 **({} if program is None else {"program": program}))
    c.setup()
    _sync(device)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    n0 = c.steps
    start = time.perf_counter()
    while True:
        c.step()
        if time.perf_counter() - start >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - start
    steps = c.steps - n0
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    e2e = {"setup_s": setup_s, "peak_mem_gib": window_peak / 2 ** 30,
           drv.RATE_METRIC: c.units_per_step * steps / window_s}
    ctx = Context(c, {"steps": steps, "seconds": window_s,
                      "units": c.units_per_step * steps})
    t_traced = time.perf_counter()
    if trace:
        _traced(c, cell, device, ctx)
    t_check = time.perf_counter()
    failed = c.failed_steps()
    memory_peak = max(setup_peak, window_peak,
                      torch.cuda.max_memory_allocated(device) if cuda else 0)
    c.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = c.check()
    _sync(device)
    print(f"portbench: {cell.name} seed {seed}: set-up {setup_s:.3f} s, "
          f"window {window_s:.3f} s ({steps} steps), traced "
          f"{t_check - t_traced:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = bench.load_module(cell.root, "metrics",
                                      m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if trace and ctx.stretch is not None:
        dev.update(busy_s=ctx.stretch.busy_s, window_s=ctx.stretch.window_s)
        breakdown = {"device_ops": ctx.stretch.device_ops,
                     "idle_gaps": ctx.spans_stretch.idle_gaps}
    return {"correct": compare.judge(checks), "attempted": steps,
            "failed": failed, "metrics": metrics, "device": dev,
            "checks": checks, "breakdown": breakdown,
            "details": getattr(c, "details", None)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cell = bench.resolve(args.workload)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"portbench: the program (src/repro_torch) is not in {ROOT}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; this benchmark runs on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda", T0)
    bad = result.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for text in result.check_lines(out["checks"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(result.line(out["correct"], out["attempted"], out["failed"],
                      out["metrics"], out["device"], out["checks"],
                      out["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
