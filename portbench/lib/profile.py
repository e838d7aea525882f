"""Reading a stretch of steps from ``torch.profiler``.

A stretch runs inside one ``record_function`` range named
:data:`STRETCH` and ends in a ``synchronize()``.  The profile is exported
as a Chrome trace under ``TMPDIR``, read and deleted.  A stretch is
profiled in one of two ways:

* device only (``host=False``): the device's operations and the CUDA
  calls that launch them, and nothing of the host's operators, so the
  host runs as in the window.  The stretch is then the interval from the
  first CUDA call to the end of the last (the closing synchronize).  From
  it the device's busy time, the union of every kernel, copy and fill in
  the stretch, and the device operations that took most time;
* with the host (``host=True``): the host's operators and ranges too,
  which slows the host.  From it the device time linked to the program's
  ``conv:*`` spans (each device operation whose launch, a CUDA call
  joined to it by its correlation id, lies inside a ``conv:*`` range on
  the same host thread), and the longest idle gaps with what the host
  was doing (the innermost host range on the stepping thread at the
  gap's middle).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile

import torch

STRETCH = "portbench:stretch"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
HOST_CATS = {"cpu_op", "user_annotation", "python_function"}
#: a device operation's name is cut to this many characters (a template
#: kernel's full name runs to thousands).
NAME_CHARS = 160


@dataclasses.dataclass
class Stretch:
    """What a traced stretch shows, in seconds."""
    window_s: float
    busy_s: float
    device_ops: list          # [[name, seconds]], most time first
    idle_gaps: list           # [[what the host did, seconds]], longest first
    conv_device_s: float      # device time launched inside conv:* ranges
    device_events: int

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


@contextlib.contextmanager
def traced(device, host: bool):
    """Profile the body inside the :data:`STRETCH` range (module
    docstring); yields a holder whose ``.stretch`` is set on exit."""
    from torch.profiler import ProfilerActivity, profile, record_function
    holder = type("Holder", (), {"stretch": None})()
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            yield holder
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    holder.stretch = reduce(events)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events: list[dict], top: int = 10) -> Stretch:
    """The :class:`Stretch` of a Chrome trace's events (times in µs)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == STRETCH
           and e.get("cat") == "user_annotation"]
    calls = [e for e in xs if e.get("cat") in LAUNCH_CATS]
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        tid = win[0].get("tid")
    elif calls:
        w0 = min(float(e["ts"]) for e in calls)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in calls)
        tid = None
    else:
        raise ValueError(f"no {STRETCH!r} range and no CUDA call in the "
                         f"trace")
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    clipped = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]),
                                             w1)) for e in dev]
    busy = _union([c for c in clipped if c[1] > c[0]])
    busy_us = sum(e - s for s, e in busy)

    by_name: dict[str, float] = {}
    for e in dev:
        name = e["name"][:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + float(e["dur"])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    # Launches -> the conv:* range around them on the same thread.
    launches = {}
    for e in calls:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            launches[corr] = (e.get("tid"), float(e["ts"]))
    ranges: dict = {}
    for e in xs:
        if e.get("cat") == "user_annotation" and \
                str(e.get("name", "")).startswith("conv:"):
            ranges.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    starts = {t: ([s for s, _ in sorted(r)], sorted(r))
              for t, r in ranges.items()}
    conv_us = 0.0
    for e in dev:
        corr = (e.get("args") or {}).get("correlation")
        hit = launches.get(corr)
        if hit is None or hit[0] not in starts:
            continue
        s_list, r_list = starts[hit[0]]
        i = bisect.bisect_right(s_list, hit[1]) - 1
        if i >= 0 and r_list[i][0] <= hit[1] <= r_list[i][1]:
            conv_us += float(e["dur"])

    # Idle gaps, labelled by the innermost host range at their middle on
    # the thread that holds the stretch.
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in xs if e.get("cat") in HOST_CATS
            and e.get("tid") == tid and e.get("name") != STRETCH]
    labelled = []
    for s, e in gaps[:top]:
        mid = (s + e) / 2
        inner = [h for h in host
                 if float(h["ts"]) <= mid <= float(h["ts"]) + float(h["dur"])]
        what = min(inner, key=lambda h: float(h["dur"]))["name"] \
            if inner else "host outside any traced range"
        labelled.append([str(what), (e - s) * 1e-6])
    return Stretch(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                   device_ops=[[n, d * 1e-6] for n, d in ops],
                   idle_gaps=labelled, conv_device_s=conv_us * 1e-6,
                   device_events=len(dev))
