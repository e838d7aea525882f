"""Device time of a kernel call on the card, without the host's cost of a call.

A wrapper call costs tens of microseconds of host time (checks, ctypes,
launch) against a few microseconds of device time at the training shapes,
so wall clock, or CUDA events around eager calls, would time the launch.
:func:`replay_ms` captures ``calls`` back-to-back calls in one CUDA graph
(after ``warm`` eager calls, which also build whatever the calls cache) and
times each replay between two CUDA events.  The measured autotuner
(``kernels/autotune.py``) and ``chip_smoke.py`` share it.
"""

from __future__ import annotations

import statistics

import torch


def replay_ms(fn, batches: int, calls: int = 10, warm: int = 3) -> list[float]:
    """Device time per call of ``fn`` in each of ``batches`` replays of a
    CUDA graph of ``calls`` back-to-back calls.  Operands stay warm in L2
    (the same tensors every call).  The capture's errors are thread-local,
    so it also runs on the autograd engine's thread, inside ``backward``;
    a failed capture raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(max(1, warm)):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    return times


def time_ms(fn, batches: int = 10, calls: int = 10, warm: int = 3) -> float:
    """The median of :func:`replay_ms`: device time per call of ``fn``."""
    return statistics.median(replay_ms(fn, batches, calls, warm))
