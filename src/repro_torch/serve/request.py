"""The serving request record shared by both engines (a copy of
``repro.serve.request``).

A request's lifecycle is submit -> (queue wait) -> prefill -> decode ->
finalize.  ``status`` records how it ended:

``"ok"``         completed with ``len(out) == max_new`` (or hit the
                 engine's ``max_len`` ceiling with partial output)
``"timed_out"``  its ``deadline_s`` wall-clock budget expired -- at
                 admission time (never decoded) or mid-stream (keeps the
                 tokens generated so far)

A failed prefill or decode raises out of the engine: the port has no
fault sites yet and catches nothing (ROADMAP A12).

``t_submit`` / ``t_done`` are engine-clock stamps, so ``t_done - t_submit``
is the request latency.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: wall-clock budget from ``submit()`` in seconds; ``None`` = no limit.
    deadline_s: float | None = None
    status: str = "ok"
    t_submit: float = 0.0
    t_done: float | None = None
