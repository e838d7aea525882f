"""The serving request record shared by both engines (a copy of
``repro.serve.request``).

A request's lifecycle is submit -> (queue wait) -> prefill -> decode ->
finalize.  ``status`` records how it ended:

``"ok"``         completed with ``len(out) == max_new`` (or hit the
                 engine's ``max_len`` ceiling with partial output)
``"timed_out"``  its ``deadline_s`` wall-clock budget expired -- at
                 admission time (never decoded) or mid-stream (keeps the
                 tokens generated so far)
``"failed"``     its prefill or its decode lane crashed (for example an
                 armed ``serve.prefill`` / ``serve.decode`` fault in the
                 continuous engine) -- the request is finalized with its
                 partial output instead of the crash killing the batch

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
