"""Fault tolerance bookkeeping: heartbeats, straggler detection, restart plan
(the port's copy of ``repro.ft.failures``, pure Python).

On a real cluster the coordinator runs outside the training framework; here
the same logic is a small deterministic library driven by the train loop:

  * HeartbeatTable -- per-worker liveness with a deadline; dead workers
    produce a RestartPlan (which mesh to rebuild, which checkpoint to load,
    which data step to resume from -- exact, thanks to the step-addressable
    pipeline).
  * StragglerDetector -- per-step wall-time EWMA; a worker slower than
    ``threshold`` x the fleet median for ``patience`` consecutive steps is
    flagged for preemptive eviction (slow-node mitigation, not just crash
    recovery).
  * ElasticPlan -- given survivors, choose the largest (data, model) mesh
    with model-dim preserved (TP degree must divide attention heads), so
    resumption reloads the host-gathered checkpoint onto the new mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class RestartPlan:
    failed_workers: list[int]
    resume_step: int
    mesh_shape: tuple[int, ...]
    note: str


class HeartbeatTable:
    """Per-worker liveness with a deadline.

    Intended semantics: a worker is dead when more than ``timeout_s`` has
    elapsed since its LAST heartbeat, where a worker that has never beaten
    counts as having beaten at table creation (``t0``) -- a freshly built
    fleet gets the full ``timeout_s`` grace period to report in, instead of
    being declared dead at t=0 before it had any chance to beat.

    ``t0`` / ``beat(t=)`` / ``dead(now=)`` take an explicit clock for
    deterministic tests; the default clock is ``time.monotonic()`` (do not
    mix the two in one table).
    """

    def __init__(self, n_workers: int, timeout_s: float = 60.0,
                 t0: Optional[float] = None):
        self.n = n_workers
        self.timeout = timeout_s
        self.t0 = time.monotonic() if t0 is None else t0
        self.last: dict[int, float] = {}

    def beat(self, worker: int, t: Optional[float] = None):
        self.last[worker] = time.monotonic() if t is None else t

    def dead(self, now: Optional[float] = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [w for w in range(self.n)
                if now - self.last.get(w, self.t0) > self.timeout]


class StragglerDetector:
    def __init__(self, n_workers: int, threshold: float = 1.5,
                 patience: int = 5, alpha: float = 0.2):
        self.n = n_workers
        self.threshold = threshold
        self.patience = patience
        self.alpha = alpha
        self.ewma = [0.0] * n_workers
        self.strikes = [0] * n_workers

    def observe(self, step_times: list[float]) -> list[int]:
        """Feed per-worker step wall-times; returns workers to evict."""
        for w, t in enumerate(step_times):
            self.ewma[w] = (t if self.ewma[w] == 0.0
                            else (1 - self.alpha) * self.ewma[w]
                            + self.alpha * t)
        med = sorted(self.ewma)[self.n // 2]
        evict = []
        for w in range(self.n):
            if med > 0 and self.ewma[w] > self.threshold * med:
                self.strikes[w] += 1
                if self.strikes[w] >= self.patience:
                    evict.append(w)
            else:
                self.strikes[w] = 0
        return evict


def elastic_mesh(survivors: int, model_dim: int,
                 heads: int) -> tuple[int, int]:
    """Largest (data, model) mesh from `survivors` chips keeping TP valid.

    Model dim is kept if it still divides the head count; otherwise it is
    halved until it does.  Data dim = survivors // model, rounded to a
    power-of-two fraction so collectives stay ring-friendly.
    """
    m = model_dim
    while m > 1 and (heads % m != 0 or survivors < m):
        m //= 2
    d = survivors // m
    # round data dim down to a power of two for ring all-reduce regularity
    p = 1
    while p * 2 <= d:
        p *= 2
    return (p, m)


@dataclasses.dataclass
class GuardState:
    """Loop-side escalation ladder for non-finite training steps.

    The guard inside ``train_step`` (``make_train_step(guard=...)``)
    already DROPS a non-finite update on the device -- params and optimizer
    state pass through unchanged -- and engages the tighter gradient clip
    once the on-device streak reaches ``clip_after``.  This object mirrors
    the streak on the host (feed it ``metrics["guard_bad"]`` every step)
    and decides when to escalate past what the step can do alone:

        'skip'      1 .. clip_after-1 consecutive bad steps (update was
                    dropped on the device; nothing else to do)
        'clip'      clip_after .. rollback_after-1 (the step is now
                    clipping; keep going)
        'rollback'  >= rollback_after -- restore the last committed
                    checkpoint (see :func:`make_guard_restart_plan`) and
                    call :meth:`rolled_back`
    """
    clip_after: int = 2
    rollback_after: int = 4
    bad_streak: int = 0
    total_bad: int = 0
    rollbacks: int = 0

    def observe(self, bad: bool) -> str:
        """Record one step's finiteness; returns the escalation action."""
        if not bad:
            self.bad_streak = 0
            return "ok"
        self.bad_streak += 1
        self.total_bad += 1
        if self.bad_streak >= self.rollback_after:
            return "rollback"
        if self.bad_streak >= self.clip_after:
            return "clip"
        return "skip"

    def rolled_back(self) -> None:
        self.rollbacks += 1
        self.bad_streak = 0


def make_guard_restart_plan(state: GuardState, ckpt_steps: list[int],
                            mesh_shape: tuple[int, ...] = (1, 1)) \
        -> RestartPlan:
    """The RestartPlan of a numerical-guard rollback: no worker died and
    the mesh survives unchanged -- resume from the newest committed
    checkpoint (step 0 / fresh init when none exists)."""
    resume = ckpt_steps[-1] if ckpt_steps else 0
    return RestartPlan(
        failed_workers=[], resume_step=resume, mesh_shape=mesh_shape,
        note=f"numerical guard: {state.bad_streak} consecutive non-finite "
             f"steps ({state.total_bad} total); restore checkpoint "
             f"{resume} and resume")


def make_restart_plan(hb: HeartbeatTable, ckpt_steps: list[int],
                      model_dim: int, heads: int,
                      now: Optional[float] = None) -> Optional[RestartPlan]:
    dead = hb.dead(now)
    if not dead:
        return None
    survivors = hb.n - len(dead)
    mesh = elastic_mesh(survivors, model_dim, heads)
    resume = ckpt_steps[-1] if ckpt_steps else 0
    return RestartPlan(
        failed_workers=dead, resume_step=resume, mesh_shape=mesh,
        note=f"rebuild mesh {mesh} from {survivors} survivors; "
             f"data pipeline resumes at step {resume} deterministically")
