"""Fault tolerance of the port: the fault injector (``inject``) and the
bookkeeping of ``failures``."""

from repro_torch.ft import inject  # noqa: F401  (fault-injection harness)
from repro_torch.ft.failures import (GuardState, HeartbeatTable,  # noqa: F401
                                     RestartPlan, StragglerDetector,
                                     elastic_mesh, make_guard_restart_plan,
                                     make_restart_plan)
