"""Deterministic, config-driven fault injection (counterpart of
``repro.ft.inject``; ``repro_torch.core.config.fault_spec``).

Every failure domain of the port registers a NAMED SITE through the one
:func:`fault_point` helper -- the tap kernels' launches, the plan-cache
read/write, the tuner's timing harness, the checkpoint writer/reader, the
train step's gradient values, and the continuous serving engine's
per-request prefill / per-lane decode (a crashing lane finalizes that
request with ``status="failed"`` instead of killing the batch).  A fault
spec arms rules against those sites:

    config.update(fault_spec="pallas.*:raise@step3;grad.values:nan@step5")

Grammar (``;``-separated rules), the JAX package's::

    <site-glob>:<action>[@step<N> | @<N>][~p<P>]

``site-glob``  fnmatch pattern over :data:`KNOWN_SITES` (must match >= 1)
``action``     ``raise`` -- raise :class:`InjectedFault` at the site;
               ``nan``   -- poison the value passing through the site
                            (floating tensors multiplied by NaN)
``@stepN``     fire only when the injection clock (:func:`set_step`, driven
               by the train loop and the continuous engine) equals ``N``;
               omitted = every step
``~pP``        fire with probability ``P`` from a ``random.Random`` seeded
               by ``config.fault_seed`` at arm time -- deterministic per
               (spec, seed)

Free when disarmed: :func:`fault_point` is a single ``is None`` check.
The injector records every firing (:func:`fired_events`, also emitted on
the obs bus) and every site it saw while armed (:func:`seen_sites`).

The config singleton re-arms the injector whenever ``fault_spec`` /
``fault_seed`` change, and this module syncs once at import, so either
import order works.

The port runs eagerly, so every site fires on the exact step its rule
names; ``grad.values`` goes through :func:`value_fault_steps` and
:func:`nan_factor` as in the JAX train step, with the step a Python int:
the decision is the host's and costs the device nothing.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import random
import re

import torch

from repro_torch.core.config import config
from repro_torch.obs import events as obs_events
from repro_torch.tree import tree_map

#: every registered fault site (the JAX package's 11).  Adding a
#: ``fault_point`` call to a new failure domain means adding its name here.
KNOWN_SITES = frozenset({
    "pallas.forward.launch",      # kernels/ops.py: forward tap_gemm launch
    "pallas.input_grad.launch",   # kernels/ops.py: tap_gemm_phased launch
    "pallas.weight_grad.launch",  # kernels/ops.py: tap_wgrad launch
    "plan_cache.read",            # kernels/autotune.py: plan-cache read
    "plan_cache.write",           # kernels/autotune.py: atomic cache write
    "autotune.measure",           # kernels/autotune.py: candidate timing
    "ckpt.write",                 # ckpt/checkpoint.py: manifest+leaf writer
    "ckpt.read",                  # ckpt/checkpoint.py: restore
    "grad.values",                # train loops: the gradient tree itself
    "serve.prefill",              # serve/continuous.py: per-request prefill
    "serve.decode",               # serve/continuous.py: per-lane decode step
})

ACTIONS = ("raise", "nan")


class InjectedFault(RuntimeError):
    """The exception :func:`fault_point` raises for a ``raise`` rule."""

    def __init__(self, site: str, rule: "FaultRule"):
        super().__init__(f"injected fault at {site!r} "
                         f"(rule {rule.pattern}:{rule.action}, "
                         f"step {current_step()})")
        self.site = site
        self.rule = rule


def absorbs(exc: BaseException, device) -> bool:
    """Whether a degradation site may absorb ``exc`` raised on ``device``.

    On the card only an :class:`InjectedFault` is absorbed: a kernel that
    fails to build or launch there is a fault of the port and must fail
    the run, never be served by a slower engine under its name.  Off the
    card every exception is absorbed, as in the JAX package."""
    return isinstance(exc, InjectedFault) or \
        torch.device(device).type != "cuda"


@dataclasses.dataclass(frozen=True)
class FaultRule:
    pattern: str              # fnmatch glob over site names
    action: str               # "raise" | "nan"
    step: int | None = None   # None: every step
    prob: float = 1.0         # < 1.0: seeded coin flip per match


_RULE = re.compile(
    r"^(?P<pattern>[\w.*?\[\]-]+):(?P<action>\w+)"
    r"(?:@(?:step)?(?P<step>\d+))?"
    r"(?:~p(?P<prob>[0-9.]+))?$")


def parse_fault_spec(spec: str) -> tuple[FaultRule, ...]:
    """Parse a ``fault_spec`` string into rules; raises ValueError on bad
    grammar, unknown actions, or a pattern matching no known site."""
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        m = _RULE.match(part)
        if m is None:
            raise ValueError(
                f"bad fault rule {part!r}; expected "
                "'<site-glob>:<action>[@stepN][~pP]'")
        action = m.group("action")
        if action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r} in {part!r}; "
                f"actions: {ACTIONS}")
        pattern = m.group("pattern")
        if not any(fnmatch.fnmatchcase(s, pattern) for s in KNOWN_SITES):
            raise ValueError(
                f"fault pattern {pattern!r} matches no known site; sites: "
                f"{sorted(KNOWN_SITES)}")
        prob = float(m.group("prob")) if m.group("prob") else 1.0
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"fault probability {prob} not in [0, 1]")
        rules.append(FaultRule(
            pattern=pattern, action=action,
            step=int(m.group("step")) if m.group("step") else None,
            prob=prob))
    return tuple(rules)


# -- armed state -------------------------------------------------------------

_ARMED: tuple[FaultRule, ...] | None = None
_RNG = random.Random(0)
_STEP = 0
_FIRED: list[dict] = []
_SEEN: set[str] = set()
_MAX_FIRED = 4096


def arm(spec: str, seed: int = 0) -> tuple[FaultRule, ...]:
    """Arm the injector with ``spec`` (validated); reseeds the probability
    stream so a (spec, seed) pair fires deterministically."""
    global _ARMED, _RNG
    rules = parse_fault_spec(spec)
    _ARMED = rules or None
    _RNG = random.Random(seed)
    return rules


def disarm() -> None:
    global _ARMED
    _ARMED = None


def armed_rules() -> tuple[FaultRule, ...]:
    return _ARMED or ()


def sync_from_config() -> None:
    """(Re-)arm from ``config.fault_spec`` / ``config.fault_seed``; called
    by the config singleton on updates and by this module at import."""
    spec = config.fault_spec
    if spec:
        arm(spec, seed=config.fault_seed)
    else:
        disarm()


def set_step(step: int) -> None:
    """Advance the injection clock: the train loop calls this once a step,
    the continuous engine once a decode step, so ``@stepN`` rules target
    exact steps.  One clock for the process: a run that does both resets
    it."""
    global _STEP
    _STEP = int(step)


def current_step() -> int:
    return _STEP


def fired_events() -> list[dict]:
    """Every fault fired since the last :func:`reset_events`."""
    return list(_FIRED)


def seen_sites() -> set[str]:
    """Sites that executed :func:`fault_point` while the injector was
    armed (arm a never-firing rule, exercise each failure domain, compare
    against :data:`KNOWN_SITES`)."""
    return set(_SEEN)


def reset_events() -> None:
    _FIRED.clear()
    _SEEN.clear()
    # Keep the bus's fault stream in lockstep with _FIRED (no-op when off).
    obs_events.drop("fault")


def _record(name: str, action: str, step: int, pattern: str) -> None:
    if len(_FIRED) < _MAX_FIRED:
        _FIRED.append({"site": name, "action": action, "step": step,
                       "pattern": pattern})
        obs_events.emit("fault", name, action=action, step=step,
                        pattern=pattern)


def _poison(value):
    """NaN-poison every floating tensor of ``value`` (a tensor or a tree
    of them; other leaves and ``None`` pass through untouched)."""
    if value is None:
        return None
    return tree_map(lambda a: a * float("nan") if torch.is_tensor(a)
                    and a.is_floating_point() else a, value)


def fault_point(name: str, value=None):
    """THE fault site: every failure domain calls this with its site name.

    Disarmed (the default): returns ``value`` after one ``is None`` check.
    Armed: the site is recorded as seen, matching ``raise`` rules raise
    :class:`InjectedFault`, and matching ``nan`` rules return a
    NaN-poisoned copy of ``value``.
    """
    if _ARMED is None:
        return value
    if name not in KNOWN_SITES:
        raise ValueError(
            f"unregistered fault site {name!r}; add it to "
            f"repro_torch.ft.inject.KNOWN_SITES (sites: "
            f"{sorted(KNOWN_SITES)})")
    _SEEN.add(name)
    for rule in _ARMED:
        if not fnmatch.fnmatchcase(name, rule.pattern):
            continue
        if rule.step is not None and rule.step != _STEP:
            continue
        if rule.prob < 1.0 and _RNG.random() >= rule.prob:
            continue
        _record(name, rule.action, _STEP, rule.pattern)
        if rule.action == "raise":
            raise InjectedFault(name, rule)
        value = _poison(value)
    return value


def value_fault_steps(name: str, action: str = "nan") \
        -> tuple[int | None, ...] | None:
    """The steps at which armed ``action`` rules target ``name`` -- or
    None when disarmed / nothing matches (the JAX train step's call)."""
    if _ARMED is None:
        return None
    _SEEN.add(name)
    steps = tuple(r.step for r in _ARMED
                  if r.action == action
                  and fnmatch.fnmatchcase(name, r.pattern))
    return steps or None


def nan_factor(step: int, steps: tuple[int | None, ...]) -> float:
    """The gradient multiplier of train step ``step``: NaN when it matches
    any of ``steps`` (``None`` = every step), else 1.0.  A step that fires
    is recorded like any other firing of ``grad.values`` (pattern
    ``"<train step>"``)."""
    for s in steps:
        if s is None or s == step:
            _record("grad.values", "nan", int(step), "<train step>")
            return float("nan")
    return 1.0


# Adopt any fault spec the config already carries (env var, or an update()
# that ran before this module was imported).
sync_from_config()
