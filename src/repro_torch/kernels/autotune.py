"""Measured autotuning of the tap kernels' plans, with a persistent cache.

Counterpart of ``repro.kernels.autotune``.  On the TPU the thing to tune
is the VMEM tile; on the card the tiles are fixed and a plan is the
kernel's tile variant and split-K count (:class:`~repro_torch.kernels.
tap_gemm.Plan`).  The analytic rules (``tap_gemm.analytic_plan``) are an
occupancy model, and the card disagrees with it at small shapes.  When
``config.autotune`` is on, :func:`repro_torch.kernels.ops.pass_plan`
routes through :func:`tuned_plan`:

    analytic plan (a plan that cannot launch is never tuned)
      -> in-process memo
      -> persistent JSON plan cache (key: schema | role | the card's name
         | compute capability | SM count | build of the kernels | ConvDims
         | groups | operand type) -> revalidate via
         ``ops.plan_from_entry`` (a plan that no longer launches =>
         "stale")
      -> mode "measure": time the top-k candidates (``ops.plan_candidates``)
         on the card, persist the winner atomically;
         mode "cached": never time -- persisted winners when present, the
         analytic plan otherwise.

A candidate's time is device time (``kernels/timing.py``: warm calls, then
a CUDA graph of back-to-back calls replayed between CUDA events), the best
of ``config.autotune_reps`` replays: wall clock would rank candidates by
their launch cost, which is the same for all of them and larger than the
kernels at the training shapes.  Operands are built once per candidate
from the ConvDims and freed after.

The cache file lives under ``$XDG_CACHE_HOME/repro_torch/plan_cache``
(``config.plan_cache_dir`` overrides), is written atomically (tmp +
``os.replace``), and tolerates corrupt files and stale entries: a bad
entry re-tunes, it never crashes.  A plan timed on one card, or on one
build of the kernels, is never served to another.

Every resolution is observable: plans carry ``autotuned`` /
``measured_us`` / ``candidates_timed`` / ``cache``
(``hit|miss|stale|poisoned``), surfaced by ``ops.plan_report`` and counted
in ``ops.plan_events()`` as ``{role}_autotune_{hit,miss,stale,poisoned,
measure_failed}`` (and on the obs bus as ``plan`` events).
:func:`poison_plan` marks an entry that must not be served again (the
conv dispatch calls it when a kernel pass raises); a candidate that
raises while timed is counted and skipped.  The store's read and write and
the timing harness are the fault sites ``plan_cache.read`` (absorbed as a
cold cache), ``plan_cache.write`` (absorbed with the warning) and
``autotune.measure`` (inside an ``autotune:measure`` span).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import warnings
from typing import NamedTuple

import torch

from repro_torch.core.config import config
from repro_torch.core.im2col_ref import ConvDims
from repro_torch.ft.inject import InjectedFault, fault_point
from repro_torch.kernels import build, ops, timing
from repro_torch.kernels import tap_gemm as tg
from repro_torch.obs import trace as obs_trace

#: bump when the key layout or entry payload changes; older files are
#: ignored wholesale (equivalent to a cold cache).
CACHE_SCHEMA = 2

_CACHE_FILE = "plan_cache.json"

#: back-to-back calls in each timed CUDA-graph replay.
CALLS = 10

#: key -> annotated plan; dropped by config changes (clear_memo).
_MEMO: dict[str, tg.Plan] = {}


def clear_memo() -> None:
    """Drop the in-process tuned-plan memo (NOT the on-disk cache)."""
    _MEMO.clear()


# ---------------------------------------------------------------------------
# Persistent store
# ---------------------------------------------------------------------------

def default_cache_dir() -> str:
    """``config.plan_cache_dir`` when set, else
    ``$XDG_CACHE_HOME/repro_torch/plan_cache`` (``~/.cache`` when the
    variable is unset)."""
    if config.plan_cache_dir is not None:
        return config.plan_cache_dir
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(base, "repro_torch", "plan_cache")


def cache_path() -> str:
    return os.path.join(default_cache_dir(), _CACHE_FILE)


def _load_store() -> dict:
    """The on-disk store, or a fresh one on any read/parse/schema problem
    (a corrupt cache is a cold cache, never an error; so is a fault at the
    ``plan_cache.read`` site)."""
    try:
        fault_point("plan_cache.read")
        with open(cache_path(), encoding="utf-8") as f:
            store = json.load(f)
        if (isinstance(store, dict) and store.get("schema") == CACHE_SCHEMA
                and isinstance(store.get("entries"), dict)):
            return store
    except (OSError, ValueError, InjectedFault):
        pass
    return {"schema": CACHE_SCHEMA, "entries": {}}


def _save_store(store: dict) -> None:
    """Atomic best-effort write (tmp + ``os.replace``); an unwritable
    cache dir (or a fault at the ``plan_cache.write`` site) degrades to
    tuning every process, not to a crash."""
    path = cache_path()
    try:
        fault_point("plan_cache.write")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(store, f, indent=0, sort_keys=True)
        os.replace(tmp, path)
    except (OSError, InjectedFault) as e:
        warnings.warn(f"plan cache not persisted ({e}); will re-tune next "
                      f"process", RuntimeWarning, stacklevel=2)


class Card(NamedTuple):
    """What of the card a plan's time depends on."""
    name: str
    capability: tuple[int, int]
    sms: int


@functools.cache
def card(device: torch.device) -> Card:
    props = torch.cuda.get_device_properties(device)
    return Card(props.name, (props.major, props.minor),
                props.multi_processor_count)


@functools.cache
def build_id() -> str:
    """The kernels' build: the hash of their sources and compiler flags."""
    return build.source_hash()


def plan_key(role: str, d: ConvDims, groups: int, card_: Card,
             dtype=torch.float32) -> str:
    """Stable identity of one planning problem.  The card (name, compute
    capability, SM count), the build of the kernels and the operands' type
    (another kernel instance) are part of it: a plan timed on one card,
    one build or one type is never served to another."""
    d = ops._canonical(d)
    dims = ",".join(f"{f.name}={getattr(d, f.name)}"
                    for f in dataclasses.fields(d))
    major, minor = card_.capability
    return (f"v{CACHE_SCHEMA}|{role}|{card_.name}|sm_{major}{minor}"
            f"|sms={card_.sms}|build={build_id()}|{dims}|groups={groups}"
            f"|dtype={ops._dtype_key(dtype)}")


# ---------------------------------------------------------------------------
# Timing harness
# ---------------------------------------------------------------------------

def _run_fn(role: str, d: ConvDims, groups: int, plan: tg.Plan,
            device: torch.device, dtype=torch.float32):
    """A zero-arg call of ``role``'s kernel under ``plan`` on operands of
    ``dtype`` built once from ``d``.  Dummy operands: timing is
    data-independent."""
    x = torch.ones(d.B, d.C * groups, d.H_i, d.W_i, device=device,
                   dtype=dtype)
    w = torch.ones(d.N * groups, d.C, d.k_taps_h, d.k_taps_w, device=device,
                   dtype=dtype)
    dy = torch.ones(d.B, d.N * groups, d.H_o, d.W_o, device=device,
                    dtype=dtype)
    if role == "forward":
        src, wt, taps = ops.forward_operands(x, w, d, groups)
        return lambda: tg.tap_gemm(src, wt, taps, d.H_o, d.W_o, plan)
    if role == "input_grad":
        src, ws, pp = ops.input_grad_operands(dy, w, d, groups)
        return lambda: tg.tap_gemm_phased(src, ws, pp.phase_taps, pp.n_qh,
                                          pp.n_qw, plan)
    if role == "weight_grad":
        src, dyn, taps = ops.weight_grad_operands(x, dy, d, groups)
        return lambda: tg.tap_wgrad(src, dyn, taps, d.H_o, d.W_o, plan)
    raise ValueError(
        f"unknown plan role {role!r}; roles: {ops.PLAN_ROLES}")


def measure_plan(role: str, d: ConvDims, groups: int, plan: tg.Plan,
                 device, reps: int | None = None,
                 dtype=torch.float32) -> float:
    """Device time of one call of ``role``'s kernel under ``plan`` on
    operands of ``dtype``, in MICROSECONDS: the best of ``reps``
    (``config.autotune_reps``) CUDA-graph replays of :data:`CALLS`
    back-to-back calls (``timing.replay_ms``), inside an
    ``autotune:measure`` span; the ``autotune.measure`` fault site comes
    first (the candidate loop counts a raise as ``measure_failed``)."""
    reps = config.autotune_reps if reps is None else reps
    with obs_trace.span(
            "autotune:measure", role=role, reps=reps, variant=plan.variant,
            splits=plan.splits,
            dims=[d.B, d.C, d.H_i, d.W_i, d.N, d.K_h, d.K_w]):
        fault_point("autotune.measure")
        fn = _run_fn(role, d, groups, plan, torch.device(device), dtype)
        return min(timing.replay_ms(fn, max(1, reps), CALLS, warm=1)) * 1e3


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------

def tuned_plan(role: str, d: ConvDims, groups: int, device,
               analytic: tg.Plan, dtype=torch.float32) -> tg.Plan:
    """The tuned (or cache-served, or annotated-analytic) plan for one
    planning problem on ``device`` with operands of ``dtype``.
    ``analytic`` is the analytic plan and launches (``ops.pass_plan`` never
    routes one that cannot)."""
    key = plan_key(role, d, groups, card(torch.device(device)), dtype)
    hit = _MEMO.get(key)
    if hit is not None:
        return hit

    store = _load_store()
    entry = store["entries"].get(key)
    if entry is not None and not isinstance(entry, dict):
        entry = {}                        # garbage: stale below
    state = "miss"
    if entry is not None and entry.get("poisoned"):
        # poison_plan marked this entry: never serve the persisted plan
        # again.  "cached" degrades to the analytic plan; "measure"
        # re-tunes, and the fresh winner overwrites the mark.
        ops._count_event(f"{role}_autotune_poisoned")
        if config.autotune != "measure":
            plan = dataclasses.replace(analytic, cache="poisoned")
            _MEMO[key] = plan
            return plan
        entry = None
        state = "poisoned"
    if entry is not None:
        plan = ops.plan_from_entry(role, d, groups, entry.get("plan"),
                                   dtype)
        try:
            plan = plan and dataclasses.replace(
                plan, autotuned=True,
                measured_us=float(entry.get("measured_us", -1.0)),
                candidates_timed=int(entry.get("candidates_timed", 0)),
                cache="hit")
        except (TypeError, ValueError):
            plan = None
        if plan is not None:
            ops._count_event(f"{role}_autotune_hit")
            _MEMO[key] = plan
            return plan
        state = "stale"                   # no longer launches, or garbage
    if state != "poisoned":               # poisoned already counted above
        ops._count_event(f"{role}_autotune_{state}")

    if config.autotune != "measure":      # "cached": never time
        plan = dataclasses.replace(analytic, cache=state)
        _MEMO[key] = plan
        return plan

    cands = ops.plan_candidates(role, d, groups, config.autotune_top_k,
                                device, dtype) or [analytic]
    best, best_us, timed = None, float("inf"), 0
    for cand in cands:
        try:
            us = measure_plan(role, d, groups, cand, device, dtype=dtype)
        except Exception:
            # A candidate that fails to launch or to be captured must not
            # kill tuning for the whole problem: counted, skipped.
            ops._count_event(f"{role}_autotune_measure_failed")
            continue
        timed += 1
        if us < best_us:
            best, best_us = cand, us
    if best is None:                      # every candidate failed
        plan = dataclasses.replace(analytic, cache=state)
        _MEMO[key] = plan
        return plan
    best = dataclasses.replace(best, autotuned=True, measured_us=best_us,
                               candidates_timed=timed, cache=state)
    store["entries"][key] = {"plan": list(best.key),
                             "measured_us": best_us,
                             "candidates_timed": timed}
    _save_store(store)
    _MEMO[key] = best
    return best


def poison_plan(role: str, d: ConvDims, groups: int, device,
                dtype=torch.float32) -> str:
    """Poison-mark the persisted plan-cache entry of one planning problem:
    whatever plan it holds is not served again -- ``autotune="cached"``
    takes the analytic plan for the key, ``autotune="measure"`` re-tunes
    (a fresh measurement overwrites the mark).  Returns the key."""
    key = plan_key(role, d, groups, card(torch.device(device)), dtype)
    _MEMO.pop(key, None)
    store = _load_store()
    entry = store["entries"].get(key) or {}
    store["entries"][key] = {**entry, "poisoned": True}
    _save_store(store)
    return key
