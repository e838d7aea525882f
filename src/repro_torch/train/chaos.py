"""Chaos drill: train the CNN while the fault injector kills the tap
kernels mid-run and poisons one step's gradients, and assert the stack
degrades EXACTLY as designed (the port's ``examples/train_chaos.py``).

    python -m repro_torch.train.chaos                 # on the card
    python -m repro_torch.train.chaos --device cpu    # plain versions
    python -m repro_torch.train.chaos --trace t.json --metrics m.jsonl

Timeline (fault spec ``pallas.*:raise@step3;grad.values:nan@step5``, with
``QUARANTINE_PROBE_AFTER`` lowered to 2 so the whole arc fits a short run;
the model, data and SGD of :mod:`repro_torch.train.cnn_bp` under
``pallas``):

    step 3     every tap-kernel pass raises ``InjectedFault`` before it
               launches; the dispatch layer re-runs it on ``bp_phase``
               (``pass:pallas->bp_phase`` events) and quarantines
               ``pallas`` for each (pass, geometry)
    steps 4-5  quarantined: ``pallas`` is skipped (``pass:pallas:
               quarantined``), nothing launches
    step 5     the gradient VALUES are NaN-poisoned; the loop's numerical
               guard drops the update (params untouched)
    step 6     recovery probe: ``pallas`` runs again, succeeds, and the
               quarantine is lifted (``pass:pallas:probe`` +
               ``pass:pallas:recovered``)
    then       disarm and run two more steps: no fault may fire

Every expected count is asserted exactly, computed from ``resolve_engine``
over the passes the port dispatches: the images need no grad, so the
first conv's input grad is never dispatched (``ctx.needs_input_grad``).
``main(argv)`` returns a summary dict and restores the config and
``QUARANTINE_PROBE_AFTER`` it changed.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import conv
from repro_torch.core.config import config
from repro_torch.core.convspec import ConvSpec
from repro_torch.device import resolve_device
from repro_torch.ft import inject
from repro_torch.ft.failures import GuardState
from repro_torch.train.cnn_bp import init_params, make_model, synthetic_task
from repro_torch.tree import tree_leaves, tree_map

FAULT_SPEC = "pallas.*:raise@step3;grad.values:nan@step5"
PASSES = ("forward", "input_grad", "weight_grad")
#: steps the drill's timeline needs (fault at 3, probe at 6, one after).
MIN_STEPS = 8


def cnn_layers(batch: int):
    """The CNN's three convs: (x shape, w shape, spec, x needs a grad)."""
    return [
        ((batch, 3, 16, 16), (16, 3, 3, 3),
         ConvSpec.make(stride=2, padding=1), False),
        ((batch, 16, 8, 8), (16, 1, 3, 3),
         ConvSpec.make(stride=1, padding=1, groups=16), True),
        ((batch, 16, 8, 8), (32, 16, 3, 3),
         ConvSpec.make(stride=2, padding=1), True),
    ]


def expected_pallas_passes(batch: int, device=None) -> dict[str, int]:
    """How many (pass, layer) pairs a step dispatches to ``pallas`` on
    ``device``: the port's resolver over the passes autograd runs."""
    n = {p: 0 for p in PASSES}
    for xs, ws, spec, x_grad in cnn_layers(batch):
        d = conv.spec_dims(xs, ws, spec)
        for p in PASSES:
            if p == "input_grad" and not x_grad:
                continue
            if conv.resolve_engine("pallas", p, d, False, spec.groups,
                                   device)[0] == "pallas":
                n[p] += 1
    return n


def drill_params(device=None):
    """The drill's starting parameters: ``cnn_bp.init_params`` drawn on
    the CPU (seed 0) and moved to ``device``, so a run on the card starts
    from the values a CPU run does (a CUDA generator draws others) and the
    drill's progress check reads the same trajectory on both."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), init_params(device="cpu"))


def train_loop(policy="pallas", steps: int = 14, batch: int = 32,
               lr: float = 0.05, device=None, params=None, log=None,
               disarmed_steps: int = 0) -> dict:
    """The drill's SGD loop under whatever fault spec is armed: the
    injection clock set each step, ``grad.values`` through the injector,
    the guard dropping a non-finite step.  Then ``disarmed_steps`` more
    steps with the injector disarmed.  Returns ``{"losses" (every step's
    loss, dropped ones too), "bad_steps", "guard", "fired" (the faults
    fired while armed), "disarmed_losses", "fired_disarmed", "params"}``;
    ``params`` defaults to :func:`drill_params` and is updated in
    place."""
    dev = resolve_device(device)
    params = drill_params(dev) if params is None else params
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    _, loss_fn = make_model(policy)
    rng = np.random.RandomState(0)
    gs = GuardState(clip_after=2, rollback_after=4)
    losses, bad_steps = [], []
    for step in range(steps):
        inject.set_step(step)
        x, y = synthetic_task(rng, batch, device=dev)
        loss = loss_fn(params, x, y)
        grads = list(torch.autograd.grad(loss, leaves))
        grads = inject.fault_point("grad.values", value=grads)
        gnorm = torch.stack([g.square().sum() for g in grads]).sum()
        loss_f, gnorm_f = float(loss.detach()), math.sqrt(float(gnorm))
        bad = not (math.isfinite(loss_f) and math.isfinite(gnorm_f))
        action = gs.observe(bad)
        if bad:
            bad_steps.append(step)
            if log:
                log(f"[chaos] step={step} non-finite gradients dropped "
                    f"(action={action})")
        else:
            with torch.no_grad():
                for p, g in zip(leaves, grads):
                    p.sub_(lr * g)
        losses.append(loss_f)
        obs.metrics.train_step(step, {"loss": loss_f, "grad_norm": gnorm_f,
                                      "guard_bad": float(bad)})
        if log and (step % 2 == 0 or step == steps - 1):
            log(f"[chaos] step={step:3d} loss={loss_f:.4f}")
    out = {"losses": losses, "bad_steps": bad_steps, "guard": vars(gs),
           "fired": inject.fired_events(), "disarmed_losses": [],
           "fired_disarmed": []}
    if disarmed_steps:
        with config.override(fault_spec=None):
            inject.reset_events()
            for _ in range(disarmed_steps):
                x, y = synthetic_task(rng, batch, device=dev)
                loss = loss_fn(params, x, y)
                grads = torch.autograd.grad(loss, leaves)
                with torch.no_grad():
                    for p, g in zip(leaves, grads):
                        p.sub_(lr * g)
                out["disarmed_losses"].append(float(loss.detach()))
            out["fired_disarmed"] = inject.fired_events()
    out["params"] = params
    return out


def check_drill(res: dict, n_pallas: dict[str, int], steps: int) -> None:
    """The drill's assertions on a :func:`train_loop` run under
    :data:`FAULT_SPEC` (fired events read before the disarmed steps)."""
    ev = conv.dispatch_events()
    n_total = sum(n_pallas.values())
    degrade = {k: v for k, v in ev.items() if "->" in k}
    assert sum(degrade.values()) == n_total, \
        f"expected {n_total} runtime failure edges, got {degrade}"
    for p in PASSES:
        if n_pallas[p] == 0:
            continue
        assert ev.get(f"{p}:pallas->bp_phase", 0) == n_pallas[p], ev
        q = ev.get(f"{p}:pallas:quarantined", 0)
        assert q == 2 * n_pallas[p], \
            f"{p}: expected {2 * n_pallas[p]} quarantined skips, got {q}"
        assert ev.get(f"{p}:pallas:probe", 0) == n_pallas[p], ev
        assert ev.get(f"{p}:pallas:recovered", 0) == n_pallas[p], ev
        # Every armed step but the faulted and the two quarantined ones
        # ran on pallas (the probe step among them), and every disarmed
        # step.
        assert ev.get(f"{p}:pallas", 0) == n_pallas[p] * (
            steps - 3 + len(res["disarmed_losses"])), ev
    assert not conv.quarantined_engines(), conv.quarantined_engines()
    fired = res["fired"]
    raises = [f for f in fired if f["action"] == "raise"]
    nans = [f for f in fired if f["action"] == "nan"]
    assert len(raises) == n_total and all(f["step"] == 3 for f in raises), \
        (len(raises), n_total)
    assert len(nans) == 1 and nans[0]["site"] == "grad.values" \
        and nans[0]["step"] == 5, nans
    assert res["bad_steps"] == [5], res["bad_steps"]
    assert res["guard"]["total_bad"] == 1 and res["guard"]["rollbacks"] == 0, \
        res["guard"]
    rf = conv.runtime_failures()
    assert len(rf) == n_total and all(
        f["exception"] == "InjectedFault" and f["survivor"] == "bp_phase"
        for f in rf), rf
    losses = res["losses"]
    assert all(math.isfinite(v) for v in losses), "non-finite loss leaked"
    kept = [v for i, v in enumerate(losses) if i not in res["bad_steps"]]
    half = len(kept) // 2
    assert np.mean(kept[half:]) < np.mean(kept[:half]), \
        "training made no progress through the faults"
    assert all(bool(torch.isfinite(p).all())
               for p in tree_leaves(res["params"])), "non-finite params"
    assert res["fired_disarmed"] == [], res["fired_disarmed"]
    assert all(math.isfinite(v) for v in res["disarmed_losses"])


def check_obs(rep: dict, n_pallas: dict[str, int], trace_path, metrics_path,
              steps: int) -> None:
    """The same arc on the obs bus, annotated conv spans in the trace and
    a ``train_step`` line a step in the metrics."""
    assert rep["consistent"], (
        "telemetry divergence: " + "; ".join(rep["divergences"]))
    bus = obs.events.counters("dispatch")
    assert bus == conv.dispatch_events(), (bus, conv.dispatch_events())
    for p in PASSES:
        if n_pallas[p] == 0:
            continue
        for arc in (f"{p}:pallas->bp_phase", f"{p}:pallas:quarantined",
                    f"{p}:pallas:probe", f"{p}:pallas:recovered"):
            assert bus.get(arc, 0) > 0, (arc, bus)
    if trace_path:
        with open(trace_path) as f:
            doc = json.load(f)
        conv_spans = [e for e in doc["traceEvents"]
                      if e["ph"] == "B" and e["name"].startswith("conv:")]
        assert conv_spans, "no conv dispatch spans in the trace"
        for span in conv_spans:
            assert "skip_ratio" in span["args"] and \
                "bytes_moved" in span["args"], span
    if metrics_path:
        with open(metrics_path) as f:
            lines = [json.loads(ln) for ln in f]
        assert len(lines) == steps and \
            all(ln["kind"] == "train_step" for ln in lines), len(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=14)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; never falls back)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable telemetry and write a Perfetto trace_event "
                         "JSON; the drill then also asserts the arc on the "
                         "obs bus and the conv spans' skip_ratio / "
                         "bytes_moved annotations")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="enable telemetry and stream a train_step JSONL "
                         "line a step to PATH")
    args = ap.parse_args(argv)
    if args.steps < MIN_STEPS:
        raise SystemExit(f"the fault timeline needs at least {MIN_STEPS} "
                         f"steps, got {args.steps}")
    dev = resolve_device(args.device)
    telemetry = {}
    if args.trace or args.metrics:
        telemetry = {"telemetry": True, "trace_path": args.trace,
                     "metrics_path": args.metrics}
    probe_after = conv.QUARANTINE_PROBE_AFTER
    conv.QUARANTINE_PROBE_AFTER = 2       # arc: fail@3, skip@4-5, probe@6
    try:
        with config.override(fault_spec=FAULT_SPEC, fault_seed=0,
                             **telemetry):
            # One reset covering every introspection surface (dispatch
            # events, decisions, quarantine, fired faults, the obs bus).
            obs.reset_all()
            n_pallas = expected_pallas_passes(args.batch, dev)
            n_total = sum(n_pallas.values())
            if n_total == 0:
                raise SystemExit("no pass resolves to pallas; the drill "
                                 "is vacuous")
            print(f"[chaos] armed: {FAULT_SPEC!r}; pallas passes per step: "
                  f"{n_pallas}")
            res = train_loop("pallas", args.steps, args.batch, args.lr, dev,
                             log=print, disarmed_steps=2)
            check_drill(res, n_pallas, args.steps)
            rep = None
            if obs.enabled():
                rep = obs.finalize()
                check_obs(rep, n_pallas, args.trace, args.metrics,
                          args.steps)
                print(f"[chaos] obs ok: {rep['events_total']} bus events, "
                      f"{rep['trace']['events']} trace events, "
                      f"{rep['metrics']['lines']} metrics lines")
            summary = {"n_pallas": n_pallas, "losses": res["losses"],
                       "bad_steps": res["bad_steps"],
                       "disarmed_losses": res["disarmed_losses"],
                       "dispatch_events": conv.dispatch_events(),
                       "runtime_failures": conv.runtime_failures(),
                       "fired": res["fired"], "obs": rep}
    finally:
        conv.QUARANTINE_PROBE_AFTER = probe_after
    print(f"[chaos] ok: {n_total} pallas passes degraded and recovered, "
          f"1 NaN step dropped, final loss {res['losses'][-1]:.4f}, "
          f"zero faults when disarmed")
    return summary


if __name__ == "__main__":
    main()
