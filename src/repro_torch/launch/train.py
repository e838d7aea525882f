"""Training launcher: the LM training loop on the card (counterpart of
``repro.launch.train``).

    python -m repro_torch.launch.train --arch smollm-360m
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --device cpu --steps 30 --batch 4 --seq 64 --lr 1e-2 \\
        --ckpt-dir "$(mktemp -d)" --ckpt-every 10

The JAX launcher's loop and flags, with their defaults: the deterministic
data pipeline (a resumed run replays nothing), the train step (default LM
loss, AdamW on the per-model schedule, optional ``--accum`` microbatches),
the numerical guard (on by default: a non-finite step is dropped, a streak
escalates to a tighter clip and then to a rollback to the last committed
checkpoint, or a fresh init without one), step-atomic checkpoints every
``--ckpt-every`` steps and at the end, ``--stop-after`` to stop early
while the schedule still targets ``--steps``, and the heartbeat and
straggler bookkeeping of one worker.  The ``--ckpt-dir`` is resumed from
whatever it holds; a run resumed with no steps left trains nothing and
returns no losses.  The end's save is left out when the last step's
checkpoint was just written (the JAX loop writes the same files again).

``--arch`` takes every architecture of the JAX package: the pipeline
makes the VLM's batches (image embeddings and text) and the audio
encoder's (frames and targets), and minicpm-2b trains on WSD
(``repro_torch.optim.schedule.default_schedule_for``):

    python -m repro_torch.launch.train --arch hubert-xlarge --batch 8 \
        --seq 512 --steps 6

``--conv-policy`` (or the deprecated ``--conv-mode``) sets the model's conv
engines: ``--arch mamba2-370m --conv-policy pallas`` runs every pass of
each layer's depthwise conv on the tap kernels (bf16 at full width).
``--device`` (default: the card, never a fallback) is the port's own.  The
model is initialised from ``--seed`` on the device (on the card from a CUDA
generator: ``repro_torch.models.layers._draw``).
``--autotune`` and ``--plan-cache-dir`` set ``repro_torch.core.config``.
``--fault-spec`` arms the fault injector (``repro_torch.ft.inject``; the
loop sets its clock to the step, so ``grad.values:nan@step2`` poisons
step 2's grads and the guard drops that step); ``--trace PATH`` turns the
telemetry on and writes a Perfetto trace of the run (a ``train:step`` span
a step, conv and checkpoint spans inside it); ``--metrics PATH`` streams
a ``train_step`` JSON line a step (``repro_torch.obs``).  With either, the
introspection counters are reset at the start (``obs.reset_all``) and the
run ends with ``obs.finalize()``, failing when a legacy counter disagrees
with the event bus.

``--conv-mesh POLICY`` trains batch-sharded over the process world, as
the JAX launcher does (``set_activation_policy(batch_axes(mesh, POLICY))``
under ``with mesh:``, mesh ``launch.mesh.make_host_mesh()``: ``(world,
1)`` ``("data", "model")``).  Every rank builds the global batch
(``make_batch`` with one worker), keeps its block under
``dist.sharding.batch_specs`` and runs the forward and backward on that
block only, every conv through ``repro_torch.dist.conv_parallel`` on it;
the step sums the loss and the grads over the batch axes
(``repro_torch.train.train_step``), and the parameters stay replicated.
A batch that does not divide over the batch axes stops the launcher.
Under ``torch.distributed.run`` the launcher starts the process group
from the environment (``nccl`` when each rank has a card of its own,
``gloo`` with host-staged collectives when ranks share one, or on the
CPU), and only rank 0 prints, checkpoints, traces and writes metrics::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch mamba2-370m \
        --conv-policy pallas --conv-mesh dp_only --batch 8 --seq 512

One process gets a ``(1, 1)`` mesh: every role drops, ``mesh:fallback``
is recorded and the step runs unsharded.
"""

from __future__ import annotations

import argparse
import contextlib
import time
import warnings

import torch

from repro_torch import obs
from repro_torch.ckpt import checkpoint as CKPT
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.config import config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import resolve_device
from repro_torch.ft import inject
from repro_torch.ft.failures import (GuardState, HeartbeatTable,
                                     StragglerDetector,
                                     make_guard_restart_plan)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train import train_step as TS


def resolve_conv_policy_args(conv_policy: str | None,
                             conv_mode: str | None) -> str | None:
    """Map the CLI pair onto one policy string; --conv-mode is the
    deprecated uniform spelling and may not be combined with
    --conv-policy."""
    if conv_mode is not None:
        warnings.warn("--conv-mode is deprecated; use --conv-policy "
                      "(same engine names; per-pass via "
                      "fwd=...,dgrad=...,wgrad=...)", DeprecationWarning,
                      stacklevel=2)
        if conv_policy is not None:
            raise SystemExit(
                "pass either --conv-policy or the deprecated --conv-mode, "
                "not both")
        return conv_mode
    return conv_policy


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--stop-after", type=int, default=None,
                    help="simulate preemption: stop at this step while the "
                         "schedule still targets --steps")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--conv-policy", default=None,
                    help="per-pass conv engine policy, e.g. 'auto', "
                         "'pallas' (uniform) or "
                         "'fwd=pallas,dgrad=auto,wgrad=bp_phase' "
                         "(default: cfg.conv_policy)")
    ap.add_argument("--conv-mode", default=None,
                    choices=["lax", "traditional", "bp_im2col", "bp_phase",
                             "pallas"],
                    help="DEPRECATED: uniform spelling of --conv-policy")
    ap.add_argument("--conv-mesh", default=None,
                    choices=["tp", "dp_only", "spatial"],
                    help="mesh-parallel conv lowering over the process "
                         "world (repro_torch.dist.conv_parallel)")
    ap.add_argument("--autotune", default=None,
                    choices=["off", "measure", "cached"],
                    help="measured autotuning of the tap kernels' plans "
                         "(repro_torch.core.config.autotune)")
    ap.add_argument("--plan-cache-dir", default=None,
                    help="persistent plan-cache directory "
                         "(repro_torch.core.config.plan_cache_dir)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-spec", default=None,
                    help="arm the fault injector (config.fault_spec), e.g. "
                         "'grad.values:nan@step5'")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable telemetry and write a Chrome/Perfetto "
                         "trace_event JSON of the run (repro_torch.obs."
                         "trace) to PATH")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="enable telemetry and stream per-step metrics "
                         "JSONL (loss/grad_norm/guard/dispatch mix) to PATH")
    guard_group = ap.add_mutually_exclusive_group()
    guard_group.add_argument("--guard", dest="guard", action="store_true",
                             default=True,
                             help="on-device numerical guard: skip "
                                  "non-finite steps, escalate to clip then "
                                  "rollback (default: on)")
    guard_group.add_argument("--no-guard", dest="guard",
                             action="store_false")
    ap.add_argument("--guard-clip-after", type=int, default=2,
                    help="consecutive bad steps before the tighter grad "
                         "clip engages")
    ap.add_argument("--guard-rollback-after", type=int, default=4,
                    help="consecutive bad steps before restoring the last "
                         "committed checkpoint")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; never falls back)")
    return ap


def _fresh(model, seed: int, dev):
    params = model.init(torch.Generator().manual_seed(seed), dev)
    return params, adamw.init_state(params)


def main(argv=None, *, params=None, opt_state=None,
         history: list | None = None) -> list[float]:
    """Train; returns the loss of every step run.  ``params`` and
    ``opt_state`` (keyword-only; a checkpoint in ``--ckpt-dir`` wins over
    them) start the loop from given state instead of a fresh init;
    ``history``, when given, receives one ``{"step", "loss", "grad_norm",
    "seconds", "guard_bad"}`` dict a step."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    if mesh_lib.env_world() > 1:
        dev = mesh_lib.init_distributed(dev)
    lead = mesh_lib.rank() == 0          # prints, checkpoints, traces
    updates = {k: v for k, v in (("autotune", args.autotune),
                                 ("plan_cache_dir", args.plan_cache_dir),
                                 ("fault_spec", args.fault_spec))
               if v is not None}
    if args.trace is not None and lead:
        updates.update(telemetry=True, trace_path=args.trace)
    if args.metrics is not None and lead:
        updates.update(telemetry=True, metrics_path=args.metrics)
    config.update(**updates)
    if "telemetry" in updates:
        # The traced run's window starts here: the bus begins empty, so the
        # legacy counters start with it (finalize compares the two).
        obs.reset_all()
    conv_policy = resolve_conv_policy_args(args.conv_policy, args.conv_mode)
    log = print if lead else (lambda *a, **k: None)
    mesh_ctx = contextlib.nullcontext()
    mesh = None
    if args.conv_mesh:
        from repro_torch.dist import set_activation_policy, sharding
        mesh = mesh_lib.make_host_mesh()
        set_activation_policy(sharding.batch_axes(mesh, args.conv_mesh))
        mesh_ctx = mesh                 # with mesh: the step runs sharded
        log(f"[train] conv mesh {args.conv_mesh} on {mesh!r}")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = M.build_model(cfg)
    dcfg = DataConfig(seed=args.seed, seq_len=args.seq,
                      global_batch=args.batch, vocab=cfg.vocab)
    opt_cfg = adamw.AdamWConfig(peak_lr=args.lr)
    guard_cfg = TS.GuardConfig(clip_after=args.guard_clip_after) \
        if args.guard else None
    step_fn = TS.make_train_step(
        cfg, opt_cfg, total_steps=args.steps,
        warmup=max(1, args.steps // 20), accum_steps=args.accum,
        conv_policy=conv_policy, conv_mesh=args.conv_mesh, guard=guard_cfg)

    start_step = 0
    if args.ckpt_dir:
        start_step_, restored = CKPT.restore(args.ckpt_dir, device=dev)
        if restored is not None:
            start_step = start_step_ + 1
            params, opt_state = restored["params"], restored["opt"]
            log(f"[train] resumed from step {start_step_}")
    if params is None:
        params, opt_state = _fresh(model, args.seed, dev)
    elif opt_state is None:
        opt_state = adamw.init_state(params)
    log(f"[train] arch={cfg.name} device={dev} "
        f"params={model.param_count(params):,} "
        f"active={model.active_param_count(params):,}")

    hb = HeartbeatTable(n_workers=1)
    straggler = StragglerDetector(n_workers=1)
    gs = GuardState(clip_after=args.guard_clip_after,
                    rollback_after=args.guard_rollback_after) \
        if args.guard else None
    losses = []
    end_step = min(args.steps, args.stop_after) if args.stop_after \
        else args.steps
    for step in range(start_step, end_step):
        t0 = time.perf_counter()
        inject.set_step(step)
        batch = {k: torch.from_numpy(v)
                 for k, v in make_batch(cfg, dcfg, step).items()}
        if mesh is not None:
            batch = _own_block(batch, mesh, args.conv_mesh)
        batch = {k: v.to(dev) for k, v in batch.items()}
        with obs.trace.span("train:step", step=step), mesh_ctx:
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 step)
            loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.perf_counter() - t0
        obs.metrics.train_step(step, metrics, step_s=dt)
        bad = float(metrics.get("guard_bad", 0.0))
        if history is not None:
            history.append({"step": step, "loss": loss,
                            "grad_norm": float(metrics["grad_norm"]),
                            "seconds": dt, "guard_bad": bad})
        hb.beat(0)
        straggler.observe([dt])
        if gs is not None and bad:
            action = gs.observe(True)
            obs.events.emit("train", f"guard:{action or 'skip'}", step=step,
                            streak=gs.bad_streak)
            log(f"[train] step={step} non-finite step dropped "
                f"(streak={gs.bad_streak}, action={action})", flush=True)
            if action == "rollback":
                # The on-device skip and clip did not stop the streak:
                # restore the last committed checkpoint (a fresh init when
                # none exists).
                CKPT.wait()
                ckpt_steps = CKPT.latest_steps(args.ckpt_dir) \
                    if args.ckpt_dir else []
                plan = make_guard_restart_plan(gs, ckpt_steps)
                log(f"[train] {plan.note}", flush=True)
                if ckpt_steps:
                    _, restored = CKPT.restore(args.ckpt_dir, device=dev)
                    params, opt_state = restored["params"], restored["opt"]
                else:
                    params, opt_state = _fresh(model, args.seed, dev)
                gs.rolled_back()
        elif gs is not None:
            gs.observe(False)
        if step % args.log_every == 0 or step == args.steps - 1:
            log(f"[train] step={step} loss={loss:.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            _save(args.ckpt_dir, step, params, opt_state, lead, mesh)
    if not losses:
        log(f"[train] nothing to run: resumed at step {start_step} of "
            f"{end_step}")
        return losses
    if args.ckpt_dir and end_step % args.ckpt_every:
        _save(args.ckpt_dir, end_step - 1, params, opt_state, lead, mesh)
    CKPT.wait()                       # join any async write before exit
    if gs is not None and gs.total_bad:
        log(f"[train] guard: {gs.total_bad} non-finite steps dropped, "
            f"{gs.rollbacks} rollbacks")
    if obs.enabled():
        rep = obs.finalize()
        print(f"[train] obs: {rep['events_total']} events "
              f"{rep['events_by_kind']} trace={rep['trace_file']} "
              f"metrics={rep['metrics']['lines']} lines")
        if not rep["consistent"]:
            raise SystemExit("[train] telemetry divergence: legacy counters "
                             "disagree with the bus-backed views: "
                             + "; ".join(rep["divergences"]))
    log(f"[train] done: first_loss={losses[0]:.4f} "
        f"last_loss={losses[-1]:.4f}")
    return losses


def _own_block(batch, mesh, policy):
    """This rank's block of the global ``batch`` under ``batch_specs``;
    stops the run when the batch does not divide over the batch axes
    (the step would run the whole batch on every rank)."""
    from repro_torch.dist import constraints, sharding
    specs = sharding.batch_specs(batch, mesh, policy)
    split = constraints.batch_split(mesh)
    if split is not None and any(s[0] is None for s in specs.values()):
        raise SystemExit(
            f"[train] --batch {next(iter(batch.values())).shape[0]} does "
            f"not divide over the batch axes {split.axes} of {mesh!r}")
    return sharding.to_local(batch, specs, mesh)


def _save(ckpt_dir, step, params, opt_state, lead, mesh) -> None:
    """Rank 0 writes the checkpoint (every rank holds the same
    parameters); the others wait until it is committed."""
    if lead:
        CKPT.save(ckpt_dir, step, {"params": params, "opt": opt_state},
                  blocking=True)
    if mesh is not None:
        mesh.barrier()


if __name__ == "__main__":
    main()
    mesh_lib.shutdown()
