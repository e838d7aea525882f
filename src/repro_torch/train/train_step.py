"""The train step: loss -> grads -> AdamW, on one device, with optional
microbatch accumulation, int8 gradient compression with error feedback and
the numerical guard.

Counterpart of ``repro.train.train_step``.  ``make_train_step`` returns a
function

    (params, opt_state, batch, step) -> (params, opt_state, metrics)

that runs eagerly (no ``jit`` counterpart is needed); ``step`` is the
loop's Python int.  Grads keep the parameter dtype, as
``jax.value_and_grad`` gives them (bf16 at full width); the accumulator is
float32.  Everything the guard decides stays on the device: the step reads
nothing back to the host.  The ``grad.values`` fault site sits where the
JAX step has it, after the grads and before compression and the guard:
an armed ``grad.values:nan@stepN`` rule multiplies step N's grads by NaN
(:func:`repro_torch.ft.inject.nan_factor`, decided on the host from the
step number), so the guard drops exactly step N.  The conv mesh (ROADMAP
A13) raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.ft import inject
from repro_torch.models import model as M
from repro_torch.optim import adamw, compression, schedule
from repro_torch.train import losses
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

#: the compression noise of step s is drawn from a generator seeded with
#: ``NOISE_SEED * 2**32 + s`` (the JAX step folds s into PRNGKey(17)).
NOISE_SEED = 17


def loss_fn(params, batch, cfg):
    """The default LM loss: ``forward`` then ``losses.train_loss``."""
    logits, aux = M.forward(params, batch, cfg)
    return losses.train_loss(logits, aux, batch)


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """The train step's numerical guard.

    A step whose loss or gradient global norm is non-finite is DROPPED:
    params and optimizer state pass through unchanged (a ``torch.where``
    select on the device, no host round trip).  The consecutive-bad streak
    rides in ``opt_state["guard_streak"]``; once it reaches ``clip_after``
    the next steps also clip gradients to ``clip_norm`` (tighter than the
    optimizer's own clip) until a step lands finite.  Escalation past
    clipping -- rollback to the last committed checkpoint -- is the loop's:
    feed ``metrics["guard_bad"]`` to ``repro_torch.ft.failures.GuardState``
    (see ``launch/train.py``).
    """
    clip_after: int = 2
    clip_norm: float = 0.5


def _value_and_grad(loss: Callable, params, batch, cfg):
    """``(loss, metrics, grads)``: the loss and its metrics detached, the
    grads a tree like ``params`` in each parameter's dtype; a parameter
    the loss never reads (the audio encoder's ``embed``) gets zeros, as
    under ``jax.grad``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss_val, metrics = loss(tree_unflatten(params, leaves), batch, cfg)
    grads = torch.autograd.grad(loss_val, leaves, allow_unused=True,
                                materialize_grads=True)
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
    return loss_val.detach(), metrics, tree_unflatten(params, list(grads))


def _accumulated(loss: Callable, params, batch, cfg, accum_steps: int):
    """The batch split on its leading axis into ``accum_steps``
    microbatches: grads summed in float32 zeros, then divided; loss and
    metrics the mean over the microbatches."""
    def micro(x, i):
        b = x.shape[0]
        return x.reshape(accum_steps, b // accum_steps, *x.shape[1:])[i]

    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    l_acc = 0.0
    ms = []
    for i in range(accum_steps):
        loss_val, m, g = _value_and_grad(
            loss, params, tree_map(lambda x: micro(x, i), batch), cfg)
        g_acc = tree_map(torch.add, g_acc, g)
        l_acc = l_acc + loss_val
        ms.append(m)
    metrics = {k: torch.stack([torch.as_tensor(m[k]) for m in ms]).mean()
               for k in ms[0]}
    return (l_acc / accum_steps, metrics,
            tree_map(lambda g: g / accum_steps, g_acc))


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *,
                    total_steps: int = 10000, warmup: int = 100,
                    schedule_name: str | None = None,
                    accum_steps: int = 1, compress_grads: bool = False,
                    conv_policy=None, conv_mesh=None,
                    loss: Callable | None = None,
                    guard: GuardConfig | bool | None = None,
                    donate: bool = False) -> Callable:
    """``cfg`` is an ``ArchConfig`` (the default LM loss) or any frozen
    dataclass the ``loss`` plugin reads (for example
    ``AutoencoderConfig``).  ``loss(params, batch, cfg) -> (loss,
    metrics)`` replaces the default LM loss.  The learning rate follows
    ``schedule_name`` (default: ``schedule.default_schedule_for(cfg.name)``,
    WSD for MiniCPM, cosine otherwise).

    accum_steps: microbatches per step (the batch's leading axis must
    divide).

    compress_grads: int8-quantize gradients with error feedback before the
    optimizer -- the numerics of a compressed cross-pod all-reduce; the
    residual rides in ``opt_state["ef"]``.

    conv_policy: override ``cfg.conv_policy`` for every conv of the model
    (an ``EnginePolicy``, a policy string or an engine name); a config
    without the field has no conv to apply it to.

    guard: a :class:`GuardConfig` (or ``True`` for the defaults) arms the
    numerical guard; ``metrics`` gain ``guard_bad``, ``guard_streak`` and
    ``guard_clipped``, and ``opt_state`` keeps ``guard_streak`` on the
    device.  None/False (the default) runs the unguarded step.

    donate: the step writes the new parameters and AdamW moments into the
    ones it is given (the caller hands them over, as with ``jax.jit``'s
    ``donate_argnums``, and keeps only what the step returns), so no
    second copy of the model and its moments is held: a model whose
    parameters and moments take more than half the card trains only so
    (recurrentgemma-9b at 5 layers: 3.22 B parameters, 38.6 GB with the
    moments).  The values are the functional step's bit for bit; the
    guard's skip-step selects inside the update."""
    if loss is None:
        loss = loss_fn
    if guard is True:
        guard = GuardConfig()
    elif guard is False:
        guard = None
    if conv_mesh is not None:
        raise NotImplementedError("the conv mesh is not ported yet "
                                  "(ROADMAP A13)")
    if conv_policy is not None and any(
            f.name == "conv_policy" for f in dataclasses.fields(cfg)):
        # conv_mode=None (where the config has it): the override must win
        # even over a config that still sets the deprecated field.
        extra = {"conv_mode": None} if hasattr(cfg, "conv_mode") else {}
        cfg = dataclasses.replace(cfg, conv_policy=str(conv_policy),
                                  **extra)
    sched = schedule.SCHEDULES[schedule_name
                               or schedule.default_schedule_for(cfg.name)]

    def train_step(params, opt_state, batch, step: int):
        dev = tree_leaves(params)[0].device
        opt_in = opt_state            # the state that entered the step
        if accum_steps == 1:
            loss_val, metrics, grads = _value_and_grad(loss, params, batch,
                                                       cfg)
        else:
            loss_val, metrics, grads = _accumulated(loss, params, batch,
                                                    cfg, accum_steps)

        # Fault injection on the gradient VALUES, where the JAX step has
        # it: the guard below then sees step N non-finite.
        nan_steps = inject.value_fault_steps("grad.values")
        if nan_steps is not None:
            factor = inject.nan_factor(step, nan_steps)
            if factor != 1.0:
                grads = tree_map(lambda g: g * factor, grads)

        if compress_grads:
            ef = opt_state.get("ef") or tree_map(
                lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)
            grads = tree_map(lambda g, e: g.float() + e, grads, ef)
            gen = torch.Generator(dev).manual_seed(
                (NOISE_SEED << 32) + step)
            q, residual = compression.compress_tree_int8(grads, gen)
            grads = compression.decompress_tree_int8(q)
            opt_state = {**opt_state, "ef": residual}

        if guard is not None:
            streak0 = opt_state.get("guard_streak", torch.zeros(
                (), dtype=torch.int32, device=dev))
            gnorm = adamw.global_norm(grads)
            # One reduction catches every inf/NaN leaf: a single non-finite
            # value makes the sqrt of the sum of squares non-finite.
            finite = torch.isfinite(loss_val) & torch.isfinite(gnorm)
            clipping = streak0 >= guard.clip_after
            gscale = torch.where(clipping, torch.clamp(
                guard.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0),
                1.0)
            # float32, as the JAX step's bf16 grad times a float32 scale.
            grads = tree_map(lambda g: g.float() * gscale, grads)

        lr = sched(step + 1, peak_lr=opt_cfg.peak_lr, warmup=warmup,
                   total=total_steps)
        new_params, new_opt, opt_metrics = adamw.apply_updates(
            params, grads,
            {k: v for k, v in opt_state.items()
             if k not in ("ef", "guard_streak")},
            lr, opt_cfg, in_place=donate,
            keep_if=finite if donate and guard is not None else None)
        if compress_grads:
            new_opt["ef"] = opt_state["ef"]
        metrics = {**metrics, **opt_metrics}

        if guard is not None:
            # Skip-step select: a non-finite step passes params and
            # optimizer state through unchanged.  A key missing from the
            # entering state ("ef" on the first compressed step) selects
            # against zeros, never against a NaN-tainted new value.
            def keep_old(new, old):
                return tree_map(lambda n, o: torch.where(finite, n, o),
                                new, old)
            # A donated update has selected its own leaves already.
            selected = ("m", "v", "step") if donate else ()
            if not donate:
                new_params = keep_old(new_params, params)
            new_opt = {
                k: v if k in selected else
                keep_old(v, opt_in[k] if k in opt_in
                         else tree_map(torch.zeros_like, v))
                for k, v in new_opt.items()}
            streak = torch.where(finite, 0, streak0 + 1).to(torch.int32)
            new_opt["guard_streak"] = streak
            metrics = {**metrics,
                       "guard_bad": (~finite).float(),
                       "guard_streak": streak.float(),
                       "guard_clipped": (clipping & finite).float()}
        return new_params, new_opt, metrics

    return train_step
