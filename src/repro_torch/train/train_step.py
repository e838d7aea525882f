"""The train step: loss -> grads -> AdamW, on one device.

Counterpart of ``repro.train.train_step.make_train_step``, single-device
path only: the ``loss=`` plugin, ``conv_policy``, the optimizer and the
warmup-cosine schedule.  ``make_train_step`` returns a function

    (params, opt_state, batch, step) -> (params, opt_state, metrics)

that runs eagerly (no ``jit`` counterpart is needed).  Gradient
accumulation and compression (ROADMAP A9), the numerical guard (A12) and
the conv mesh (A13) are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.optim import adamw, schedule
from repro_torch.tree import tree_leaves, tree_unflatten


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *,
                    total_steps: int = 10000, warmup: int = 100,
                    accum_steps: int = 1, compress_grads: bool = False,
                    conv_policy=None, conv_mesh=None,
                    loss: Callable | None = None, guard=None) -> Callable:
    """``cfg`` is a frozen dataclass with a ``conv_policy`` field (for
    example ``AutoencoderConfig``); ``conv_policy`` overrides its policy
    for every conv of the model.  The learning rate follows
    ``schedule.warmup_cosine``; the JAX step's ``schedule_name`` and its
    per-model choice come back with the LM slice (ROADMAP A10).  ``loss(params, batch, cfg) -> (loss,
    metrics)`` is the loss plugin."""
    if loss is None:
        raise NotImplementedError(
            "the default LM loss waits for the LM slice (ROADMAP A10); "
            "pass loss=")
    if accum_steps != 1:
        raise NotImplementedError("gradient accumulation is not ported yet "
                                  "(ROADMAP A9)")
    if compress_grads:
        raise NotImplementedError("gradient compression is not ported yet "
                                  "(ROADMAP A9)")
    if guard:
        raise NotImplementedError("the numerical guard is not ported yet "
                                  "(ROADMAP A12)")
    if conv_mesh is not None:
        raise NotImplementedError("the conv mesh is not ported yet "
                                  "(ROADMAP A13)")
    if conv_policy is not None:
        cfg = dataclasses.replace(cfg, conv_policy=str(conv_policy))

    def train_step(params, opt_state, batch, step: int):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        params = tree_unflatten(params, leaves)
        loss_val, metrics = loss(params, batch, cfg)
        grads = tree_unflatten(params, torch.autograd.grad(loss_val, leaves))
        lr = schedule.warmup_cosine(step + 1, peak_lr=opt_cfg.peak_lr,
                                    warmup=warmup, total=total_steps)
        new_params, new_opt, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, lr, opt_cfg)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        return new_params, new_opt, {**metrics, **opt_metrics}

    return train_step
