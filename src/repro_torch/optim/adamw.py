"""AdamW with decoupled weight decay and global-norm clipping.

Counterpart of ``repro.optim.adamw``: functions over parameter trees
(nested dicts and lists of tensors, ``repro_torch.tree``), returning new
tensors as the JAX functions return new arrays.  Moments are float32; the
clipping scale and the step count (a 0-d int32 tensor, as the JAX state
keeps it) stay on the device, so a step needs no host round trip.
``apply_updates(..., in_place=True)`` writes the same values into the
given tensors instead (the caller donates them), so a model whose
parameters and moments take more than half the card still steps there.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init_state(params) -> dict:
    """``{"m", "v"}`` float32 zeros like ``params``, and ``step`` an int32
    0 on the parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]).sum())


#: elements an in-place update works on at a time (256 MB of float32), so
#: its temporaries stay small whatever a leaf's size.
UPDATE_CHUNK = 1 << 26


def _step_leaf(p, g, m, v, scale, lr: float, b1c, b2c, cfg: AdamWConfig):
    """One leaf's ``(new param, m, v)``: the JAX package's arithmetic."""
    g = g.float() * scale
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
        + cfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), m, v


def _step_leaf_in_place(p, g, m, v, scale, lr: float, b1c, b2c,
                        cfg: AdamWConfig, keep_if) -> None:
    """:func:`_step_leaf` written into ``p``, ``m`` and ``v``,
    ``UPDATE_CHUNK`` elements at a time (elementwise, so the values are
    the functional update's bit for bit); where ``keep_if`` is False the
    old values stay."""
    flat = [t.view(-1) for t in (p, g, m, v)]   # raises unless contiguous
    for start in range(0, flat[0].numel(), UPDATE_CHUNK):
        pc, gc, mc, vc = (t[start:start + UPDATE_CHUNK] for t in flat)
        new = _step_leaf(pc, gc, mc, vc, scale, lr, b1c, b2c, cfg)
        for dst, val in zip((pc, mc, vc), new):
            dst.copy_(val if keep_if is None
                      else torch.where(keep_if, val, dst))


def apply_updates(params, grads, state: dict, lr: float, cfg: AdamWConfig,
                  *, in_place: bool = False, keep_if=None):
    """Returns ``(new_params, new_state, metrics)``.  Gradients are scaled
    by ``min(1, clip_norm / global_norm)`` before the moments update.

    ``in_place``: the new parameters, moments and step count are written
    into ``params`` and ``state``'s tensors, which are returned (no second
    copy of the model and its moments is made; the caller must not use
    the old values); ``keep_if``, a 0-d bool tensor, then keeps every old
    value where it is False (the guard's skip-step, selected chunk by
    chunk).  Without ``in_place`` new tensors are returned and
    ``keep_if`` must be None."""
    if keep_if is not None and not in_place:
        raise ValueError("keep_if selects inside an in-place update only")
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = state["step"] + 1
        # The bias corrections in float32, as the JAX package computes them.
        t = step.float()
        b1c = 1 - torch.tensor(cfg.b1, dtype=t.dtype, device=t.device) ** t
        b2c = 1 - torch.tensor(cfg.b2, dtype=t.dtype, device=t.device) ** t
        leaves = zip(tree_leaves(params), tree_leaves(grads),
                     tree_leaves(state["m"]), tree_leaves(state["v"]))
        metrics = {"grad_norm": gnorm, "lr": lr}
        if in_place:
            for p, g, m, v in leaves:
                _step_leaf_in_place(p, g, m, v, scale, lr, b1c, b2c, cfg,
                                    keep_if)
            state["step"].copy_(step if keep_if is None
                                else torch.where(keep_if, step,
                                                 state["step"]))
            return params, {k: state[k] for k in ("m", "v", "step")}, \
                metrics
        out_p, out_m, out_v = zip(*(_step_leaf(p, g, m, v, scale, lr, b1c,
                                               b2c, cfg)
                                    for p, g, m, v in leaves))
    new_state = {"m": tree_unflatten(state["m"], list(out_m)),
                 "v": tree_unflatten(state["v"], list(out_v)), "step": step}
    return tree_unflatten(params, list(out_p)), new_state, metrics
