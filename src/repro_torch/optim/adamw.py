"""AdamW with decoupled weight decay and global-norm clipping.

Counterpart of ``repro.optim.adamw``: functions over parameter trees
(nested dicts and lists of tensors, ``repro_torch.tree``), returning new
tensors as the JAX functions return new arrays.  Moments are float32; the
clipping scale stays on the device, so a step needs no host round trip.
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
    """``{"m", "v"}`` float32 zeros like ``params``, and ``step`` 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": 0}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]).sum())


def apply_updates(params, grads, state: dict, lr: float, cfg: AdamWConfig):
    """Returns ``(new_params, new_state, metrics)``.  Gradients are scaled
    by ``min(1, clip_norm / global_norm)`` before the moments update."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = state["step"] + 1
        # The bias corrections in float32, as the JAX package computes them.
        t = torch.tensor(float(step), dtype=torch.float32)
        b1c = (1 - torch.tensor(cfg.b1, dtype=torch.float32) ** t).item()
        b2c = (1 - torch.tensor(cfg.b2, dtype=torch.float32) ** t).item()
        out_p, out_m, out_v = [], [], []
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            g = g.float() * scale
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * g * g
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
                + cfg.weight_decay * p.float()
            out_p.append((p.float() - lr * delta).to(p.dtype))
            out_m.append(m)
            out_v.append(v)
    new_state = {"m": tree_unflatten(state["m"], out_m),
                 "v": tree_unflatten(state["v"], out_v), "step": step}
    return (tree_unflatten(params, out_p), new_state,
            {"grad_norm": gnorm, "lr": lr})
