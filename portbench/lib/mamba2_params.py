"""Mamba2's parameters as the benchmark makes them from the seed.

The tree is the one the program takes (its stacked layout: each layer's
leaves stacked on a leading axis of ``n_layer``), keyed by path.  The
draws follow the published model's initialisation (arXiv:2405.21060 and
its reference code): ``A`` from U(1, 16), ``dt`` log-uniform in [1e-3,
1e-1] through an inverse softplus into ``dt_bias``, ``D`` ones, norms
ones, projections normal at fan-in scale with ``out_proj`` rescaled by
``1/sqrt(n_layer)``, the depthwise conv uniform at fan-in bound, the
embedding normal at 0.02.  ``A_log``, ``dt_bias`` and ``D`` are float32
(as the program and the published code keep them), the rest in the
configuration's parameter type.  Each leaf is one draw on the device."""

from __future__ import annotations

import math

import torch

from portbench.lib import seeds
from portbench.lib.lmwork import mamba2_sizes

FLOAT32_LEAVES = ("blocks/ssm/a_log/w", "blocks/ssm/dt_bias/w",
                  "blocks/ssm/d_skip/w")


def layout(config: dict) -> dict[str, tuple]:
    """``{path: shape}`` of every leaf."""
    s = mamba2_sizes(config)
    n, d, di, h = s["layers"], s["d_model"], s["d_inner"], s["heads"]
    return {
        "embed/w": (s["vocab_rows"], d),
        "final_norm/scale": (d,),
        "blocks/ln/scale": (n, d),
        "blocks/ssm/in_proj/w": (n, d, s["proj_out"]),
        "blocks/ssm/conv_w/w": (n, s["width"], s["conv_channels"]),
        "blocks/ssm/a_log/w": (n, h),
        "blocks/ssm/dt_bias/w": (n, h),
        "blocks/ssm/d_skip/w": (n, h),
        "blocks/ssm/norm/scale": (n, di),
        "blocks/ssm/out_proj/w": (n, di, d),
    }


def dtype_of(path: str, config: dict) -> torch.dtype:
    return torch.float32 if path in FLOAT32_LEAVES \
        else getattr(torch, config["param_dtype"])


def make(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf, drawn from ``seed`` on ``device``."""
    s = mamba2_sizes(config)
    out = {}
    for path, shape in layout(config).items():
        dt = dtype_of(path, config)
        g = seeds.generator(device, seed, "mamba2", path)
        if path.endswith("scale") or path == "blocks/ssm/d_skip/w":
            v = torch.ones(shape, dtype=dt, device=device)
        elif path == "embed/w":
            v = seeds.normal(g, shape, 0.02, dt, device)
        elif path == "blocks/ssm/in_proj/w":
            v = seeds.normal(g, shape, s["d_model"] ** -0.5, dt, device)
        elif path == "blocks/ssm/out_proj/w":
            v = seeds.normal(g, shape, (s["d_inner"] * s["layers"]) ** -0.5,
                             dt, device)
        elif path == "blocks/ssm/conv_w/w":
            b = s["width"] ** -0.5
            v = seeds.uniform(g, shape, -b, b, device).to(dt)
        elif path == "blocks/ssm/a_log/w":
            v = torch.log(seeds.uniform(g, shape, 1.0, 16.0, device))
        elif path == "blocks/ssm/dt_bias/w":
            dt0 = torch.exp(seeds.uniform(g, shape, math.log(1e-3),
                                          math.log(1e-1), device))
            dt0 = torch.clamp(dt0, min=1e-4)
            v = dt0 + torch.log(-torch.expm1(-dt0))     # softplus^-1
        else:
            raise KeyError(path)
        out[path] = v.to(dt)
    return out


def nest(flat: dict[str, torch.Tensor]) -> dict:
    """``{"a/b/c": t}`` -> ``{"a": {"b": {"c": t}}}``."""
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *heads, last = path.split("/")
        for k in heads:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """The inverse of :func:`nest`."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else k))
    return out
