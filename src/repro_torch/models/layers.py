"""Conv layers: ``init_conv2d`` builds a parameter dict, ``conv2d_apply``
consumes it (counterpart of the conv part of ``repro.models.layers``).

Conv layers go through ``repro_torch.core.conv2d``, so their backward runs
the engines selected by the per-pass ``policy``.
"""

from __future__ import annotations

import torch

from repro_torch.core import conv as C
from repro_torch.core.convspec import ConvSpec
from repro_torch.device import resolve_device


def init_conv2d(generator: torch.Generator, c_in: int, c_out: int, k,
                dtype=torch.float32, groups: int = 1, device=None):
    """OIHW conv kernel with fan-in scaling; ``k`` is an int or (kh, kw).
    Drawn on the CPU from ``generator`` (so the values do not depend on the
    device), then moved to ``device`` (default: the card)."""
    kh, kw = (k, k) if isinstance(k, int) else k
    if c_in % groups or c_out % groups:
        raise ValueError(f"channels {c_in}->{c_out} not divisible by "
                         f"groups={groups}")
    dev = resolve_device(device)
    fan_in = (c_in // groups) * kh * kw
    w = torch.randn((c_out, c_in // groups, kh, kw), generator=generator,
                    dtype=torch.float32)
    return {"w": (w * fan_in ** -0.5).to(device=dev, dtype=dtype)}


def conv2d_apply(p, x, *, spec: ConvSpec | None = None, policy=None,
                 stride=None, padding=None, dilation=None, groups=None):
    """x (B, C, H, W) -> (B, N, H_o, W_o) through the selected engines.

    ``spec`` carries the full geometry; without it the loose kwargs build
    one.  ``policy`` selects the engine per pass (EnginePolicy, policy
    string, engine name, or None for auto)."""
    loose = {k: v for k, v in (("stride", stride), ("padding", padding),
                               ("dilation", dilation), ("groups", groups))
             if v is not None}
    if spec is None:
        spec = ConvSpec.make(**loose)
    elif loose:
        raise TypeError(f"geometry given both in spec= and as kwargs "
                        f"{sorted(loose)}; put it all in the spec")
    return C.conv2d(x, p["w"].to(x.dtype), spec, policy)
