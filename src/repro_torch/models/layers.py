"""Conv layers: ``init_conv2d``/``init_conv2d_transpose`` build a parameter
dict, ``conv2d_apply``/``conv2d_transpose_apply`` consume it (counterpart
of the conv part of ``repro.models.layers``).

Conv layers go through ``repro_torch.core.conv2d`` and
``conv2d_transpose``, so every pass runs the engines selected by the
per-pass ``policy``.
"""

from __future__ import annotations

import torch

from repro_torch.core import conv as C
from repro_torch.core.convspec import ConvSpec, ConvTransposeSpec
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
    return _init_kernel(generator, (c_out, c_in // groups, kh, kw),
                        (c_in // groups) * kh * kw, dtype, device)


def _loose(spec, spec_cls, **kw):
    """The spec, or one built from the loose geometry kwargs (not both)."""
    loose = {k: v for k, v in kw.items() if v is not None}
    if spec is None:
        return spec_cls.make(**loose)
    if loose:
        raise TypeError(f"geometry given both in spec= and as kwargs "
                        f"{sorted(loose)}; put it all in the spec")
    return spec


def _init_kernel(generator, shape, fan_in: int, dtype, device):
    """A fan-in scaled kernel drawn on the CPU from ``generator`` (so the
    values do not depend on the device), then moved to ``device``."""
    dev = resolve_device(device)
    w = torch.randn(shape, generator=generator, dtype=torch.float32)
    return {"w": (w * fan_in ** -0.5).to(device=dev, dtype=dtype)}


def init_conv2d_transpose(generator: torch.Generator, c_in: int, c_out: int,
                          k, dtype=torch.float32, groups: int = 1,
                          device=None):
    """Transposed-conv kernel ``(C_in, C_out/g, kh, kw)`` (the mirror conv's
    OIHW weight with in/out roles swapped), fan-in scaled over the taps
    feeding one output pixel; drawn like :func:`init_conv2d`."""
    kh, kw = (k, k) if isinstance(k, int) else k
    if c_in % groups or c_out % groups:
        raise ValueError(f"channels {c_in}->{c_out} not divisible by "
                         f"groups={groups}")
    return _init_kernel(generator, (c_in, c_out // groups, kh, kw),
                        (c_in // groups) * kh * kw, dtype, device)


def conv2d_transpose_apply(p, x, *, spec: ConvTransposeSpec | None = None,
                           policy=None, stride=None, padding=None,
                           output_padding=None, dilation=None, groups=None):
    """x (B, C_in, H, W) -> (B, C_out, H_out, W_out) transposed conv through
    the selected engines (decoders, upsampling heads).  ``spec`` carries
    the full geometry; without it the loose kwargs build one."""
    spec = _loose(spec, ConvTransposeSpec, stride=stride, padding=padding,
                  output_padding=output_padding, dilation=dilation,
                  groups=groups)
    return C.conv2d_transpose(x, p["w"].to(x.dtype), spec, policy)


def conv2d_apply(p, x, *, spec: ConvSpec | None = None, policy=None,
                 stride=None, padding=None, dilation=None, groups=None):
    """x (B, C, H, W) -> (B, N, H_o, W_o) through the selected engines.

    ``spec`` carries the full geometry; without it the loose kwargs build
    one.  ``policy`` selects the engine per pass (EnginePolicy, policy
    string, engine name, or None for auto)."""
    spec = _loose(spec, ConvSpec, stride=stride, padding=padding,
                  dilation=dilation, groups=groups)
    return C.conv2d(x, p["w"].to(x.dtype), spec, policy)
