"""Rounding float32 values to fewer mantissa bits: how the controls
compute a reference in a lower precision than the configuration states.

TF32 keeps 10 explicit mantissa bits of float32's 23, bfloat16 7, fp8
e4m3 3.  :func:`round_mantissa` rounds to nearest (ties away from zero)
and keeps float32's exponent range, so it models the precision of the
lower type and none of its overflow.  :func:`ste` passes the gradient
through unchanged, as a cast of a matrix product's operand does;
:func:`cast` rounds the gradient too, as a tensor held in the lower type
in both passes does."""

from __future__ import annotations

import torch

BITS = {"tf32": 10, "bfloat16": 7, "e4m3": 3}


def round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 ``t`` with its mantissa rounded to ``bits`` bits."""
    if t.dtype != torch.float32:
        raise TypeError(f"round_mantissa takes float32, got {t.dtype}")
    drop = 23 - bits
    i = t.contiguous().view(torch.int32)
    half = 1 << (drop - 1)
    mask = ~((1 << drop) - 1)
    sign = i & torch.tensor(-0x80000000, dtype=torch.int32, device=t.device)
    mag = (i & 0x7FFFFFFF) + half
    return ((mag & mask) | sign).view(torch.float32).reshape(t.shape)


class _Ste(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, bits):
        return round_mantissa(t, bits)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste(t: torch.Tensor, precision: str | None) -> torch.Tensor:
    """``t`` rounded to ``precision`` (a key of :data:`BITS`) with the
    gradient passed straight through; ``t`` itself for None."""
    if precision is None:
        return t
    return _Ste.apply(t, BITS[precision])


class _Cast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, bits):
        ctx.bits = bits
        return round_mantissa(t, bits)

    @staticmethod
    def backward(ctx, g):
        return round_mantissa(g.contiguous(), ctx.bits), None


def cast(t: torch.Tensor, precision: str | None) -> torch.Tensor:
    """``t`` rounded to ``precision``, and its gradient rounded to it on
    the way back; ``t`` itself for None."""
    if precision is None:
        return t
    return _Cast.apply(t, BITS[precision])
