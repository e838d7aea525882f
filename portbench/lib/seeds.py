"""Inputs from ``--seed``: one generator per named stream.

A stream's generator is seeded from a hash of the run's seed and the
stream's keys, so any whole number (larger than 32 bits too) gives its own
inputs, the same seed always the same ones, and two streams never share
values.  On the card the generator is a CUDA generator, so inputs are
drawn there in a few large calls."""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, *keys) -> int:
    text = ":".join(str(k) for k in (int(seed), *keys))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(device, seed: int, *keys) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(
        sub_seed(seed, *keys))


def normal(gen: torch.Generator, shape, std: float, dtype, device):
    """``std`` x a standard normal of ``shape``, drawn in float32 on
    ``device`` and stored in ``dtype``."""
    out = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                      device=device)
    return (out * std).to(dtype)


def uniform(gen: torch.Generator, shape, lo: float, hi: float, device):
    out = torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                     device=device)
    return out * (hi - lo) + lo
