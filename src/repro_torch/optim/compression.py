"""Gradient compression with error feedback (counterpart of
``repro.optim.compression``).

  * int8 stochastic-rounding quantization, per tensor with a shared absmax
    scale;
  * top-k sparsification by magnitude.

Both return a residual: the train step adds it back before the next
step's compression, so the compression error does not bias the optimizer.

The rounding noise is uniform in [-0.5, 0.5), drawn from an explicit
``torch.Generator`` (the train step seeds one from (17, step); JAX's
``fold_in(PRNGKey(17), step)`` stream cannot be reproduced in PyTorch).
The ``*_with_noise`` forms take the noise as tensors, so the same noise
gives the same quantization in both packages.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class Int8Leaf:
    """One quantized tensor: int8 values and their float scale (a leaf of
    the quantized tree, which the tree helpers do not walk into)."""
    q: torch.Tensor
    scale: torch.Tensor


def uniform_noise(x: torch.Tensor, generator: torch.Generator):
    """Uniform [-0.5, 0.5) float32 noise of ``x``'s shape, drawn on the
    generator's device."""
    return torch.rand(x.shape, generator=generator,
                      device=generator.device) - 0.5


def int8_quantize_with_noise(x: torch.Tensor, noise: torch.Tensor):
    """Stochastic rounding of ``x / scale`` with the given noise; returns
    ``(q, scale)``, ``scale = max |x| / 127`` in ``x``'s dtype."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    scaled = x.float() / scale
    q = torch.clamp(torch.round(scaled + noise), -127, 127).to(torch.int8)
    return q, scale


def int8_quantize(x: torch.Tensor, generator: torch.Generator):
    """Stochastic-rounding int8 quantization.  Returns ``(q, scale)``."""
    return int8_quantize_with_noise(x, uniform_noise(x, generator))


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree_int8_with_noise(grads, noise):
    """Quantize every leaf with its noise (a tree like ``grads``); returns
    ``(quantized tree of Int8Leaf, residual tree)``."""
    qs, residuals = [], []
    for leaf, n in zip(tree_leaves(grads), tree_leaves(noise)):
        q, s = int8_quantize_with_noise(leaf, n)
        qs.append(Int8Leaf(q, s))
        residuals.append(leaf - int8_dequantize(q, s).to(leaf.dtype))
    return tree_unflatten(grads, qs), tree_unflatten(grads, residuals)


def compress_tree_int8(grads, generator: torch.Generator):
    """Quantize every leaf, drawing its noise from ``generator`` leaf by
    leaf in tree order; returns ``(quantized tree, residual tree)``."""
    noise = tree_map(lambda g: uniform_noise(g, generator), grads)
    return compress_tree_int8_with_noise(grads, noise)


def decompress_tree_int8(qtree, dtype=torch.float32):
    return tree_map(lambda leaf: int8_dequantize(leaf.q, leaf.scale)
                    .to(dtype), qtree)


def topk_sparsify(x: torch.Tensor, frac: float = 0.01):
    """Keep the top-``frac`` magnitudes; returns ``(values, flat indices,
    residual)``, the values in descending magnitude."""
    flat = x.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    idx = torch.topk(flat.abs(), k).indices
    kept = flat[idx]
    dense = torch.zeros_like(flat).index_copy(0, idx, kept)
    return kept, idx, (flat - dense).reshape(x.shape)


def topk_densify(vals, idx, shape, dtype=torch.float32):
    flat = torch.zeros(math.prod(shape), dtype=dtype, device=vals.device)
    return flat.index_copy(0, idx, vals.to(dtype)).reshape(shape)
