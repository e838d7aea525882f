"""Parameter trees: nested dicts and lists of tensors.

The port keeps parameters as plain nested containers, as the JAX package
keeps its pytrees: the CNN's ``{"c1": {"w": ...}, ...}`` and the
autoencoder's ``{"enc": [{"w": ...}, ...], "dec": [...]}``.  These helpers
walk dicts (in insertion order), lists and tuples; anything else is a leaf.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over one or more trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the order :func:`tree_map` visits them."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves) -> object:
    """A tree of the structure of ``like`` holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def params_from_numpy(np_params, device=None):
    """A nested dict/list of arrays (for example a JAX example's parameters
    passed through ``np.asarray``) -> the same tree of float32 tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    return tree_map(
        lambda v: torch.as_tensor(np.array(v, dtype=np.float32)).to(dev),
        np_params)
