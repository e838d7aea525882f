"""Parameter trees: nested dicts and lists of tensors.

The port keeps parameters as plain nested containers, as the JAX package
keeps its pytrees: the CNN's ``{"c1": {"w": ...}, ...}`` and the
autoencoder's ``{"enc": [{"w": ...}, ...], "dec": [...]}``.  These helpers
walk dicts in sorted key order (as ``jax.tree`` flattens them) and lists
and tuples in order; anything else is a leaf.  So a tree restored from a
checkpoint (whose leaves are stored by sorted path) walks as the tree that
was saved, and a sum over the leaves (AdamW's global norm) adds them in the
same order.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over one or more trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
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


def _leaf_from_numpy(value, device) -> torch.Tensor:
    """One array -> a tensor of its own dtype; a bfloat16 array (numpy's
    ``ml_dtypes`` type, which torch cannot read) through its bit pattern."""
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def tree_from_numpy(np_tree, device=None):
    """A nested dict/list of arrays -> the same tree of tensors on
    ``device`` (default: the card), each leaf keeping its dtype: a bf16
    tree carries bf16, an int32 leaf stays int32.  The JAX package's AdamW
    state (float32 ``m``/``v``, the int32 ``step``, with ``guard_streak``
    and ``ef`` when the step keeps them) comes across as the port's."""
    dev = resolve_device(device)
    return tree_map(lambda v: _leaf_from_numpy(v, dev), np_tree)
