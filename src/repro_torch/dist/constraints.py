"""Activation sharding constraints (counterpart of
``repro.dist.constraints``).

``set_activation_policy`` records the mesh axes the batch dim of an
activation is sharded over, as in the JAX package.  Under ``with mesh:``
(``repro_torch.launch.mesh.Mesh``, JAX's ambient mesh) those axes cut the
batch into blocks when their sizes multiply past 1 (:func:`batch_split`),
and the train step then runs on this rank's block only: every rank holds
its own rows of every activation, from the embedding to the loss, as
JAX's partitioner keeps them under ``with_sharding_constraint``.

There is no partitioner here to pin a layout, so ``constrain_batch``
checks one instead: inside a step that entered its block
(:func:`batch_block`), an activation whose leading dim is not the block's
rows raises, so a layer that gathered the batch fails loudly instead of
running replicated.  Outside one it returns its input, as JAX's does
outside a mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses

_ACT_AXES: tuple[str, ...] | None = None

#: the meshes entered with ``with mesh:``, innermost last.
_ACTIVE: list = []

#: the batch blocks of the steps running, innermost last.
_BLOCKS: list = []


@dataclasses.dataclass(frozen=True)
class BatchBlock:
    """The batch cut over ``axes`` of ``mesh`` (the policy's axes of size
    > 1, in mesh order); ``rows`` this rank's rows of it inside a step."""

    mesh: object
    axes: tuple[str, ...]
    rows: int | None = None

    def index(self) -> tuple[int, int]:
        """``(n, r)``: the blocks the batch is cut into and this rank's,
        rows ``[r B/n, (r + 1) B/n)`` (``dist.sharding.batch_specs``: the
        first axis the major one)."""
        n, r = 1, 0
        for a in self.axes:
            size = self.mesh.shape[a]
            r = r * size + self.mesh.coordinate(a)
            n *= size
        return n, r


def set_activation_policy(axes) -> None:
    """axes: mesh axis names the batch dim is sharded over (or None/())."""
    global _ACT_AXES
    _ACT_AXES = tuple(axes) if axes else None


def _active_mesh():
    """The mesh of the innermost ``with mesh:`` block, if any."""
    return _ACTIVE[-1] if _ACTIVE else None


def batch_split(mesh=None) -> BatchBlock | None:
    """The cut of the batch under the activation policy on ``mesh``
    (default: the active one): None without a policy or a mesh, or when
    the policy's axes of the mesh multiply to 1."""
    mesh = mesh if mesh is not None else _active_mesh()
    if not _ACT_AXES or mesh is None:
        return None
    axes = tuple(a for a in mesh.shape if a in _ACT_AXES
                 and mesh.shape[a] > 1)
    return BatchBlock(mesh, axes) if axes else None


@contextlib.contextmanager
def batch_block(split: BatchBlock, rows: int):
    """The step's forward and backward on ``rows`` rows of ``split``'s
    batch: :func:`constrain_batch`, the losses' means and the
    mesh-parallel conv read it."""
    _BLOCKS.append(dataclasses.replace(split, rows=int(rows)))
    try:
        yield _BLOCKS[-1]
    finally:
        _BLOCKS.pop()


def current_block() -> BatchBlock | None:
    """The block of the innermost step running on one, if any."""
    return _BLOCKS[-1] if _BLOCKS else None


def constrain_batch(x):
    """``x`` unchanged; inside a batch block, raises unless its leading
    dim is the block's rows (module docstring)."""
    blk = current_block()
    if blk is not None and x.ndim and x.shape[0] != blk.rows:
        raise RuntimeError(
            f"constrain_batch: an activation of leading dim {x.shape[0]} in "
            f"a step on a batch block of {blk.rows} rows (cut over "
            f"{blk.axes}): a layer gathered the batch")
    return x
