"""Activation sharding constraints (counterpart of
``repro.dist.constraints``).

``set_activation_policy`` records the mesh axes the batch dim of an
activation is sharded over, as in the JAX package.  ``constrain_batch``
returns its input unchanged: in JAX it is a layout hint to the SPMD
partitioner (``with_sharding_constraint``) that leaves the values as they
are, and the port has no partitioner.  Its mesh-parallel conv
(``repro_torch.dist.conv_parallel``) takes and returns global tensors,
replicated on every rank, so the activations between two convs are whole
on every rank and there is nothing to pin.  (Keeping them sharded between
layers is later work: ROADMAP.)

The ambient mesh: ``with mesh:`` (``repro_torch.launch.mesh.Mesh``) makes
a mesh the one :func:`_active_mesh` returns, JAX's ``with mesh:``.
"""

from __future__ import annotations

_ACT_AXES: tuple[str, ...] | None = None

#: the meshes entered with ``with mesh:``, innermost last.
_ACTIVE: list = []


def set_activation_policy(axes) -> None:
    """axes: mesh axis names the batch dim is sharded over (or None/())."""
    global _ACT_AXES
    _ACT_AXES = tuple(axes) if axes else None


def _active_mesh():
    """The mesh of the innermost ``with mesh:`` block, if any."""
    return _ACTIVE[-1] if _ACTIVE else None


def constrain_batch(x):
    """``x`` unchanged: activations are global on every rank (module
    docstring)."""
    return x
