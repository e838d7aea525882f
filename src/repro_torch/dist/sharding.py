"""Path-based sharding rules for params, optimizer state, batches and caches
(counterpart of ``repro.dist.sharding``).

All rules walk trees of tensors (or anything with a ``.shape``: the dry
run's ``meta`` tensors) and return trees of :class:`PartitionSpec` with
the same structure.  Rules only need axis *sizes*, so ``mesh`` may be any
object with a ``.shape`` mapping.

Policies:
  * ``tp``      -- 2-D data x tensor parallelism (default): linear weights
                   shard (d_in="data", d_out="model"); ``wo`` swaps the axes
                   so the attention output projection all-reduces once; the
                   embedding shards vocab over "model"; MoE expert tensors
                   shard experts over "model" and d_in over "data".  Batch
                   shards over ("data",).
  * ``dp_only`` -- pure data parallelism: the "model" axis is dropped from
                   param specs and joins the batch axes instead.
  * ``tp_rep``  -- tensor-parallel activations with fully replicated params.

Every assignment is divisibility-checked against the mesh axis size; an
indivisible dim falls back to replication for that dim only.

:func:`local_block` cuts a global tensor to one rank's block under a spec
(the port's counterpart of placing an array with ``to_shardings``), and
:func:`from_local` puts the blocks back together on every rank;
:func:`to_local` and :func:`gather_tree` do the same over trees.
"""

from __future__ import annotations

from repro_torch.tree import tree_map


class PartitionSpec:
    """Per-dim mesh axes of a tensor: an axis name, a tuple of names (the
    first the major one), or None (replicated).  Iterates as its entries,
    as JAX's ``PartitionSpec`` does; a leaf of a spec tree."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self.parts == other.parts
        return isinstance(other, tuple) and self.parts == other

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return "P" + repr(self.parts)


P = PartitionSpec


def _axis(mesh, name: str) -> int:
    return dict(mesh.shape).get(name, 1)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _fit(dim: int, mesh, axis) -> object:
    """axis if dim divides the mesh axis size, else None (replicate)."""
    if axis is None:
        return None
    total = 1
    for a in _axes(axis):
        total *= _axis(mesh, a)
    return axis if total > 0 and dim % total == 0 else None


def batch_axes(mesh, policy: str = "tp") -> tuple[str, ...]:
    """Mesh axes carrying the batch dim under a policy."""
    names = tuple(dict(mesh.shape))
    if policy == "dp_only":
        cand = ("pod", "data", "model")
    else:  # tp / tp_rep: model axis is reserved for tensor parallelism
        cand = ("pod", "data")
    return tuple(a for a in cand if a in names)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

def _leaf_spec(path: tuple[str, ...], leaf, mesh, policy: str) -> P:
    ndim = len(leaf.shape)
    if policy == "tp_rep" or ndim < 2:
        return P()
    lead = [None] * (ndim - 2)
    if "embed" in path:
        d_in, d_out = "model", "data"        # vocab over model, d over data
    elif "moe" in path and "shared" not in path and "router" not in path \
            and ndim >= 3 and path[-1] == "w":
        # Expert tensor (..., E, d_in, d_out): expert parallelism over
        # "model", d_in over "data".
        lead = [None] * (ndim - 3)
        spec = [_fit(leaf.shape[-3], mesh, "model"),
                _fit(leaf.shape[-2], mesh, "data"), None]
        if policy == "dp_only":
            spec = [s if s != "model" else None for s in spec]
        return P(*lead, *spec)
    elif ndim >= 4:
        # Conv kernel (..., O, I, kh, kw), or its transposed twin
        # (..., I, O/g, kh, kw) under a decoder ("dec") path: the trailing
        # dims are spatial and never sharded.  Cout over "model" (the
        # conv_parallel "tp" placement), Cin replicated.
        out_dim = ndim - 3 if "dec" in path else ndim - 4
        spec = [None] * ndim
        if policy != "dp_only":
            spec[out_dim] = _fit(leaf.shape[out_dim], mesh, "model")
        return P(*spec)
    elif "wo" in path:
        d_in, d_out = "model", "data"        # output proj: swapped axes
    else:
        d_in, d_out = "data", "model"
    spec = [_fit(leaf.shape[-2], mesh, d_in),
            _fit(leaf.shape[-1], mesh, d_out)]
    if policy == "dp_only":
        spec = [s if s != "model" else None for s in spec]
    return P(*lead, *spec)


def param_specs(params, mesh, policy: str = "tp"):
    """PartitionSpec tree mirroring a parameter tree."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            out = [walk(v, path + (str(i),)) for i, v in enumerate(tree)]
            return tuple(out) if isinstance(tree, tuple) else out
        return _leaf_spec(path, tree, mesh, policy)
    return walk(params, ())


def opt_state_specs(params, mesh, policy: str = "tp"):
    """Specs for ``adamw.init_state(params)``: m/v inherit the param specs."""
    ps = param_specs(params, mesh, policy)
    return {"m": ps, "v": ps, "step": P()}


# ---------------------------------------------------------------------------
# Batch / cache rules
# ---------------------------------------------------------------------------

def _dim_spec(axes: tuple[str, ...], dim: int, mesh):
    axis = axes if len(axes) > 1 else (axes[0] if axes else None)
    return _fit(dim, mesh, axis)


def batch_specs(batch, mesh, policy: str = "tp"):
    """Shard the leading dim of every batch leaf over the batch axes."""
    axes = batch_axes(mesh, policy)

    def leaf(x):
        ndim = len(x.shape)
        if ndim == 0 or not axes:
            return P()
        return P(_dim_spec(axes, x.shape[0], mesh), *([None] * (ndim - 1)))
    return tree_map(leaf, batch)


def cache_specs(cache, mesh, policy: str = "tp"):
    """Decode caches are stacked (L, B, ...): shard the batch dim (dim 1)."""
    axes = batch_axes(mesh, policy)

    def leaf(x):
        ndim = len(x.shape)
        if ndim < 2 or not axes:
            return P()
        return P(None, _dim_spec(axes, x.shape[1], mesh),
                 *([None] * (ndim - 2)))
    return tree_map(leaf, cache)


# ---------------------------------------------------------------------------
# Global tensors <-> one rank's block
# ---------------------------------------------------------------------------

def shard_count(spec, mesh) -> int:
    """How many blocks a tensor of ``spec`` is cut into (its bytes on one
    device are its bytes over this)."""
    n = 1
    for entry in spec:
        for a in _axes(entry):
            n *= _axis(mesh, a)
    return n


def local_block(x, spec, mesh):
    """This rank's block of the global ``x`` under ``spec`` (a view): each
    sharded dim cut into equal blocks, the block index this rank's
    coordinate over the dim's axes, the first axis the major one."""
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            size = _axis(mesh, a)
            idx = idx * size + mesh.coordinate(a)
            n *= size
        if n > 1:
            blk = x.shape[dim] // n
            x = x.narrow(dim, idx * blk, blk)
    return x


def from_local(y, spec, mesh):
    """The global tensor from every rank's block ``y`` under ``spec``:
    ``all_gather`` over each sharded dim's axes, the minor axis first."""
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            if _axis(mesh, a) > 1:
                y = mesh.all_gather(y, a, dim)
    return y


def _with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` with the spec at the same path of
    ``specs`` (a spec tree, or one spec for every leaf); a leaf without a
    spec stays as it is."""
    if isinstance(specs, PartitionSpec):
        return tree_map(lambda x: fn(x, specs), tree)
    if isinstance(tree, dict):
        return {k: _with_specs(fn, v, specs[k]) if k in specs else v
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_specs(fn, v, s) for v, s in zip(tree, specs))
    return tree


def to_local(tree, specs, mesh):
    """Each leaf of ``tree`` cut to this rank's block under the spec at
    the same path of ``specs`` (a spec tree, or one spec for every leaf);
    a leaf without a spec stays whole."""
    return _with_specs(lambda x, s: local_block(x, s, mesh), tree, specs)


def gather_tree(tree, specs, mesh):
    """:func:`to_local` undone: each leaf, this rank's block, put back
    together with :func:`from_local` (a collective every rank calls); a
    leaf without a spec stays as it is."""
    return _with_specs(lambda x, s: from_local(x, s, mesh), tree, specs)
