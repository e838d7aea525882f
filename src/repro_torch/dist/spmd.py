"""The train step on blocks: parameters, AdamW moments and the batch held
in their ``dist.sharding`` blocks on every rank, the port's counterpart
of ``jax.jit(step, in_shardings=(p_sh, o_sh, b_sh), out_shardings=(p_sh,
o_sh, None))`` (``tests/test_distributed.py``).

    p_spec = sharding.param_specs(params, mesh, "tp")
    o_spec = sharding.opt_state_specs(params, mesh, "tp")
    b_spec = sharding.batch_specs(batch, mesh, "tp")
    set_activation_policy(sharding.batch_axes(mesh, "tp"))
    step = sharded_step(make_train_step(cfg, opt_cfg), mesh, p_spec,
                        o_spec, b_spec)
    p, o = to_local(params, p_spec, mesh), to_local(opt, o_spec, mesh)
    p, o, metrics = step(p, o, to_local(batch, b_spec, mesh), 0)

Each rank holds only its blocks between steps.  Under a policy whose
specs cut parameters over ``model`` (``tp``), the step computes on the
``model`` blocks wherever a layer has a rule for them
(``repro_torch.dist.tensor_parallel.plan``, worked out once here from the
specs and the step's config): each rank runs its own query heads and
their KV groups (or, where the KV heads do not divide, its query heads
against K and V computed whole), MLA heads (against the latents and the
rope key computed whole), Mamba2 heads, RG-LRU channels, MLP columns,
experts and vocabulary rows, summing partial outputs over ``model``, and
its ``d_model`` columns of the frontends' and the MTP head's
projections, gathering their outputs over ``model``.  A kept leaf is
gathered over ``data`` only; a taken leaf (whose stored block cuts
across the layer's units: Mamba2's ``in_proj``, ``conv_w`` and
``out_proj``, the RG-LRU's ``wout``) is gathered whole and sliced, and
its slice's grad folded back into its stored block before the grads are
summed (``Plan.fold``).  Every other leaf is gathered whole
(``sharding.gather_tree``), with the plan's reason: MLA's latent
projections, the router, conv kernels (``dist.conv_parallel`` cuts
them), heads that do not divide.
``dp_only`` and ``tp_rep`` specs name no ``model`` axis, so there every
leaf is gathered whole, as is every leaf of a model with no rule here
(the autoencoder).

A step then runs the batch-sharded forward and backward of
``repro_torch.train.train_step`` on this rank's batch block (under the
ambient ``with mesh:`` the wrapper enters, and the plan's
``model_axis``), folds each taken leaf's grad into its stored block,
and syncs each grad into the block its parameter's spec stores
(``train_step._sync`` with the layout): a fixed-order reduce-scatter
over each batch axis that cuts the leaf and a fixed-order psum over each
that does not (what XLA lowers the sharded ``jit``'s grad sum to), then
coordinate 0's block of every replicated leaf along every other axis (a
kept leaf's is its own block).  It takes the global norm and the
guard's norm from the blocks (each element counted once over the mesh,
the squares summed over the mesh in coordinate order) and runs AdamW on
the parameter and moment blocks: element-wise, so the global update cut
into blocks.  A key of the state without a spec (the guard's streak,
the compression residual) stays whole on every rank.
``ckpt.checkpoint.save(..., specs=, mesh=)`` writes the blocks as global
arrays.

Each grad's block holds the bits of the whole sum, added in coordinate
order, cut to the block.  ``run.layout`` (the :class:`Blocks` of a step from
:func:`sharded_step`) holds the plan and the bytes the last step
gathered and computed with.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.dist import constraints, tensor_parallel
from repro_torch.dist.sharding import P, gather_tree, shard_count
from repro_torch.tree import tree_leaves


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@dataclasses.dataclass(frozen=True)
class Blocks:
    """The parameters' blocks under ``specs`` on ``mesh`` and the plan of
    their compute: what the train step's ``layout=`` reads.  ``stats``
    holds ``gathered_bytes``, the bytes of the parameters the last step
    gathered, and ``computed_bytes``, the bytes it computed with (a taken
    leaf's slice of its gathered whole)."""

    mesh: object
    specs: object
    plan: tensor_parallel.Plan
    stats: dict = dataclasses.field(default_factory=dict, compare=False)

    def gather(self, params):
        """Each parameter as the step computes with it: a kept leaf's
        ``model`` block, a taken leaf's slice, every other leaf whole."""
        full = gather_tree(params, self.plan.gather_specs, self.mesh)
        self.stats["gathered_bytes"] = _nbytes(full)
        full = self.plan.take(full)
        self.stats["computed_bytes"] = _nbytes(full)
        return full

    def global_norm(self, grads):
        """The norm of the whole grads from this rank's blocks."""
        return tensor_parallel.global_norm(grads, self.plan)


def sharded_step(step_fn: Callable, mesh, param_specs, opt_specs,
                 batch_specs) -> Callable:
    """``step_fn`` (from ``make_train_step``) on this rank's blocks:
    ``(param blocks, opt blocks, batch block, step) -> (param blocks, opt
    blocks, metrics)`` (module docstring), its compute planned from
    ``step_fn.cfg``; ``run.layout`` is its :class:`Blocks`.  The moments
    must be cut as the parameters, and the batch as the activation policy
    cuts it on ``mesh``; each raises otherwise."""
    for key in ("m", "v"):
        if opt_specs[key] != param_specs:
            raise ValueError(f"AdamW's {key!r} is cut otherwise than the "
                             f"parameters: an element-wise update needs "
                             f"the same blocks")
    split = constraints.batch_split(mesh)
    want = 1
    if split is not None:
        for a in split.axes:
            want *= mesh.shape[a]
    cuts = {shard_count(P(*s[:1]), mesh) for s in tree_leaves(batch_specs)}
    if cuts != {want}:
        raise ValueError(
            f"the batch specs cut the batch into {sorted(cuts)} blocks, the "
            f"activation policy into {want} on {mesh!r}: set the policy to "
            f"the batch specs' axes (sharding.batch_axes) and a batch that "
            f"divides")
    layout = Blocks(mesh, param_specs, tensor_parallel.plan(
        param_specs, step_fn.cfg, mesh))

    def run(params, opt_state, batch, step: int):
        with mesh:
            return step_fn(params, opt_state, batch, step, layout=layout)

    run.layout = layout
    return run

