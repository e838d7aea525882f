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

Each rank holds only its blocks between steps.  A step gathers the
parameters (``sharding.gather_tree``), runs the batch-sharded forward and
backward of ``repro_torch.train.train_step`` on this rank's batch block
(under the ambient ``with mesh:`` the wrapper enters), sums the grads
over the batch axes, takes coordinate 0's grads along every other axis,
takes the global norm and the guard's norm of the whole grads, cuts each
grad to its parameter's block and runs AdamW on the parameter and moment
blocks: element-wise, so the global update cut into blocks.  A key of the
state without a spec (the guard's streak, the compression residual)
stays whole on every rank.  ``ckpt.checkpoint.save(..., specs=, mesh=)``
writes the blocks as global arrays.

Not in scope: tensor-parallel matmuls on the parameter blocks, which
JAX's partitioner derives from the same specs.  Here every rank computes
with the whole gathered parameters, so ``tp`` cuts the bytes a rank holds
between steps (the dry run's ``bytes_per_device``), not its compute
during one.  The MoE family trains so too: its expert tensors are held in
their ``tp`` blocks (E over ``model``, d_in over ``data``) and gathered
for the step like every other parameter, so each rank computes every
expert; its groups, capacity queues and load-balance terms are the
global batch's (``repro_torch.models.moe``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.dist import constraints
from repro_torch.dist.sharding import P, gather_tree, shard_count, to_local
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Blocks:
    """The parameters' blocks under ``specs`` on ``mesh``: what the train
    step's ``layout=`` reads."""

    mesh: object
    specs: object

    def gather(self, params):
        """The whole parameters from every rank's blocks."""
        return gather_tree(params, self.specs, self.mesh)

    def cut(self, grads):
        """Each whole grad's block, contiguous."""
        return tree_map(lambda g: g.contiguous(),
                        to_local(grads, self.specs, self.mesh))


def sharded_step(step_fn: Callable, mesh, param_specs, opt_specs,
                 batch_specs) -> Callable:
    """``step_fn`` (from ``make_train_step``) on this rank's blocks:
    ``(param blocks, opt blocks, batch block, step) -> (param blocks, opt
    blocks, metrics)`` (module docstring).  The moments must be cut as
    the parameters, and the batch as the activation policy cuts it on
    ``mesh``; each raises otherwise."""
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
    layout = Blocks(mesh, param_specs)

    def run(params, opt_state, batch, step: int):
        with mesh:
            return step_fn(params, opt_state, batch, step, layout=layout)

    return run

