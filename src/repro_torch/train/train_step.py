"""The train step: loss -> grads -> AdamW, on one device, with optional
microbatch accumulation, int8 gradient compression with error feedback and
the numerical guard.

Counterpart of ``repro.train.train_step``.  ``make_train_step`` returns a
function

    (params, opt_state, batch, step) -> (params, opt_state, metrics)

that runs eagerly (no ``jit`` counterpart is needed); ``step`` is the
loop's Python int.  Grads keep the parameter dtype, as
``jax.value_and_grad`` gives them (bf16 at full width); the accumulator is
float32.  Everything the guard decides stays on the device: the step reads
nothing back to the host.  The ``grad.values`` fault site sits where the
JAX step has it, after the grads and before compression and the guard:
an armed ``grad.values:nan@stepN`` rule multiplies step N's grads by NaN
(:func:`repro_torch.ft.inject.nan_factor`, decided on the host from the
step number), so the guard drops exactly step N.

On a mesh (the enclosing ``with mesh:``, JAX's ambient mesh) the step
is SPMD.  With an activation policy whose axes cut the batch
(``repro_torch.dist.constraints.batch_split``), ``batch`` is this rank's
block of the global batch (``dist.sharding.batch_specs``), and the
forward and backward run on that block only: the losses take this rank's
share of the global mean (``losses.batch_mean``), the loss, its metrics
and every grad are summed over the batch axes (``Mesh.psum``, a fixed
order, so every rank holds the same bits; on blocks, each grad's block
only), and the global norm and the
clip are the global batch's.  An MoE layer on a block takes its groups,
capacity and expert queues from the global batch and adds this rank's
shares of its load-balance and z terms (``repro_torch.models.moe``), so
the MoE family's step is JAX's on the global batch too.  With
``accum_steps > 1`` on a block, microbatch i is JAX's (rows ``[i B/a, (i
+ 1) B/a)`` of the global batch): the step gathers the batch over the
batch axes and runs this rank's block of each microbatch.
``conv_mesh=`` runs every conv of the loss through
``repro_torch.dist.conv_parallel.conv_mesh``: on a batch block it takes
and returns the block; without a policy it takes and returns global
tensors and the rest of the step runs replicated.  Ranks that hold the
same batch block (along a non-batch axis, or every rank without a
policy) then take the grads and the loss of coordinate 0 of those axes
(``Mesh.broadcast``): one op on the card need not give the same bits in
two processes (a scatter-add's atomics), and this keeps the replicated
parameters bit-identical.

``train_step(..., layout=)`` takes the parameters and AdamW moments as
this rank's blocks (``repro_torch.dist.spmd.sharded_step``, the
counterpart of ``jit(in_shardings=...)``): the step gathers the
parameters as its plan says (``repro_torch.dist.tensor_parallel``: under
``tp``, the leaves a layer computes on by ``model`` block -- attention
heads, Mamba2 heads, RG-LRU channels, MLP columns, experts, vocabulary
rows -- over ``data`` only, a taken leaf -- Mamba2's ``in_proj``,
``conv_w`` and ``out_proj``, the RG-LRU's ``wout`` -- whole and then
sliced, every other leaf whole), runs the above inside the plan's
``model_axis`` (the layers sum their partial outputs over ``model``;
every ``model`` rank computes the same loss), folds each taken leaf's
grad into its stored ``model`` block (``Plan.fold``: each rank sends
each member only what lands in its block), and syncs each grad into
the block its parameter's spec stores (:func:`_sync_blocks`): along the
batch axes a fixed-order reduce-scatter where the spec cuts the leaf
and a fixed-order psum where it does not, as JAX's sharded ``jit``
lowers the sum of the grads, then, along ``model``, coordinate 0's
values of the replicated leaves, each rank receiving only its block.
It takes the norm and the clip of the whole grads from the blocks
(each element counted once over the mesh) and updates the blocks.
Compression quantizes the whole grads: the blocks are put together for
it, and cut again after.  ``train_step.cfg`` is the config the step was made for (the plan reads it).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from repro_torch.dist import constraints, conv_parallel
from repro_torch.dist import tensor_parallel as TP
from repro_torch.dist.sharding import P, from_local
from repro_torch.dist.tensor_parallel import MODEL
from repro_torch.ft import inject
from repro_torch.launch.mesh import tally
from repro_torch.models import model as M
from repro_torch.optim import adamw, compression, schedule
from repro_torch.train import losses
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

#: the compression noise of step s is drawn from a generator seeded with
#: ``NOISE_SEED * 2**32 + s`` (the JAX step folds s into PRNGKey(17)).
NOISE_SEED = 17


def loss_fn(params, batch, cfg):
    """The default LM loss: ``forward`` then ``losses.train_loss``."""
    logits, aux = M.forward(params, batch, cfg)
    return losses.train_loss(logits, aux, batch)


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """The train step's numerical guard.

    A step whose loss or gradient global norm is non-finite is DROPPED:
    params and optimizer state pass through unchanged (a ``torch.where``
    select on the device, no host round trip).  The consecutive-bad streak
    rides in ``opt_state["guard_streak"]``; once it reaches ``clip_after``
    the next steps also clip gradients to ``clip_norm`` (tighter than the
    optimizer's own clip) until a step lands finite.  Escalation past
    clipping -- rollback to the last committed checkpoint -- is the loop's:
    feed ``metrics["guard_bad"]`` to ``repro_torch.ft.failures.GuardState``
    (see ``launch/train.py``).
    """
    clip_after: int = 2
    clip_norm: float = 0.5


def _value_and_grad(loss: Callable, params, batch, cfg, split=None):
    """``(loss, metrics, grads)``: the loss and its metrics detached, the
    grads a tree like ``params`` in each parameter's dtype; a parameter
    the loss never reads (the audio encoder's ``embed``) gets zeros, as
    under ``jax.grad``.  ``split``: the batch is this rank's block of it
    (this rank's shares of the loss and grads)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    block = contextlib.nullcontext() if split is None else \
        constraints.batch_block(split, tree_leaves(batch)[0].shape[0])
    with block:
        loss_val, metrics = loss(tree_unflatten(params, leaves), batch, cfg)
        grads = torch.autograd.grad(loss_val, leaves, allow_unused=True,
                                    materialize_grads=True)
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
    return loss_val.detach(), metrics, tree_unflatten(params, list(grads))


def _microbatch(batch, accum_steps: int, i: int, split=None):
    """Microbatch ``i`` of ``accum_steps``: rows ``[i B/a, (i + 1) B/a)``
    of ``batch`` on its leading axis; on a batch block (``batch`` the
    global batch, gathered by the caller), this rank's block of them."""
    rows = tree_leaves(batch)[0].shape[0]
    n, r = (1, 0) if split is None else split.index()
    if rows % (accum_steps * n):
        raise ValueError(f"a batch of {rows} rows does not split into "
                         f"{accum_steps} microbatches of {n} blocks")
    per = rows // (accum_steps * n)
    start = (i * n + r) * per
    return tree_map(lambda x: x[start:start + per], batch)


def _accumulated(loss: Callable, params, batch, cfg, accum_steps: int,
                 split=None):
    """The batch split on its leading axis into ``accum_steps``
    microbatches (:func:`_microbatch`: JAX's microbatches, on a batch
    block too, where the block's batch is gathered over the batch axes
    first): grads summed in float32 zeros, then divided; loss and metrics
    the mean over the microbatches."""
    if split is not None:
        batch = tree_map(lambda x: from_local(x, P(split.axes), split.mesh),
                         batch)
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    l_acc = 0.0
    ms = []
    for i in range(accum_steps):
        loss_val, m, g = _value_and_grad(
            loss, params, _microbatch(batch, accum_steps, i, split), cfg,
            split)
        g_acc = tree_map(torch.add, g_acc, g)
        l_acc = l_acc + loss_val
        ms.append(m)
    metrics = {k: torch.stack([torch.as_tensor(m[k]) for m in ms]).mean()
               for k in ms[0]}
    return (l_acc / accum_steps, metrics,
            tree_map(lambda g: g / accum_steps, g_acc))


def _sync(mesh, batch_axes: tuple[str, ...], loss_val, metrics, grads,
          layout=None):
    """Every rank's shares of the loss, its tensor metrics and the grads
    summed over ``batch_axes`` (``Mesh.psum_flat``: a fixed order, one
    buffer per dtype); then, over each other axis of size > 1 (whose
    ranks hold the same batch block), coordinate 0's values.

    With a ``layout`` (``dist.spmd.Blocks``) each grad leaves as the block
    its parameter's spec stores (:func:`_sync_blocks`); without one every
    grad leaves whole.  The bytes the grads' collectives send and receive
    are counted in ``tensor_parallel.COUNTS`` (``scatter_bytes``,
    ``scatter_received``)."""
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    vals = [loss_val, *(metrics[k] for k in keys)]
    leaves = tree_leaves(grads)
    if batch_axes:
        vals = mesh.psum_flat(vals, batch_axes)
    others = [a for a, n in mesh.shape.items()
              if n > 1 and a not in batch_axes]
    for axis in others:
        mesh.broadcast(vals, axis)
    with tally(TP.COUNTS, "scatter_bytes", "scatter_received"):
        if layout is not None:
            leaves = _sync_blocks(mesh, batch_axes, others, leaves, layout)
        else:
            if batch_axes:
                leaves = mesh.psum_flat(leaves, batch_axes)
            for axis in others:
                mesh.broadcast(leaves, axis)
    return (vals[0], {**metrics, **dict(zip(keys, vals[1:]))},
            tree_unflatten(grads, leaves))


def _cut_dim(spec, axis: str):
    """The dim ``spec`` cuts over ``axis`` alone, or None."""
    for d, e in enumerate(spec):
        names = e if isinstance(e, tuple) else (e,)
        if axis in names:
            if len(names) > 1:
                raise ValueError(f"{spec} cuts a dim over {names}: the "
                                 f"sync cuts one axis a dim")
            return d
    return None


def _sync_blocks(mesh, batch_axes, others, leaves, layout):
    """The grads (a kept leaf's its ``model`` block, every other leaf's
    whole) as their parameters' stored blocks, summed over the batch
    axes: along each batch axis, a reduce-scatter of the leaves the
    spec cuts on it and a psum of the rest (``Mesh.psum_scatter_flat``,
    the sums' order ``Mesh.psum``'s, so the blocks hold the bits of the
    whole sum cut); then, along each other axis, coordinate 0's values of
    the leaves not kept on their ``model`` block: each member receives
    only the block it stores (``Mesh.scatter``), a leaf the spec does
    not cut on the axis whole (``Mesh.broadcast``)."""
    specs = tree_leaves(layout.plan.compute_specs)
    kept = layout.plan.kept
    for axis in batch_axes:
        leaves = mesh.psum_scatter_flat(leaves, axis,
                                        [_cut_dim(s, axis) for s in specs])
    for axis in others:
        sync = [i for i, k in enumerate(kept) if not (k and axis == MODEL)]
        dims = {i: _cut_dim(specs[i], axis) for i in sync}
        cut = [i for i in sync if dims[i] is not None]
        if cut:
            for i, g in zip(cut, mesh.scatter([leaves[i] for i in cut], axis,
                                              [dims[i] for i in cut])):
                leaves[i] = g
        mesh.broadcast([leaves[i] for i in sync if dims[i] is None], axis)
    return leaves


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *,
                    total_steps: int = 10000, warmup: int = 100,
                    schedule_name: str | None = None,
                    accum_steps: int = 1, compress_grads: bool = False,
                    conv_policy=None, conv_mesh=None,
                    loss: Callable | None = None,
                    guard: GuardConfig | bool | None = None,
                    donate: bool = False) -> Callable:
    """``cfg`` is an ``ArchConfig`` (the default LM loss) or any frozen
    dataclass the ``loss`` plugin reads (for example
    ``AutoencoderConfig``).  ``loss(params, batch, cfg) -> (loss,
    metrics)`` replaces the default LM loss.  The learning rate follows
    ``schedule_name`` (default: ``schedule.default_schedule_for(cfg.name)``,
    WSD for MiniCPM, cosine otherwise).

    accum_steps: microbatches per step (the batch's leading axis must
    divide).

    compress_grads: int8-quantize gradients with error feedback before the
    optimizer -- the numerics of a compressed cross-pod all-reduce; the
    residual rides in ``opt_state["ef"]``.

    conv_mesh: a ``conv_parallel`` policy (``"tp"``, ``"dp_only"``,
    ``"tp_rep"``, ``"spatial"`` or a ``ConvParallel``) for every conv of
    the loss, on the mesh of the enclosing ``with mesh:`` (module
    docstring); None runs the convs unsharded.

    conv_policy: override ``cfg.conv_policy`` for every conv of the model
    (an ``EnginePolicy``, a policy string or an engine name); a config
    without the field has no conv to apply it to.

    guard: a :class:`GuardConfig` (or ``True`` for the defaults) arms the
    numerical guard; ``metrics`` gain ``guard_bad``, ``guard_streak`` and
    ``guard_clipped``, and ``opt_state`` keeps ``guard_streak`` on the
    device.  None/False (the default) runs the unguarded step.

    donate: the step writes the new parameters and AdamW moments into the
    ones it is given (the caller hands them over, as with ``jax.jit``'s
    ``donate_argnums``, and keeps only what the step returns), so no
    second copy of the model and its moments is held: a model whose
    parameters and moments take more than half the card trains only so
    (recurrentgemma-9b at 5 layers: 3.22 B parameters, 38.6 GB with the
    moments).  The values are the functional step's bit for bit; the
    guard's skip-step selects inside the update."""
    if loss is None:
        loss = loss_fn
    if guard is True:
        guard = GuardConfig()
    elif guard is False:
        guard = None
    if conv_policy is not None and any(
            f.name == "conv_policy" for f in dataclasses.fields(cfg)):
        # conv_mode=None (where the config has it): the override must win
        # even over a config that still sets the deprecated field.
        extra = {"conv_mode": None} if hasattr(cfg, "conv_mode") else {}
        cfg = dataclasses.replace(cfg, conv_policy=str(conv_policy),
                                  **extra)
    sched = schedule.SCHEDULES[schedule_name
                               or schedule.default_schedule_for(cfg.name)]

    def train_step(params, opt_state, batch, step: int, *, layout=None):
        split = constraints.batch_split()
        full = params if layout is None else layout.gather(params)
        norm = adamw.global_norm if layout is None else layout.global_norm
        dev = tree_leaves(params)[0].device
        opt_in = opt_state            # the state that entered the step
        with conv_parallel.conv_mesh(conv_mesh), (
                contextlib.nullcontext() if layout is None
                else layout.plan.axis()):
            if accum_steps == 1:
                loss_val, metrics, grads = _value_and_grad(loss, full, batch,
                                                           cfg, split)
            else:
                loss_val, metrics, grads = _accumulated(
                    loss, full, batch, cfg, accum_steps, split)
        del full
        if layout is not None:
            grads = layout.plan.fold(grads)
        mesh = split.mesh if split is not None else (
            layout.mesh if layout is not None else
            constraints._active_mesh() if conv_mesh is not None else None)
        if mesh is not None and mesh.size > 1:
            loss_val, metrics, grads = _sync(
                mesh, split.axes if split is not None else (), loss_val,
                metrics, grads, layout)

        # Fault injection on the gradient VALUES, where the JAX step has
        # it: the guard below then sees step N non-finite.
        nan_steps = inject.value_fault_steps("grad.values")
        if nan_steps is not None:
            factor = inject.nan_factor(step, nan_steps)
            if factor != 1.0:
                grads = tree_map(lambda g: g * factor, grads)

        if compress_grads:
            if layout is not None:
                grads = layout.plan.widen(grads)
            ef = opt_state.get("ef") or tree_map(
                lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)
            grads = tree_map(lambda g, e: g.float() + e, grads, ef)
            gen = torch.Generator(dev).manual_seed(
                (NOISE_SEED << 32) + step)
            q, residual = compression.compress_tree_int8(grads, gen)
            grads = compression.decompress_tree_int8(q)
            if layout is not None:
                grads = layout.plan.narrow(grads)
            opt_state = {**opt_state, "ef": residual}

        if guard is not None:
            streak0 = opt_state.get("guard_streak", torch.zeros(
                (), dtype=torch.int32, device=dev))
            gnorm = norm(grads)
            # One reduction catches every inf/NaN leaf: a single non-finite
            # value makes the sqrt of the sum of squares non-finite.
            finite = torch.isfinite(loss_val) & torch.isfinite(gnorm)
            clipping = streak0 >= guard.clip_after
            gscale = torch.where(clipping, torch.clamp(
                guard.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0),
                1.0)
            # float32, as the JAX step's bf16 grad times a float32 scale.
            grads = tree_map(lambda g: g.float() * gscale, grads)

        lr = sched(step + 1, peak_lr=opt_cfg.peak_lr, warmup=warmup,
                   total=total_steps)
        # On blocks, the clip of the whole grads from each rank's blocks
        # (the sync left every grad its parameter's block).
        gnorm = None if layout is None else norm(grads)
        new_params, new_opt, opt_metrics = adamw.apply_updates(
            params, grads,
            {k: v for k, v in opt_state.items()
             if k not in ("ef", "guard_streak")},
            lr, opt_cfg, in_place=donate,
            keep_if=finite if donate and guard is not None else None,
            gnorm=gnorm)
        if compress_grads:
            new_opt["ef"] = opt_state["ef"]
        metrics = {**metrics, **opt_metrics}

        if guard is not None:
            # Skip-step select: a non-finite step passes params and
            # optimizer state through unchanged.  A key missing from the
            # entering state ("ef" on the first compressed step) selects
            # against zeros, never against a NaN-tainted new value.
            def keep_old(new, old):
                return tree_map(lambda n, o: torch.where(finite, n, o),
                                new, old)
            # A donated update has selected its own leaves already.
            selected = ("m", "v", "step") if donate else ()
            if not donate:
                new_params = keep_old(new_params, params)
            new_opt = {
                k: v if k in selected else
                keep_old(v, opt_in[k] if k in opt_in
                         else tree_map(torch.zeros_like, v))
                for k, v in new_opt.items()}
            streak = torch.where(finite, 0, streak0 + 1).to(torch.int32)
            new_opt["guard_streak"] = streak
            metrics = {**metrics,
                       "guard_bad": (~finite).float(),
                       "guard_streak": streak.float(),
                       "guard_clipped": (clipping & finite).float()}
        return new_params, new_opt, metrics

    train_step.cfg = cfg
    return train_step
