"""Mesh-parallel conv lowerings over ``torch.distributed``, with the
tap-derived halo exchange (counterpart of ``repro.dist.conv_parallel``).

The tap-GEMM engines are single-device programs; this module runs them
*sharded* without touching them.  A :class:`ConvParallel` policy names
which mesh axes shard which conv role -- batch, spatial H/W, Cin, Cout --
and :func:`conv_mesh` installs a lowering hook on ``repro_torch.core.conv``
that intercepts every ``conv2d`` / ``conv2d_transpose`` in its dynamic
extent.  Calls that pass :func:`plan_conv_sharding`'s divisibility and
geometry checks run the per-pass SPMD bodies below (inside their own
``torch.autograd.Function``); everything else runs the single-device conv
with the reason recorded in ``dispatch_events`` / ``policy_decisions``.

SPMD, at the caller's boundary.  Inside a batch-sharded train step
(``repro_torch.dist.constraints.batch_block``: an activation policy on the
active mesh) the lowering takes and returns this rank's BATCH BLOCK: the
plan's batch role is the step's cut, already made, so no rank cuts the
batch again and no output is gathered over it; the weight grad is this
block's, and the step sums it over the batch axes with every other grad.
Otherwise it takes and returns the caller's GLOBAL tensors, replicated on
every rank, as ``shard_map`` over a global array does, and cuts the batch
itself.  Either way each rank cuts its block of the other roles by its
mesh coordinate (the ``in_specs``), runs the body -- every local pass
through ``core.conv._execute`` at the shard's own geometry, so under
``pallas`` each shard launches the card's tap kernels -- and the output
is put back together with ``all_gather`` over the axes the ``out_specs``
shard (Cout under ``tp``, H under ``spatial``).  The collectives are the
mesh's (``repro_torch.launch.mesh.Mesh``): ``psum`` as a fixed-order sum
over the named axes, ``ppermute`` as one ``batch_isend_irecv`` along an
axis.

Spatial sharding exchanges exactly the planner's tap-derived halos
(:func:`repro_torch.kernels.ops.shard_halo`): ``lo = P_lo`` and
``hi = span - s - P_lo`` rows/cols per boundary, where ``span`` is the
extent of the KEPT kernel taps, so no dilation zero crosses the wire.  A
rank that no pair names receives zeros, so edge shards get exactly the
zero rows the global padding would have provided: the halo exchange *is*
the padding.

Reduction placement per pass:

    ==============  ===============  ===============  ==================
    pass            regular conv     transposed conv  psum axis
    ==============  ===============  ===============  ==================
    forward         contracts Cin    contracts Cin    ``cin`` shards
    input grad      contracts Cout   contracts Cout   ``cout`` shards
    weight grad     contracts B,H,W  contracts B,H,W  ``batch`` + spatial
                                                      (spatial only on a
                                                      batch block)
    ==============  ===============  ===============  ==================

Transposed convs ride the mirror-conv identity end to end: the mirror
input plane (the transposed layer's OUTPUT) is the halo-exchanged plane;
the transposed forward scatter-adds halo contributions (the transpose of
the regular gather), the transposed input grad gathers them.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.core import conv as C
from repro_torch.core.convspec import ConvSpec, ConvTransposeSpec
from repro_torch.dist.constraints import _active_mesh, current_block
from repro_torch.dist.sharding import P, from_local, local_block
from repro_torch.kernels.ops import shard_halo
from repro_torch.obs import events as obs_events
from repro_torch.obs import trace as obs_trace

#: conv-role names a plan can shard (event tags join them with "+").
ROLES = ("data", "h", "w", "cin", "cout")

#: the policy names :func:`conv_mesh` takes.
POLICIES = ("tp", "tensor_parallel", "dp_only", "tp_rep", "spatial")


def _mesh_axes(mesh) -> dict:
    return dict(mesh.shape)


def _size(mesh, axes) -> int:
    if not axes:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = _mesh_axes(mesh)
    total = 1
    for a in axes:
        total *= shape.get(a, 1)
    return total


# ---------------------------------------------------------------------------
# Policy: which mesh axes shard which conv role
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvParallel:
    """Mesh-axis assignment per conv role.

    ``batch`` is a tuple of axis names carrying the batch dim; ``h``/``w``
    spatially partition the activation planes with halo exchange;
    ``cin``/``cout`` partition the channel contractions."""

    batch: tuple[str, ...] = ()
    h: str | None = None
    w: str | None = None
    cin: str | None = None
    cout: str | None = None

    @classmethod
    def from_policy(cls, policy, mesh) -> "ConvParallel":
        """Resolve a ``dist.sharding`` policy name against a mesh.

        ``tp``      -- batch over ("pod", "data"); Cout over "model" (Cin
                       stays replicated so it cannot collide with the
                       batch axes).
        ``dp_only`` -- pure data parallelism: batch over every axis.
        ``tp_rep``  -- batch over ("pod", "data"), params replicated.
        ``spatial`` -- batch over ("pod", "data"); H over "model" with halo
                       exchange.
        """
        if isinstance(policy, cls):
            return policy
        names = tuple(_mesh_axes(mesh))
        dp = tuple(a for a in ("pod", "data") if a in names)
        if policy == "dp_only":
            return cls(batch=tuple(a for a in ("pod", "data", "model")
                                   if a in names))
        if policy in ("tp", "tensor_parallel"):
            return cls(batch=dp, cout="model" if "model" in names else None)
        if policy == "tp_rep":
            return cls(batch=dp)
        if policy == "spatial":
            return cls(batch=dp, h="model" if "model" in names else None)
        raise ValueError(
            f"unknown conv mesh policy {policy!r}; expected a ConvParallel "
            f"or one of 'tp', 'dp_only', 'tp_rep', 'spatial'")

    @classmethod
    def coerce(cls, value, mesh) -> "ConvParallel":
        if isinstance(value, cls):
            return value
        return cls.from_policy(value, mesh)


# ---------------------------------------------------------------------------
# Plan: the checked, per-layer shard assignment
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvShardPlan:
    """One conv layer's mesh assignment after every divisibility / geometry
    check: the roles that survived, the tap-derived halos for the spatial
    ones, and the roles that were dropped with WHY."""

    mesh: object
    batch: tuple[str, ...] = ()
    h: str | None = None
    w: str | None = None
    cin: str | None = None
    cout: str | None = None
    halo_h: tuple[int, int] = (0, 0)
    halo_w: tuple[int, int] = (0, 0)
    transposed: bool = False
    dropped: tuple[tuple[str, str], ...] = ()
    batch_local: bool = False

    @property
    def roles(self) -> tuple[str, ...]:
        out = []
        if self.batch:
            out.append("data")
        for role in ("h", "w", "cin", "cout"):
            if getattr(self, role):
                out.append(role)
        return tuple(out)

    @property
    def tag(self) -> str:
        return "+".join(self.roles) or "replicated"

    def size(self, axes) -> int:
        return _size(self.mesh, axes)

    @property
    def batch_spec(self):
        """The batch dim's spec entry for a global tensor; None on a batch
        block (nothing left to cut)."""
        if not self.batch or self.batch_local:
            return None
        return self.batch if len(self.batch) > 1 else self.batch[0]

    @property
    def batch_cut(self) -> int:
        """How many blocks this plan cuts the caller's batch into."""
        return 1 if self.batch_local else self.size(self.batch)


def _check_spatial(name: str, n: int, h_i: int, h_o: int, s: int,
                   lo: int, hi: int) -> str | None:
    """None if an input plane of ``h_i`` rows (output ``h_o``) can be cut
    into ``n`` uniform blocks whose stride windows tile exactly, else the
    reason it cannot."""
    if h_i % n:
        return f"{name}: input extent {h_i} % {n} shards != 0"
    if h_o % n:
        return f"{name}: output extent {h_o} % {n} shards != 0"
    if h_i != s * h_o:
        return (f"{name}: non-uniform geometry (input {h_i} != stride {s} x "
                f"output {h_o}); spatial sharding needs SAME-style padding")
    blk = h_i // n
    if lo > blk or hi > blk:
        return (f"{name}: halo ({lo}, {hi}) exceeds the {blk}-row shard "
                f"block (single-hop exchange)")
    return None


def plan_conv_sharding(x_shape, w_shape, spec, par: ConvParallel,
                       mesh, batch_local=None) -> ConvShardPlan:
    """Validate a :class:`ConvParallel` request against one layer's geometry.

    ``batch_local``: the mesh axes a batch-sharded step cut the batch
    over; ``x_shape`` is then this rank's block, and those axes are the
    batch role whatever ``par.batch`` asks (already cut: nothing to check).

    Degrades per role, never whole-or-nothing: an indivisible batch drops
    only the batch sharding, a non-uniform plane drops only that spatial
    axis, a grouped conv drops only the channel roles -- each with a
    recorded reason.  Size-1 / absent-from-the-mesh axes are dropped
    silently (sharding over them is the identity).  ``mesh`` only needs a
    ``.shape`` mapping, so plans are testable without a process group.
    """
    transposed = isinstance(spec, ConvTransposeSpec)
    d = (C.transpose_dims if transposed else C.spec_dims)(
        x_shape, w_shape, spec)
    shape = _mesh_axes(mesh)
    dropped: list[tuple[str, str]] = []
    used: set[str] = set()

    def usable(role: str, axes) -> tuple[str, ...]:
        """The present, size>1, not-yet-claimed axes of a role request."""
        keep = []
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            if a is None:
                continue
            if a not in shape:
                dropped.append((role, f"axis {a!r} not in mesh "
                                      f"{tuple(shape)}"))
            elif a in used:
                dropped.append((role, f"axis {a!r} already claimed by "
                                      f"another role"))
            elif shape[a] > 1:
                keep.append(a)
        return tuple(keep)

    # batch ----------------------------------------------------------------
    if batch_local:
        batch = tuple(a for a in batch_local if shape.get(a, 1) > 1)
    else:
        batch = usable("data", par.batch)
        if batch and d.B % _size(mesh, batch):
            dropped.append(("data", f"batch {d.B} % {_size(mesh, batch)} "
                                    f"shards != 0"))
            batch = ()
    used.update(batch)

    # spatial (regular: the input plane; transposed: the MIRROR input
    # plane, i.e. the transposed layer's output) --------------------------
    (lo_h, hi_h), (lo_w, hi_w) = shard_halo(d)
    h_axis = w_axis = None
    for role, axis, h_i, h_o, s, lo, hi in (
            ("h", par.h, d.H_i, d.H_o, d.s_h, lo_h, hi_h),
            ("w", par.w, d.W_i, d.W_o, d.s_w, lo_w, hi_w)):
        ax = usable(role, axis)
        if not ax:
            continue
        why = _check_spatial(role, shape[ax[0]], h_i, h_o, s, lo, hi)
        if why:
            dropped.append((role, why))
            continue
        used.add(ax[0])
        if role == "h":
            h_axis = ax[0]
        else:
            w_axis = ax[0]

    # channels (x_shape[1] is Cin for both layouts; Cout is w dim 0 for
    # regular OIHW, dim 1 x groups for transposed (C_in, C_out/g, ...)) ----
    cin_n = x_shape[1]
    cout_n = w_shape[1] * spec.groups if transposed else w_shape[0]
    cin_axis = cout_axis = None
    for role, axis, count in (("cin", par.cin, cin_n),
                              ("cout", par.cout, cout_n)):
        ax = usable(role, axis)
        if not ax:
            continue
        if spec.groups > 1:
            dropped.append((role, f"grouped conv (groups={spec.groups}): "
                                  f"channel sharding would split groups"))
            continue
        n = shape[ax[0]]
        if count % n:
            dropped.append((role, f"{role} {count} % {n} shards != 0"))
            continue
        used.add(ax[0])
        if role == "cin":
            cin_axis = ax[0]
        else:
            cout_axis = ax[0]

    return ConvShardPlan(
        mesh=mesh, batch=batch, h=h_axis, w=w_axis,
        cin=cin_axis, cout=cout_axis,
        halo_h=(lo_h, hi_h), halo_w=(lo_w, hi_w),
        transposed=transposed, dropped=tuple(dropped),
        batch_local=bool(batch_local))


# ---------------------------------------------------------------------------
# Halo exchange: gather (fwd/wgrad) and its transpose, scatter-add (dgrad)
# ---------------------------------------------------------------------------

def _record_halo(op: str, axis_name: str, dim: int, send) -> None:
    """One bus event per halo send: the bytes this shard's exchange puts
    on the wire in that direction (an edge shard's too, whose send has no
    receiver, as JAX's trace-time count of the collective)."""
    if obs_events.enabled():
        obs_events.emit("halo", f"{op}:{axis_name}:dim{dim}",
                        bytes=send.numel() * send.element_size(),
                        shape=[int(s) for s in send.shape])


def _halo_gather(x, mesh, axis_name: str, n: int, lo: int, hi: int,
                 dim: int):
    """Extend a local block with ``lo`` rows from the low neighbor and
    ``hi`` from the high neighbor along ``dim``.  A rank with no neighbor
    on a side receives zeros: the rows the global padding supplies.
    ``hi < 0`` crops instead (adjacent windows do not reach those rows)."""
    with obs_trace.span("halo:gather", axis=axis_name, dim=dim,
                        lo=lo, hi=hi, shards=n):
        sends = []
        if lo > 0:
            sends.append((x.narrow(dim, x.shape[dim] - lo, lo), 1))
        if hi > 0:
            sends.append((x.narrow(dim, 0, hi), -1))
        for send, _ in sends:
            _record_halo("gather", axis_name, dim, send)
        recvs = mesh.permute(sends, axis_name) if sends else []
        parts = [x]
        if lo > 0:
            parts.insert(0, recvs.pop(0))
        if hi > 0:
            parts.append(recvs.pop(0))
        out = torch.cat(parts, dim) if len(parts) > 1 else x
        if hi < 0:
            out = out.narrow(dim, 0, out.shape[dim] + hi)
        return out


def _halo_scatter(x_ext, mesh, axis_name: str, n: int, lo: int, hi: int,
                  dim: int, block: int):
    """The exact transpose of :func:`_halo_gather`: fold an extended
    block's overhang rows back onto the neighbors that own them (summing,
    since seam outputs accumulate contributions from both sides).  Edge
    overhang with no receiver is dropped -- those are gradients of
    padding zeros."""
    with obs_trace.span("halo:scatter", axis=axis_name, dim=dim,
                        lo=lo, hi=hi, shards=n):
        if hi < 0:
            pad = [0, 0] * (x_ext.ndim - 1 - dim) + [0, -hi]
            x_ext = torch.nn.functional.pad(x_ext, pad)
            hi = 0
        x = x_ext.narrow(dim, lo, block)
        sends = []
        if lo > 0:
            sends.append((x_ext.narrow(dim, 0, lo), -1))
        if hi > 0:
            sends.append((x_ext.narrow(dim, lo + block, hi), 1))
        for send, _ in sends:
            _record_halo("scatter", axis_name, dim, send)
        recvs = mesh.permute(sends, axis_name) if sends else []
        if lo > 0:
            x = torch.cat([x.narrow(dim, 0, block - lo),
                           x.narrow(dim, block - lo, lo) + recvs.pop(0)],
                          dim)
        if hi > 0:
            x = torch.cat([x.narrow(dim, 0, hi) + recvs.pop(0),
                           x.narrow(dim, hi, block - hi)], dim)
        return x


def _gather_spatial(x, plan: ConvShardPlan):
    if plan.h:
        x = _halo_gather(x, plan.mesh, plan.h, plan.size(plan.h),
                         *plan.halo_h, dim=2)
    if plan.w:
        x = _halo_gather(x, plan.mesh, plan.w, plan.size(plan.w),
                         *plan.halo_w, dim=3)
    return x


def _scatter_spatial(x_ext, plan: ConvShardPlan, blk_h: int, blk_w: int):
    # reverse order of _gather_spatial: scatter is its exact transpose,
    # corner halos retrace their two hops.
    if plan.w:
        x_ext = _halo_scatter(x_ext, plan.mesh, plan.w, plan.size(plan.w),
                              *plan.halo_w, dim=3, block=blk_w)
    if plan.h:
        x_ext = _halo_scatter(x_ext, plan.mesh, plan.h, plan.size(plan.h),
                              *plan.halo_h, dim=2, block=blk_h)
    return x_ext


def _ext(extent: int, n_shards: int, halo: tuple[int, int],
         sharded: bool) -> int:
    """Local gathered extent of one spatial axis."""
    if not sharded:
        return extent
    return extent // n_shards + halo[0] + halo[1]


def _local_spec(spec: ConvSpec, plan: ConvShardPlan) -> ConvSpec:
    """The per-shard geometry: padding zeroed on sharded axes (the halo
    exchange delivers the edge zeros), untouched elsewhere."""
    ph, pw = spec.padding
    if plan.h:
        ph = (0, 0)
    if plan.w:
        pw = (0, 0)
    return dataclasses.replace(spec, padding=(ph, pw))


def _local_tspec(spec: ConvTransposeSpec,
                 plan: ConvShardPlan) -> ConvTransposeSpec:
    """Transposed mirror of :func:`_local_spec`: padding AND
    output_padding zeroed on sharded axes, so each shard produces the full
    extended mirror plane and the scatter crops/folds the seams."""
    ph, pw = spec.padding
    oh, ow = spec.output_padding
    if plan.h:
        ph, oh = (0, 0), 0
    if plan.w:
        pw, ow = (0, 0), 0
    return dataclasses.replace(spec, padding=(ph, pw),
                               output_padding=(oh, ow))


def _wgrad_axes(plan: ConvShardPlan) -> tuple[str, ...]:
    """weight grad contracts batch x spatial: psum over all three, but the
    batch on a batch block, whose step sums every grad over it."""
    batch = () if plan.batch_local else plan.batch
    return batch + tuple(a for a in (plan.h, plan.w) if a)


def _block(t, spec, plan: ConvShardPlan):
    return local_block(t, spec, plan.mesh).contiguous()


# ---------------------------------------------------------------------------
# Regular conv: the three pass bodies
# ---------------------------------------------------------------------------

def _act_spec(plan: ConvShardPlan, channel) -> P:
    return P(plan.batch_spec, channel, plan.h, plan.w)


def _fwd_regular(x, w, spec: ConvSpec, policy, plan: ConvShardPlan):
    ls = _local_spec(spec, plan)
    xb = _block(x, _act_spec(plan, plan.cin), plan)
    wb = _block(w, P(plan.cout, plan.cin, None, None), plan)
    x_ext = _gather_spatial(xb, plan)
    d = C.spec_dims(x_ext.shape, wb.shape, ls)
    y = C._execute(
        "forward", policy.forward, d, False, ls.groups, x.device, x.dtype,
        lambda eng: eng.forward(x_ext, C._weight_for(eng, wb, ls), d,
                                ls.groups))
    if plan.cin:
        y = plan.mesh.psum(y, (plan.cin,))
    return from_local(y, _act_spec(plan, plan.cout), plan.mesh)


def _dgrad_regular(dy, w, x_shape, spec: ConvSpec, policy,
                   plan: ConvShardPlan):
    ls = _local_spec(spec, plan)
    b_loc = x_shape[0] // plan.batch_cut
    c_loc = x_shape[1] // plan.size(plan.cin)
    blk_h, blk_w = (x_shape[2] // plan.size(plan.h),
                    x_shape[3] // plan.size(plan.w))
    h_ext = _ext(x_shape[2], plan.size(plan.h), plan.halo_h, bool(plan.h))
    w_ext = _ext(x_shape[3], plan.size(plan.w), plan.halo_w, bool(plan.w))
    dyb = _block(dy, _act_spec(plan, plan.cout), plan)
    wb = _block(w, P(plan.cout, plan.cin, None, None), plan)
    d = C.spec_dims((b_loc, c_loc, h_ext, w_ext), wb.shape, ls)
    dx_ext = C._execute(
        "input_grad", policy.input_grad, d, False, ls.groups, dy.device,
        dy.dtype,
        lambda eng: eng.input_grad(dyb, C._weight_for(eng, wb, ls), d,
                                   ls.groups))
    if plan.cout:
        dx_ext = plan.mesh.psum(dx_ext, (plan.cout,))
    dx = _scatter_spatial(dx_ext, plan, blk_h, blk_w)
    return from_local(dx, _act_spec(plan, plan.cin), plan.mesh)


def _wgrad_regular(x, dy, w_shape, spec: ConvSpec, policy,
                   plan: ConvShardPlan):
    ls = _local_spec(spec, plan)
    w_loc = (w_shape[0] // plan.size(plan.cout),
             w_shape[1] // plan.size(plan.cin), w_shape[2], w_shape[3])
    xb = _block(x, _act_spec(plan, plan.cin), plan)
    dyb = _block(dy, _act_spec(plan, plan.cout), plan)
    x_ext = _gather_spatial(xb, plan)
    d = C.spec_dims(x_ext.shape, w_loc, ls)
    dw = C._execute(
        "weight_grad", policy.weight_grad, d, False, ls.groups, dy.device,
        dy.dtype, lambda eng: C._run_wgrad(x_ext, dyb, d, eng, ls))
    reduce_axes = _wgrad_axes(plan)
    if reduce_axes:
        dw = plan.mesh.psum(dw, reduce_axes)
    return from_local(dw, P(plan.cout, plan.cin, None, None), plan.mesh)


class _ShardedConv2d(torch.autograd.Function):
    """The sharded regular conv: global x, w in; global y out; the
    backward takes the global dy and returns the global dx and dw."""

    @staticmethod
    def forward(ctx, x, w, spec, policy, plan):
        ctx.save_for_backward(x, w)
        ctx.spec, ctx.policy, ctx.plan = spec, policy, plan
        return _fwd_regular(x, w, spec, policy, plan)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        spec, policy, plan = ctx.spec, ctx.policy, ctx.plan
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _dgrad_regular(dy, w, x.shape, spec, policy,
                                plan).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _wgrad_regular(x, dy, w.shape, spec, policy,
                                plan).to(w.dtype)
        return dx, dw, None, None, None


# ---------------------------------------------------------------------------
# Transposed conv: every pass is a role swap over the mirror dims; the
# mirror INPUT plane (= the transposed output) is the halo-exchanged one.
# ---------------------------------------------------------------------------

def _t_fwd(x, w, spec: ConvTransposeSpec, policy, plan: ConvShardPlan,
           y_hw: tuple[int, int]):
    tl = _local_tspec(spec, plan)
    blk_h, blk_w = (y_hw[0] // plan.size(plan.h),
                    y_hw[1] // plan.size(plan.w))
    xb = _block(x, _act_spec(plan, plan.cin), plan)
    wb = _block(w, P(plan.cin, plan.cout, None, None), plan)
    # Local zero-pad geometry: the mirror input plane IS the extended
    # block (blk + lo + hi rows); the scatter folds the seams.
    d = C.transpose_dims(xb.shape, wb.shape, tl)
    y_ext = C._execute(
        "forward", policy.forward, d, True, tl.groups, x.device, x.dtype,
        lambda eng: C._t_forward(xb, wb, d, eng, tl))
    if plan.cin:
        y_ext = plan.mesh.psum(y_ext, (plan.cin,))
    y = _scatter_spatial(y_ext, plan, blk_h, blk_w)
    return from_local(y, _act_spec(plan, plan.cout), plan.mesh)


def _t_dgrad(dy, w, x_shape, spec: ConvTransposeSpec, policy,
             plan: ConvShardPlan):
    tl = _local_tspec(spec, plan)
    x_loc = (x_shape[0] // plan.batch_cut,
             x_shape[1] // plan.size(plan.cin),
             x_shape[2] // plan.size(plan.h),
             x_shape[3] // plan.size(plan.w))
    dyb = _block(dy, _act_spec(plan, plan.cout), plan)
    wb = _block(w, P(plan.cin, plan.cout, None, None), plan)
    dy_ext = _gather_spatial(dyb, plan)
    d = C.transpose_dims(x_loc, wb.shape, tl)
    dx = C._execute(
        "input_grad", policy.input_grad, d, True, tl.groups, dy.device,
        dy.dtype,
        lambda eng: eng.forward(dy_ext, C._weight_for(eng, wb, tl), d,
                                tl.groups))
    if plan.cout:
        dx = plan.mesh.psum(dx, (plan.cout,))
    return from_local(dx, _act_spec(plan, plan.cin), plan.mesh)


def _t_wgrad(dy, x, x_shape, w_shape, spec: ConvTransposeSpec, policy,
             plan: ConvShardPlan):
    tl = _local_tspec(spec, plan)
    x_loc = (x_shape[0] // plan.batch_cut,
             x_shape[1] // plan.size(plan.cin),
             x_shape[2] // plan.size(plan.h),
             x_shape[3] // plan.size(plan.w))
    w_loc = (w_shape[0] // plan.size(plan.cin),
             w_shape[1] // plan.size(plan.cout), w_shape[2], w_shape[3])
    dyb = _block(dy, _act_spec(plan, plan.cout), plan)
    xb = _block(x, _act_spec(plan, plan.cin), plan)
    dy_ext = _gather_spatial(dyb, plan)
    d = C.transpose_dims(x_loc, w_loc, tl)
    dw = C._execute(
        "weight_grad", policy.weight_grad, d, True, tl.groups, dy.device,
        dy.dtype, lambda eng: C._run_wgrad(dy_ext, xb, d, eng, tl))
    reduce_axes = _wgrad_axes(plan)
    if reduce_axes:
        dw = plan.mesh.psum(dw, reduce_axes)
    return from_local(dw, P(plan.cin, plan.cout, None, None), plan.mesh)


class _ShardedConv2dTranspose(torch.autograd.Function):
    """The sharded transposed conv, global tensors in and out."""

    @staticmethod
    def forward(ctx, x, w, spec, policy, plan):
        ctx.save_for_backward(x, w)
        ctx.spec, ctx.policy, ctx.plan = spec, policy, plan
        y_hw = C.conv_transpose_output_shape(x.shape, w.shape, spec)[2:]
        return _t_fwd(x, w, spec, policy, plan, y_hw)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        spec, policy, plan = ctx.spec, ctx.policy, ctx.plan
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _t_dgrad(dy, w, x.shape, spec, policy, plan).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _t_wgrad(dy, x, x.shape, w.shape, spec, policy,
                          plan).to(w.dtype)
        return dx, dw, None, None, None


# ---------------------------------------------------------------------------
# The lowering hook: policy context + per-call plan + event recording
# ---------------------------------------------------------------------------

_STACK: list[tuple[object, object]] = []


def _record_plan(plan: ConvShardPlan, requested) -> None:
    suffix = "_T" if plan.transposed else ""
    for role, reason in plan.dropped:
        C._record_event(f"mesh:drop:{role}")
        if len(C.POLICY_DECISIONS) < C._MAX_DECISIONS:
            C.POLICY_DECISIONS.append({
                "pass": "mesh", "requested": str(requested),
                "engine": f"replicated:{role}", "reason": reason,
                "transpose": plan.transposed, "dims": ()})
    if plan.roles:
        C._record_event(f"mesh:conv2d{suffix}:{plan.tag}")
    else:
        C._record_event(f"mesh:fallback{suffix}")
        if len(C.POLICY_DECISIONS) < C._MAX_DECISIONS:
            C.POLICY_DECISIONS.append({
                "pass": "mesh", "requested": str(requested),
                "engine": "replicated",
                "reason": ("; ".join(r for _, r in plan.dropped)
                           or "no shardable role for this mesh"),
                "transpose": plan.transposed, "dims": ()})


def _maybe_lower(x, w, spec, policy):
    """``repro_torch.core.conv.MESH_LOWERING`` hook: the sharded result,
    or ``NotImplemented`` (the single-device conv proceeds)."""
    requested, mesh = _STACK[-1]
    if mesh is None:
        mesh = _active_mesh()
    if mesh is None:
        C._record_event("mesh:no_mesh")
        return NotImplemented
    blk = current_block()
    if blk is not None and blk.mesh is not mesh:
        raise RuntimeError(f"conv_mesh on {mesh!r} inside a step whose "
                           f"batch is cut over {blk.mesh!r}")
    par = ConvParallel.coerce(requested, mesh)
    plan = plan_conv_sharding(x.shape, w.shape, spec, par, mesh,
                              blk.axes if blk is not None else None)
    _record_plan(plan, requested)
    if not plan.roles:
        return NotImplemented
    if plan.transposed:
        return _ShardedConv2dTranspose.apply(x, w, spec, policy, plan)
    return _ShardedConv2d.apply(x, w, spec, policy, plan)


@contextlib.contextmanager
def conv_mesh(policy, mesh=None):
    """Scoped mesh-parallel conv lowering for every conv2d /
    conv2d_transpose called in the dynamic extent::

        with conv_parallel.conv_mesh("tp", mesh):  # or a ConvParallel
            loss = loss_fn(params, batch)          # convs run sharded
            grads = torch.autograd.grad(loss, leaves)

    ``policy`` is a :class:`ConvParallel`, a ``dist.sharding`` policy name
    (``"tp"`` / ``"dp_only"`` / ``"tp_rep"`` / ``"spatial"``), or None (a
    no-op, so call sites can thread an optional config through).  ``mesh``
    defaults to the enclosing ``with mesh:``.  A backward run inside the
    extent runs the sharded passes; a forward run inside it keeps its
    sharded backward wherever the backward runs.
    """
    if policy is None:
        yield None
        return
    if isinstance(policy, str) and policy not in POLICIES:
        raise ValueError(f"unknown conv mesh policy {policy!r}")
    _STACK.append((policy, mesh))
    C.MESH_LOWERING = _maybe_lower
    try:
        yield policy
    finally:
        _STACK.pop()
        if not _STACK:
            C.MESH_LOWERING = None
