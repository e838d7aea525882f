"""Convolution with structured geometry and per-pass backprop engines.

PyTorch counterpart of ``repro.core.conv``.  The public surface is

    y = conv2d(x, w, ConvSpec.make(stride=2, padding=1),
               "fwd=pallas,dgrad=auto,wgrad=bp_phase")

where the ``EnginePolicy`` names the engine of each of the three lowered
GEMMs.  Registered engines (``ENGINES``):

  * ``"lax"``         -- the library conv and its grads (control / ground
                         truth)
  * ``"traditional"`` -- explicit im2col with zero-space materialization
                         (the paper's baseline), every lowered GEMM on the
                         hand-written ``matmul`` kernel
  * ``"bp_im2col"``   -- the paper's implicit algorithm: Algorithms 1 and 2
                         gather from compact tensors, then ``matmul``
  * ``"bp_phase"``    -- stride-phase decomposition over compact tensors
  * ``"pallas"``      -- the hand-written CUDA tap-GEMM kernels
                         (``repro_torch.kernels``); the name is kept from
                         the JAX package so one policy string means the
                         same thing in both packages
  * ``"auto"``        -- not an engine: stride-1 undilated layers take
                         ``bp_phase`` (no zero-space to eliminate), strided
                         or dilated layers the tap-GEMM kernels whenever
                         they can launch, and every fallback records why.

Engines that cannot serve a geometry resolve down ``bp_phase -> lax``;
:func:`dispatch_events` counts the engine actually used per pass and
:func:`policy_decisions` keeps the reasons.  A kernel error propagates: there
is no runtime degradation in this package.

Every engine serves a grouped conv in one call (``groups`` argument), so
the kernel engine runs a depthwise layer as one launch per pass.  Dilation
is lowered per engine: engines with ``native_dilation`` (the kernels) take
the compact kernel and skip its zero taps; the others get the kernel
materialized at its effective extent and their weight grad is sliced back.

:func:`conv2d_transpose` runs a transposed conv through the same engines
as a role swap of its mirror regular conv (:func:`transpose_dims`):
engines with ``native_transpose`` run its forward on their input-grad
machinery (one ``tap_gemm_phased`` launch under ``pallas``), the others
physically zero-insert the input and run their stride-1 forward
(:func:`conv2d_transpose_materialized`, which under ``traditional`` is the
paper's baseline and under ``lax`` the oracle).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

import torch.nn.functional as F

from repro_torch.core import bpim2col, im2col_ref, phase_decomp
from repro_torch.core.convspec import (AUTO, ConvSpec, ConvTransposeSpec,
                                       EnginePolicy)
from repro_torch.core.im2col_ref import ConvDims, insert_zeros, rot180


# ---------------------------------------------------------------------------
# Engine registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Engine:
    """The three lowered GEMMs of one conv layer under one engine, plus the
    static capabilities the resolver gates on.  The callables take
    ``(x, w, d, groups)`` / ``(dy, w, d, groups)`` / ``(x, dy, d, groups)``
    with ``d`` the per-group :class:`ConvDims`."""
    name: str
    forward: Callable
    input_grad: Callable
    weight_grad: Callable
    paper_geometry: bool = True    # requires ConvDims.validate() to hold
    native_dilation: bool = False  # consumes the compact kernel
    native_transpose: bool = False  # serves a transposed-conv forward on
    #                                 its input_grad (zero insertion never
    #                                 built); False: the dispatcher
    #                                 zero-inserts the input and runs the
    #                                 engine's stride-1 forward


def _kernel_forward(x, w, d, groups):
    from repro_torch.kernels import ops
    return ops.conv2d_forward(x, w, d, groups)


def _kernel_input_grad(dy, w, d, groups):
    from repro_torch.kernels import ops
    return ops.conv2d_input_grad(dy, w, d, groups)


def _kernel_weight_grad(x, dy, d, groups):
    from repro_torch.kernels import ops
    return ops.conv2d_weight_grad(x, dy, d, groups)


ENGINES: dict[str, Engine] = {}


def register_engine(name: str, forward: Callable, input_grad: Callable,
                    weight_grad: Callable, *, paper_geometry: bool = True,
                    native_dilation: bool = False,
                    native_transpose: bool = False) -> Engine:
    """Register a conv engine under ``name`` for use in any policy.  Every
    engine serves asymmetric strides (``s_h != s_w``)."""
    if name == AUTO or not name:
        raise ValueError(f"invalid engine name {name!r}")
    if name in ENGINES:
        raise ValueError(f"engine {name!r} is already registered")
    eng = Engine(name, forward, input_grad, weight_grad,
                 paper_geometry=paper_geometry,
                 native_dilation=native_dilation,
                 native_transpose=native_transpose)
    ENGINES[name] = eng
    return eng


register_engine("lax", im2col_ref.conv2d_lax, im2col_ref.conv2d_input_lax,
                im2col_ref.conv2d_weight_lax, paper_geometry=False,
                native_transpose=True)
register_engine("traditional", im2col_ref.conv2d_forward_explicit,
                im2col_ref.input_grad_explicit,
                im2col_ref.weight_grad_explicit)
register_engine("bp_im2col", im2col_ref.conv2d_forward_explicit,
                bpim2col.input_grad_implicit, bpim2col.weight_grad_implicit,
                native_transpose=True)
register_engine("bp_phase", im2col_ref.conv2d_lax,
                phase_decomp.input_grad_phase,
                phase_decomp.weight_grad_phase, native_transpose=True)
# The hand-written CUDA tap-GEMM engine (repro_torch/csrc/tap_gemm.cu),
# registered under the JAX package's name for its Pallas counterpart.
register_engine("pallas", _kernel_forward, _kernel_input_grad,
                _kernel_weight_grad, native_dilation=True,
                native_transpose=True)


def _engine(name: str) -> Engine:
    try:
        return ENGINES[name]
    except KeyError:
        raise ValueError(
            f"unknown conv engine {name!r}; choose from "
            f"{tuple(ENGINES)} or 'auto'") from None


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

def spec_dims(x_shape, w_shape, spec: ConvSpec) -> ConvDims:
    """The per-group ``ConvDims`` a ``(x, w, spec)`` triple dispatches with
    (dilation folded into the effective kernel extent)."""
    b, c, h, w = x_shape
    n, cg, kh, kw = w_shape
    g = spec.groups
    if c != cg * g:
        raise ValueError(
            f"channel mismatch: input C={c}, weight C/g={cg}, groups={g}")
    if n % g:
        raise ValueError(f"N={n} not divisible by groups={g}")
    keff_h, keff_w = spec.effective_kernel(kh, kw)
    (ph_lo, ph_hi), (pw_lo, pw_hi) = spec.padding
    d = ConvDims(B=b, C=cg, H_i=h, W_i=w, N=n // g,
                 K_h=keff_h, K_w=keff_w,
                 S=spec.s_h, S_w=(-1 if spec.s_w == spec.s_h else spec.s_w),
                 P_h=ph_lo, P_w=pw_lo, P_h_hi=ph_hi, P_w_hi=pw_hi,
                 D_h=spec.d_h, D_w=spec.d_w)
    if d.H_o < 1 or d.W_o < 1:
        raise ValueError(
            f"conv output plane is empty ({d.H_o}x{d.W_o}): input "
            f"{h}x{w}, effective kernel {keff_h}x{keff_w} "
            f"(dilation {spec.dilation}), stride {spec.stride}, "
            f"padding {spec.padding}")
    return d


def make_dims(x_shape, w_shape, stride=1, padding=0, groups: int = 1,
              dilation=1) -> ConvDims:
    """Per-group ConvDims from loose geometry arguments."""
    return spec_dims(x_shape, w_shape,
                     ConvSpec.make(stride=stride, padding=padding,
                                   dilation=dilation, groups=groups))


def transpose_dims(x_shape, w_shape, spec: ConvTransposeSpec) -> ConvDims:
    """Per-group ``ConvDims`` of the MIRROR regular conv of a transposed
    layer.

    A transposed conv with stride ``s`` is the input gradient (the paper's
    transposed mode) of a regular conv whose output plane is the transposed
    layer's input: its dims carry the spec's stride, dilation and padding,
    its input plane is the transposed layer's OUTPUT, and
    ``output_padding`` is its tiling remainder ``R``.  Each pass of the
    transposed layer is a role swap of a mirror pass (forward -> mirror
    input grad, input grad -> mirror forward, weight grad -> mirror weight
    grad with input and output swapped).  Weights ``(C_in, C_out/g, K_h,
    K_w)`` are the mirror conv's OIHW weights as they are."""
    b, cin, h, w = x_shape
    cin2, cog, kh, kw = w_shape
    g = spec.groups
    if cin != cin2:
        raise ValueError(f"channel mismatch: input C={cin}, weight "
                         f"C_in={cin2}")
    if cin % g:
        raise ValueError(f"C_in={cin} not divisible by groups={g}")
    keff_h, keff_w = spec.effective_kernel(kh, kw)
    (ph_lo, ph_hi), (pw_lo, pw_hi) = spec.padding
    h_out, w_out = spec.output_shape(h, w, kh, kw)
    if h_out < 1 or w_out < 1:
        raise ValueError(
            f"transposed-conv output plane is empty ({h_out}x{w_out}): "
            f"input {h}x{w}, effective kernel {keff_h}x{keff_w} "
            f"(dilation {spec.dilation}), stride {spec.stride}, "
            f"padding {spec.padding}, output_padding {spec.output_padding}")
    d = ConvDims(B=b, C=cog, H_i=h_out, W_i=w_out, N=cin // g,
                 K_h=keff_h, K_w=keff_w,
                 S=spec.s_h, S_w=(-1 if spec.s_w == spec.s_h else spec.s_w),
                 P_h=ph_lo, P_w=pw_lo, P_h_hi=ph_hi, P_w_hi=pw_hi,
                 D_h=spec.d_h, D_w=spec.d_w)
    # The spec's 0 <= output_padding < stride makes the mirror conv
    # reproduce the input plane exactly, with output_padding as remainder.
    assert (d.H_o, d.W_o, d.R_h, d.R_w) == (h, w, spec.op_h, spec.op_w), \
        (d, x_shape, spec)
    return d


def conv_transpose_output_shape(x_shape, w_shape,
                                spec: ConvTransposeSpec) \
        -> tuple[int, int, int, int]:
    """The output shape of ``conv2d_transpose`` in the spec's layout:
    (B, C_out, H_out, W_out) for NCHW, (B, H_out, W_out, C_out) for NHWC."""
    b = x_shape[0]
    cout = w_shape[1] * spec.groups
    h, w = (x_shape[2], x_shape[3]) if spec.layout == "NCHW" \
        else (x_shape[1], x_shape[2])
    h_out, w_out = spec.output_shape(h, w, w_shape[2], w_shape[3])
    if spec.layout == "NHWC":
        return b, h_out, w_out, cout
    return b, cout, h_out, w_out


def transpose_tap_counts(d: ConvDims) -> dict[str, object]:
    """The zero-insertion accounting of one transposed-conv forward:
    ``real`` tap-GEMMs the fused phase plan runs across all ``s_h*s_w``
    output phases, against ``zero_inserted``, what a stride-1 dense conv
    over the zero-inserted input runs over the same phase grid
    (``s_h*s_w*K_eff_h*K_eff_w``)."""
    from repro_torch.kernels import ops
    real = sum(len(t) for t in ops.input_grad_plan(d).phase_taps)
    zero_inserted = d.s_h * d.s_w * d.K_h * d.K_w
    return {"real": real, "zero_inserted": zero_inserted,
            "skip_ratio": round(1.0 - real / zero_inserted, 3)}


def dilate_kernel(w: torch.Tensor, spec: ConvSpec) -> torch.Tensor:
    """The dilated kernel at its effective extent (zeros between taps), for
    engines WITHOUT native dilation."""
    if not spec.has_dilation:
        return w
    kh, kw = w.shape[-2:]
    keff_h, keff_w = spec.effective_kernel(kh, kw)
    out = w.new_zeros((*w.shape[:-2], keff_h, keff_w))
    out[..., ::spec.d_h, ::spec.d_w] = w
    return out


def _undilate_dweight(dw_eff: torch.Tensor, spec: ConvSpec) -> torch.Tensor:
    """Slice the real taps back out of the effective-kernel weight grad."""
    if not spec.has_dilation:
        return dw_eff
    return dw_eff[..., ::spec.d_h, ::spec.d_w]


def _weight_for(eng: Engine, w: torch.Tensor, spec: ConvSpec) -> torch.Tensor:
    return w if eng.native_dilation else dilate_kernel(w, spec)


# ---------------------------------------------------------------------------
# Policy resolution
# ---------------------------------------------------------------------------

#: (pass, engine actually used) counters, key "pass:engine".
DISPATCH_EVENTS: dict[str, int] = {}
#: per-decision log: requested engine, engine used, and why (bounded).
POLICY_DECISIONS: list[dict] = []
_MAX_DECISIONS = 512


def dispatch_events() -> dict[str, int]:
    """Counts of the engine ACTUALLY used per pass (``"input_grad:pallas"``
    -> n); every call counts (PyTorch runs eagerly)."""
    return dict(DISPATCH_EVENTS)


def policy_decisions() -> list[dict]:
    return list(POLICY_DECISIONS)


def reset_dispatch_events() -> None:
    DISPATCH_EVENTS.clear()
    POLICY_DECISIONS.clear()


def _capability_gap(e: Engine, d: ConvDims) -> str | None:
    """None when ``e`` can serve geometry ``d``, else the reason."""
    if e.paper_geometry:
        try:
            d.validate()
        except ValueError as err:
            return f"geometry outside the paper's constraints ({err})"
    return None


#: transposed-conv pass -> the MIRROR regular-conv pass it role-swaps onto.
_TRANSPOSE_ROLE = {"forward": "input_grad", "input_grad": "forward",
                   "weight_grad": "weight_grad"}


def _kernel_gap(pass_name: str, d: ConvDims,
                transposed: bool = False) -> str | None:
    from repro_torch.kernels import ops
    return ops.launch_gap(_TRANSPOSE_ROLE[pass_name] if transposed
                          else pass_name, d)


_FALLBACK_CHAIN = ("bp_phase", "lax")


def _first_capable(d: ConvDims, reason: str) -> tuple[str, str]:
    for name in _FALLBACK_CHAIN:
        if name in ENGINES and _capability_gap(ENGINES[name], d) is None:
            return name, reason
    return "lax", reason


def resolve_engine(requested: str, pass_name: str, d: ConvDims,
                   transposed: bool = False) -> tuple[str, str]:
    """One pass's selection: ``(engine actually used, reason)``.

    ``transposed=True`` resolves a pass of a TRANSPOSED conv over its
    mirror dims ``d`` (:func:`transpose_dims`): the kernel limits consulted
    are those of the role-swapped pass (the transposed forward runs the
    mirror input grad's ``tap_gemm_phased``)."""
    if requested == AUTO:
        if d.s_h == 1 and d.s_w == 1 and not d.has_dilation:
            if _capability_gap(ENGINES["bp_phase"], d) is None:
                return "bp_phase", ("auto: stride 1 has no zero-space; "
                                    "phase decomposition degenerates to the "
                                    "native dense conv")
            return _first_capable(
                d, "auto: stride 1, geometry outside implicit constraints")
        gap = _capability_gap(ENGINES["pallas"], d) or \
            _kernel_gap(pass_name, d, transposed)
        if gap is None:
            if transposed:
                return "pallas", ("auto: transposed conv is the tap-GEMM "
                                  "phase plan; zero insertion skipped and "
                                  "the kernel launches")
            if d.has_dilation:
                return "pallas", ("auto: tap table skips the dilation zero "
                                  "taps and the tap-GEMM kernel launches")
            return "pallas", "auto: tap-GEMM kernel launches"
        return _first_capable(d, f"auto: pallas unavailable ({gap})")
    e = _engine(requested)
    gap = _capability_gap(e, d)
    if gap is not None:
        return _first_capable(d, f"{requested} requested but {gap}")
    if requested == "pallas":
        gap = _kernel_gap(pass_name, d, transposed)
        if gap is not None:
            return _first_capable(d, f"pallas requested but {gap}")
    return requested, "requested"


def _dims_key(d: ConvDims) -> tuple:
    return (d.B, d.C, d.H_i, d.W_i, d.N, d.K_h, d.K_w, d.s_h, d.s_w)


def _dispatch(pass_name: str, requested: str, d: ConvDims,
              transposed: bool = False) -> Engine:
    """Resolve one pass, record the event and the decision.  A transposed
    conv's passes count under their own keys (``"forward_T:pallas"``)."""
    name, reason = resolve_engine(requested, pass_name, d, transposed)
    key = f"{pass_name}{'_T' if transposed else ''}:{name}"
    DISPATCH_EVENTS[key] = DISPATCH_EVENTS.get(key, 0) + 1
    if len(POLICY_DECISIONS) < _MAX_DECISIONS:
        POLICY_DECISIONS.append({"pass": pass_name, "requested": requested,
                                 "engine": name, "reason": reason,
                                 "transpose": transposed,
                                 "dims": _dims_key(d)})
    return ENGINES[name]


def _validate_policy(policy: EnginePolicy) -> EnginePolicy:
    for _, engine in policy.slots():
        if engine != AUTO:
            _engine(engine)           # raises on unknown names
    return policy


def resolve_policy(d: ConvDims, policy=None) -> dict[str, dict[str, str]]:
    """Pure per-pass resolution for one per-group geometry (no tensors, no
    event recording): ``{pass: {requested, engine, reason}}``."""
    p = _validate_policy(EnginePolicy.coerce(policy))
    out = {}
    for pass_name, requested in p.slots():
        engine, reason = resolve_engine(requested, pass_name, d)
        out[pass_name] = {"requested": requested, "engine": engine,
                          "reason": reason}
    return out


# ---------------------------------------------------------------------------
# Policy override context
# ---------------------------------------------------------------------------

#: the default: shape-dependent per-pass selection.
DEFAULT_POLICY = EnginePolicy()

_POLICY_OVERRIDE: list[EnginePolicy] = []


@contextlib.contextmanager
def conv_policy(policy):
    """Scoped policy override for EVERY conv2d in the dynamic extent; beats
    per-call policies."""
    p = _validate_policy(EnginePolicy.coerce(policy))
    _POLICY_OVERRIDE.append(p)
    try:
        yield p
    finally:
        _POLICY_OVERRIDE.pop()


def effective_policy(explicit=None) -> EnginePolicy:
    """Override stack > per-call policy > DEFAULT_POLICY (auto)."""
    if _POLICY_OVERRIDE:
        return _POLICY_OVERRIDE[-1]
    if explicit is not None:
        return EnginePolicy.coerce(explicit)
    return DEFAULT_POLICY


# ---------------------------------------------------------------------------
# The autograd function: forward and both grads through the policy's engines
# ---------------------------------------------------------------------------

class _Conv2d(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, spec: ConvSpec, policy: EnginePolicy):
        d = spec_dims(x.shape, w.shape, spec)
        eng = _dispatch("forward", policy.forward, d)
        ctx.save_for_backward(x, w)
        ctx.spec, ctx.policy = spec, policy
        return eng.forward(x, _weight_for(eng, w, spec), d, spec.groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        spec, policy = ctx.spec, ctx.policy
        d = spec_dims(x.shape, w.shape, spec)
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            eng = _dispatch("input_grad", policy.input_grad, d)
            dx = eng.input_grad(dy, _weight_for(eng, w, spec), d,
                                spec.groups).to(x.dtype)
        if ctx.needs_input_grad[1]:
            eng = _dispatch("weight_grad", policy.weight_grad, d)
            dw = _run_wgrad(x, dy, d, eng, spec).to(w.dtype)
        return dx, dw, None, None


def _run_wgrad(x, dy, d: ConvDims, eng: Engine, spec) -> torch.Tensor:
    """One engine's weight grad, un-dilated when the engine took the
    materialized kernel."""
    dw = eng.weight_grad(x, dy, d, spec.groups)
    return dw if eng.native_dilation else _undilate_dweight(dw, spec)


def conv2d(x: torch.Tensor, w: torch.Tensor, spec=None,
           policy=None) -> torch.Tensor:
    """NCHW x OIHW -> NCHW convolution with per-pass backprop engines.

    ``spec`` is a :class:`ConvSpec` (or a dict of ``ConvSpec.make`` kwargs,
    or None for a plain stride-1 conv); ``policy`` an :class:`EnginePolicy`,
    a policy string, a bare engine name, or None for ``auto``.  A
    surrounding :func:`conv_policy` overrides it.  The input grad is only
    computed when ``x`` requires it.  ``spec.layout == "NHWC"`` transposes
    activations at the boundary.
    """
    spec = ConvSpec.coerce(spec)
    policy = _validate_policy(effective_policy(policy))
    if spec.layout == "NHWC":
        y = _Conv2d.apply(x.permute(0, 3, 1, 2), w, spec.with_layout("NCHW"),
                          policy)
        return y.permute(0, 2, 3, 1)
    return _Conv2d.apply(x, w, spec, policy)


# ---------------------------------------------------------------------------
# Transposed convolution: the same engines through the mirror regular conv
# ---------------------------------------------------------------------------

def conv2d_transpose_materialized(x: torch.Tensor, w: torch.Tensor,
                                  spec: ConvTransposeSpec,
                                  engine: str = "lax") -> torch.Tensor:
    """The zero-insertion MATERIALIZATION of a transposed conv: build the
    zero-spaced input (``s - 1`` zeros between pixels, pad ``K_eff - 1 - p``
    per side, ``output_padding`` more rows/cols at the high side; a
    negative pad crops), rotate and swap the (zero-dilated) kernel, and run
    ``engine``'s ordinary stride-1 forward over it.

    Engines without ``native_transpose`` get this at dispatch (under
    ``traditional`` it is the paper's baseline: every zero is stored and
    multiplied); under ``lax`` it is the oracle.  Differentiable, so
    autograd through it anchors the transposed backward too."""
    eng = _engine(engine)
    cin, g, cog = x.shape[1], spec.groups, w.shape[1]
    w_eff = dilate_kernel(w, spec)           # (C_in, C_out/g, Keff, Keff)
    keff_h, keff_w = w_eff.shape[-2:]
    (ph_lo, ph_hi), (pw_lo, pw_hi) = spec.padding
    x_zi = F.pad(insert_zeros(x, (spec.s_h, spec.s_w)),
                 (keff_w - 1 - pw_lo, keff_w - 1 - pw_hi + spec.op_w,
                  keff_h - 1 - ph_lo, keff_h - 1 - ph_hi + spec.op_h))
    # Mirror OIHW weight of the stride-1 dense conv: rot180 + in/out swap.
    wt = (rot180(w_eff).reshape(g, cin // g, cog, keff_h, keff_w)
          .transpose(1, 2).reshape(g * cog, cin // g, keff_h, keff_w))
    d1 = materialized_dims(x.shape, w.shape, spec)
    return eng.forward(x_zi, wt, d1, g)


def materialized_dims(x_shape, w_shape, spec: ConvTransposeSpec) -> ConvDims:
    """Per-group ``ConvDims`` of the stride-1 dense conv that
    :func:`conv2d_transpose_materialized` runs over the zero-inserted,
    padded input (NCHW ``x_shape``, weights ``(C_in, C_out/g, K_h, K_w)``)."""
    b, cin, h, w = x_shape
    keff_h, keff_w = spec.effective_kernel(w_shape[2], w_shape[3])
    (ph_lo, ph_hi), (pw_lo, pw_hi) = spec.padding
    h_zi = (h - 1) * spec.s_h + 1 + 2 * (keff_h - 1) - ph_lo - ph_hi \
        + spec.op_h
    w_zi = (w - 1) * spec.s_w + 1 + 2 * (keff_w - 1) - pw_lo - pw_hi \
        + spec.op_w
    return ConvDims(B=b, C=cin // spec.groups, H_i=h_zi, W_i=w_zi,
                    N=w_shape[1], K_h=keff_h, K_w=keff_w, S=1)


class _Conv2dTranspose(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, spec: ConvTransposeSpec, policy: EnginePolicy):
        d = transpose_dims(x.shape, w.shape, spec)
        eng = _dispatch("forward", policy.forward, d, True)
        ctx.save_for_backward(x, w)
        ctx.spec, ctx.policy = spec, policy
        if not eng.native_transpose:
            return conv2d_transpose_materialized(x, w, spec, eng.name)
        return eng.input_grad(x, _weight_for(eng, w, spec), d, spec.groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        spec, policy = ctx.spec, ctx.policy
        d = transpose_dims(x.shape, w.shape, spec)
        dy = dy.contiguous()
        dx = dw = None
        # dX is the mirror STRIDED conv of dy; dW the mirror weight grad
        # with the input and output roles swapped.
        if ctx.needs_input_grad[0]:
            eng = _dispatch("input_grad", policy.input_grad, d, True)
            dx = eng.forward(dy, _weight_for(eng, w, spec), d,
                             spec.groups).to(x.dtype)
        if ctx.needs_input_grad[1]:
            eng = _dispatch("weight_grad", policy.weight_grad, d, True)
            dw = _run_wgrad(dy, x, d, eng, spec).to(w.dtype)
        return dx, dw, None, None


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor, spec=None,
                     policy=None) -> torch.Tensor:
    """NCHW x (C_in, C_out/g, K_h, K_w) -> NCHW TRANSPOSED convolution.

    ``spec`` is a :class:`ConvTransposeSpec` (or a dict of its ``make``
    kwargs, or None); ``policy`` selects the engine per pass as for
    :func:`conv2d`, and a surrounding :func:`conv_policy` overrides it.
    Under ``pallas`` the forward is ONE ``tap_gemm_phased`` launch over all
    ``s_h*s_w`` output phases (the zero-inserted input is never built), dX
    one ``tap_gemm`` and dW one ``tap_wgrad``; under ``traditional`` the
    forward zero-inserts the input and runs the explicit GEMM on
    ``matmul``.  ``spec.layout == "NHWC"`` transposes activations at the
    boundary."""
    spec = ConvTransposeSpec.coerce(spec)
    policy = _validate_policy(effective_policy(policy))
    if spec.layout == "NHWC":
        y = _Conv2dTranspose.apply(x.permute(0, 3, 1, 2), w,
                                   spec.with_layout("NCHW"), policy)
        return y.permute(0, 2, 3, 1)
    return _Conv2dTranspose.apply(x, w, spec, policy)
