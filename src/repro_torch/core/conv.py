"""Convolution with structured geometry and per-pass backprop engines.

PyTorch counterpart of ``repro.core.conv``.  The public surface is

    y = conv2d(x, w, ConvSpec.make(stride=2, padding=1),
               "fwd=pallas,dgrad=auto,wgrad=bp_phase")

where the ``EnginePolicy`` names the engine of each of the three lowered
GEMMs.  Registered engines (``ENGINES``):

  * ``"lax"``      -- the library conv and its grads (control / ground truth)
  * ``"bp_phase"`` -- stride-phase decomposition over compact tensors
  * ``"pallas"``   -- the hand-written CUDA tap-GEMM kernels
                      (``repro_torch.kernels``); the name is kept from the
                      JAX package so one policy string means the same
                      thing in both packages
  * ``"auto"``     -- not an engine: stride-1 undilated layers take
                      ``bp_phase`` (no zero-space to eliminate), strided or
                      dilated layers the tap-GEMM kernels whenever they can
                      launch, and every fallback records why.

Engines that cannot serve a geometry resolve down ``bp_phase -> lax``;
:func:`dispatch_events` counts the engine actually used per pass and
:func:`policy_decisions` keeps the reasons.  A kernel error propagates: there
is no runtime degradation in this package.

Every engine serves a grouped conv in one call (``groups`` argument), so
the kernel engine runs a depthwise layer as one launch per pass.  Dilation
is lowered per engine: engines with ``native_dilation`` (the kernels) take
the compact kernel and skip its zero taps; the others get the kernel
materialized at its effective extent and their weight grad is sliced back.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from repro_torch.core import im2col_ref, phase_decomp
from repro_torch.core.convspec import AUTO, ConvSpec, EnginePolicy
from repro_torch.core.im2col_ref import ConvDims


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
                    native_dilation: bool = False) -> Engine:
    """Register a conv engine under ``name`` for use in any policy.  Every
    engine serves asymmetric strides (``s_h != s_w``)."""
    if name == AUTO or not name:
        raise ValueError(f"invalid engine name {name!r}")
    if name in ENGINES:
        raise ValueError(f"engine {name!r} is already registered")
    eng = Engine(name, forward, input_grad, weight_grad,
                 paper_geometry=paper_geometry,
                 native_dilation=native_dilation)
    ENGINES[name] = eng
    return eng


register_engine("lax", im2col_ref.conv2d_lax, im2col_ref.conv2d_input_lax,
                im2col_ref.conv2d_weight_lax, paper_geometry=False)
register_engine("bp_phase", im2col_ref.conv2d_lax,
                phase_decomp.input_grad_phase,
                phase_decomp.weight_grad_phase)
# The hand-written CUDA tap-GEMM engine (repro_torch/csrc/tap_gemm.cu),
# registered under the JAX package's name for its Pallas counterpart.
register_engine("pallas", _kernel_forward, _kernel_input_grad,
                _kernel_weight_grad, native_dilation=True)


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


def _kernel_gap(pass_name: str, d: ConvDims) -> str | None:
    from repro_torch.kernels import ops
    return ops.launch_gap(pass_name, d)


_FALLBACK_CHAIN = ("bp_phase", "lax")


def _first_capable(d: ConvDims, reason: str) -> tuple[str, str]:
    for name in _FALLBACK_CHAIN:
        if name in ENGINES and _capability_gap(ENGINES[name], d) is None:
            return name, reason
    return "lax", reason


def resolve_engine(requested: str, pass_name: str,
                   d: ConvDims) -> tuple[str, str]:
    """One pass's selection: ``(engine actually used, reason)``."""
    if requested == AUTO:
        if d.s_h == 1 and d.s_w == 1 and not d.has_dilation:
            if _capability_gap(ENGINES["bp_phase"], d) is None:
                return "bp_phase", ("auto: stride 1 has no zero-space; "
                                    "phase decomposition degenerates to the "
                                    "native dense conv")
            return _first_capable(
                d, "auto: stride 1, geometry outside implicit constraints")
        gap = _capability_gap(ENGINES["pallas"], d) or \
            _kernel_gap(pass_name, d)
        if gap is None:
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
        gap = _kernel_gap(pass_name, d)
        if gap is not None:
            return _first_capable(d, f"pallas requested but {gap}")
    return requested, "requested"


def _dims_key(d: ConvDims) -> tuple:
    return (d.B, d.C, d.H_i, d.W_i, d.N, d.K_h, d.K_w, d.s_h, d.s_w)


def _dispatch(pass_name: str, requested: str, d: ConvDims) -> Engine:
    """Resolve one pass, record the event and the decision."""
    name, reason = resolve_engine(requested, pass_name, d)
    key = f"{pass_name}:{name}"
    DISPATCH_EVENTS[key] = DISPATCH_EVENTS.get(key, 0) + 1
    if len(POLICY_DECISIONS) < _MAX_DECISIONS:
        POLICY_DECISIONS.append({"pass": pass_name, "requested": requested,
                                 "engine": name, "reason": reason,
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
            dw = eng.weight_grad(x, dy, d, spec.groups)
            if not eng.native_dilation:
                dw = _undilate_dweight(dw, spec)
            dw = dw.to(w.dtype)
        return dx, dw, None, None


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
