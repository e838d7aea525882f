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
:func:`policy_decisions` keeps the reasons.

The same ladder runs at EXECUTION time (:func:`_execute`, as in the JAX
package): a pass whose engine RAISES is re-run down the chain instead of
killing the step.  On the card only an injected fault
(``ft.inject.InjectedFault``, e.g. at a ``pallas.*.launch`` site) is
absorbed so: a kernel that fails to build, or a launch the wrapper
refuses, propagates unchanged, so no slower engine ever serves a pass
under the kernel's name.  Off the card any exception is absorbed, as in
the JAX package.  The failure edge is recorded (``"pass:failed->survivor"`` in
:func:`dispatch_events`, the exception class in :func:`runtime_failures`),
the failing engine is quarantined for that (pass, geometry) and probed
after :data:`QUARANTINE_PROBE_AFTER` dispatches, and a crashing ``pallas``
pass poison-marks its plan-cache entry (``autotune.poison_plan``) so
``autotune="cached"`` does not serve it again.  ``lax`` is terminal: never
quarantined, and when every engine fails the first exception propagates.
Only what raises at the call is caught: a device-side fault surfaces at a
later synchronization, outside the pass, and is not degraded.

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
import warnings
from typing import Callable

import torch

import torch.nn.functional as F

from repro_torch.core import bpim2col, im2col_ref, phase_decomp
from repro_torch.core.convspec import (AUTO, ConvSpec, ConvTransposeSpec,
                                       EnginePolicy)
from repro_torch.core.im2col_ref import ConvDims, insert_zeros, rot180
from repro_torch.ft import inject
from repro_torch.obs import events as obs_events
from repro_torch.obs import trace as obs_trace


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
    RUNTIME_FAILURES.clear()
    _QUARANTINE.clear()
    # Keep the bus-backed view (obs.events.counters("dispatch")) in lockstep
    # with the legacy dict under every reset pattern (no-op when off).
    obs_events.drop("dispatch")


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


def _kernel_gap(pass_name: str, d: ConvDims, transposed: bool = False,
                groups: int = 1, device=None,
                dtype=torch.float32) -> str | None:
    """Why the kernel of this pass cannot launch, or None.  On a CUDA
    ``device`` the pass is judged by the plan that will launch for
    operands of ``dtype`` (``ops.pass_plan``: the tuned plan when
    ``config.autotune`` is on); a transposed pass plans under its mirror
    role."""
    from repro_torch.kernels import ops
    role = _TRANSPOSE_ROLE[pass_name] if transposed else pass_name
    plan = None if device is None else ops.pass_plan(role, d, groups,
                                                     device, dtype)
    return ops.launch_gap(role, d, groups, plan, dtype)


_FALLBACK_CHAIN = ("bp_phase", "lax")


def _first_capable(d: ConvDims, reason: str) -> tuple[str, str]:
    for name in _FALLBACK_CHAIN:
        if name in ENGINES and _capability_gap(ENGINES[name], d) is None:
            return name, reason
    return "lax", reason


def resolve_engine(requested: str, pass_name: str, d: ConvDims,
                   transposed: bool = False, groups: int = 1,
                   device=None, dtype=torch.float32) -> tuple[str, str]:
    """One pass's selection: ``(engine actually used, reason)``.

    ``transposed=True`` resolves a pass of a TRANSPOSED conv over its
    mirror dims ``d`` (:func:`transpose_dims`): the kernel limits consulted
    are those of the role-swapped pass (the transposed forward runs the
    mirror input grad's ``tap_gemm_phased``).  With a CUDA ``device`` they
    are those of the plan the kernel of ``groups`` groups launches with
    there for operands of ``dtype`` (:func:`_kernel_gap`); without one,
    those every plan shares."""
    if requested == AUTO:
        if d.s_h == 1 and d.s_w == 1 and not d.has_dilation:
            if _capability_gap(ENGINES["bp_phase"], d) is None:
                return "bp_phase", ("auto: stride 1 has no zero-space; "
                                    "phase decomposition degenerates to the "
                                    "native dense conv")
            return _first_capable(
                d, "auto: stride 1, geometry outside implicit constraints")
        gap = _capability_gap(ENGINES["pallas"], d) or \
            _kernel_gap(pass_name, d, transposed, groups, device, dtype)
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
        gap = _kernel_gap(pass_name, d, transposed, groups, device, dtype)
        if gap is not None:
            return _first_capable(d, f"pallas requested but {gap}")
    return requested, "requested"


# ---------------------------------------------------------------------------
# Runtime degradation: execute with fallback, quarantine, probes
# ---------------------------------------------------------------------------

#: structured log of runtime engine failures (bounded like the decisions).
RUNTIME_FAILURES: list[dict] = []

#: a quarantined (pass, engine, geometry) is skipped for this many
#: dispatches, then probed for recovery (the port dispatches every call,
#: so one dispatch is one call of the pass).
QUARANTINE_PROBE_AFTER = 3

#: (pass_key, engine, _dims_key(d)) -> dispatches skipped since the
#: quarantine began.  The key is the JAX package's: no operand type, no
#: group count.
_QUARANTINE: dict[tuple, int] = {}


def runtime_failures() -> list[dict]:
    """Every runtime engine failure absorbed by the degradation layer:
    pass, engine, exception class, the survivor that served the pass, and
    the geometry.  Reset by :func:`reset_dispatch_events`."""
    return list(RUNTIME_FAILURES)


def quarantined_engines() -> list[dict]:
    """The quarantined (pass, engine, geometry) entries and how many
    dispatches each has been skipped for."""
    return [{"pass": k[0], "engine": k[1], "dims": k[2], "skips": v}
            for k, v in sorted(_QUARANTINE.items(),
                               key=lambda kv: (kv[0][0], kv[0][1]))]


def clear_quarantine() -> None:
    _QUARANTINE.clear()


def _record_event(key: str) -> None:
    DISPATCH_EVENTS[key] = DISPATCH_EVENTS.get(key, 0) + 1
    obs_events.emit("dispatch", key)


def _dims_key(d: ConvDims) -> tuple:
    return (d.B, d.C, d.H_i, d.W_i, d.N, d.K_h, d.K_w, d.s_h, d.s_w)


def _fallbacks(name: str, d: ConvDims) -> list[str]:
    """The capable engines below ``name`` on the ``bp_phase -> lax``
    ladder, ``lax`` always last (the JAX package's runtime chain after
    ``name``).  Worked out only once ``name`` is passed over, so a pass
    that does not fail pays for none of it."""
    chain = [cand for cand in _FALLBACK_CHAIN
             if cand != name and cand in ENGINES
             and _capability_gap(ENGINES[cand], d) is None]
    if "lax" not in chain and name != "lax":
        chain.append("lax")
    return chain


def _poison_plan_entry(pass_name: str, transposed: bool, d: ConvDims,
                       groups: int, device, dtype) -> None:
    """Poison-mark the plan-cache entry of a crashing kernel pass (best
    effort: poisoning must never mask the degradation itself).  Nothing
    under ``autotune="off"`` or off the card, where no plan is cached."""
    from repro_torch.core.config import config
    if config.autotune == "off" or torch.device(device).type != "cuda":
        return
    role = _TRANSPOSE_ROLE[pass_name] if transposed else pass_name
    try:
        from repro_torch.kernels import autotune
        autotune.poison_plan(role, d, groups, device, dtype)
    except Exception:
        pass


def _record_pass(pass_name: str, pkey: str, requested: str, engine: str,
                 reason: str, transposed: bool, d: ConvDims, dkey) -> None:
    """The dispatch event and the policy decision of a pass ``engine``
    served."""
    _record_event(f"{pkey}:{engine}")
    if len(POLICY_DECISIONS) < _MAX_DECISIONS:
        POLICY_DECISIONS.append({
            "pass": pass_name, "requested": requested, "engine": engine,
            "reason": reason, "transpose": transposed,
            "dims": _dims_key(d) if dkey is None else dkey})


def _execute(pass_name: str, requested: str, d: ConvDims, transposed: bool,
             groups: int, device, dtype, run: Callable):
    """Resolve one pass on ``device`` for operands of ``dtype`` and run it
    with runtime degradation.

    ``run(engine)`` performs the pass under one :class:`Engine` (the
    weight it takes, compact or dilated, is derived per engine inside
    it).  An exception that :func:`inject.absorbs` (on the card only an
    injected fault; any other propagates at once, recording nothing)
    re-runs the pass down :func:`_fallbacks` (:func:`_ladder`).  Without
    a failure the pass records what it always did: one dispatch event and
    one policy decision.  With nothing quarantined and no trace to record,
    the resolved engine runs bare and only a failure enters the ladder,
    whose loop and span would cost each pass microseconds of host time.
    A transposed conv's passes count under their own keys
    (``"forward_T:pallas"``)."""
    name, reason = resolve_engine(requested, pass_name, d, transposed,
                                  groups, device, dtype)
    pkey = f"{pass_name}_T" if transposed else pass_name
    failed = None
    if not _QUARANTINE and not obs_trace.active():
        try:
            out = run(ENGINES[name])
        except Exception as e:
            if not inject.absorbs(e, device):
                raise
            failed = e
        else:
            _record_pass(pass_name, pkey, requested, name, reason,
                         transposed, d, None)
            return out
    return _ladder(pass_name, pkey, requested, name, reason, d, transposed,
                   groups, device, dtype, run, failed)


def _ladder(pass_name: str, pkey: str, requested: str, name: str,
            reason: str, d: ConvDims, transposed: bool, groups: int, device,
            dtype, run: Callable, failed: Exception | None):
    """``name`` then :func:`_fallbacks` until one engine serves the pass
    (``failed``: what ``name`` already raised in :func:`_execute`; it is
    not run again).  A failure is recorded (``"pass:failed->survivor"``
    in :func:`dispatch_events`, the exception class in
    :func:`runtime_failures`), the failing engine is quarantined for this
    (pass, geometry) -- later dispatches skip it for
    :data:`QUARANTINE_PROBE_AFTER` rounds, then probe it once; a probe
    that succeeds lifts the quarantine (``"pass:engine:recovered"``), one
    that fails re-arms it -- and a crashing ``pallas`` pass poison-marks
    its plan-cache entry.  ``lax`` is terminal: never quarantined, and
    when every engine fails the first exception propagates.  Each engine
    run is a ``dispatch_span``."""
    dkey = _dims_key(d)
    first_exc = None
    failures: list[dict] = []
    chain = [name]
    for cand in chain:              # grows by _fallbacks once name is passed
        probing = skip = False
        qkey = (pkey, cand, dkey)
        if qkey in _QUARANTINE and cand != "lax":
            _QUARANTINE[qkey] += 1
            skip = _QUARANTINE[qkey] <= QUARANTINE_PROBE_AFTER
            probing = not skip
            _record_event(f"{pkey}:{cand}:"
                          + ("quarantined" if skip else "probe"))
        if not skip:
            err, failed = failed, None
            if err is None:
                try:
                    with obs_trace.dispatch_span(pkey, cand, d):
                        out = run(ENGINES[cand])
                except Exception as e:
                    if not inject.absorbs(e, device):
                        raise
                    err = e
            if err is None:
                if probing:
                    del _QUARANTINE[qkey]
                    _record_event(f"{pkey}:{cand}:recovered")
                for fail in failures:
                    fail["survivor"] = cand
                    _record_event(f"{pkey}:{fail['engine']}->{cand}")
                    reason = (f"runtime degradation: {fail['engine']} raised "
                              f"{fail['exception']}; quarantined, {cand} "
                              f"survives")
                _record_pass(pass_name, pkey, requested, cand, reason,
                             transposed, d, dkey)
                return out
            if first_exc is None:
                first_exc = err
            if cand != "lax":
                _QUARANTINE[qkey] = 0
            fail = {"pass": pkey, "engine": cand,
                    "exception": type(err).__name__, "error": str(err)[:200],
                    "survivor": None, "probe": probing, "dims": dkey}
            failures.append(fail)
            if len(RUNTIME_FAILURES) < _MAX_DECISIONS:
                RUNTIME_FAILURES.append(fail)
            if cand == "pallas":
                _poison_plan_entry(pass_name, transposed, d, groups, device,
                                   dtype)
        if len(chain) == 1:
            chain += _fallbacks(name, d)
    raise first_exc            # lax is never skipped: it ran and raised


def _validate_policy(policy: EnginePolicy) -> EnginePolicy:
    for _, engine in policy.slots():
        if engine != AUTO:
            _engine(engine)           # raises on unknown names
    return policy


def resolve_policy(d: ConvDims, policy=None, transposed: bool = False,
                   groups: int = 1,
                   device=None) -> dict[str, dict[str, str]]:
    """Pure per-pass resolution for one per-group geometry (no tensors, no
    event recording): ``{pass: {requested, engine, reason}}``.
    ``transposed=True`` resolves over the mirror dims of a transposed
    conv; ``groups`` and ``device`` as for :func:`resolve_engine`."""
    p = _validate_policy(EnginePolicy.coerce(policy))
    out = {}
    for pass_name, requested in p.slots():
        engine, reason = resolve_engine(requested, pass_name, d, transposed,
                                        groups, device)
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
        ctx.save_for_backward(x, w)
        ctx.spec, ctx.policy = spec, policy
        return _execute(
            "forward", policy.forward, d, False, spec.groups, x.device,
            x.dtype,
            lambda eng: eng.forward(x, _weight_for(eng, w, spec), d,
                                    spec.groups))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        spec, policy = ctx.spec, ctx.policy
        d = spec_dims(x.shape, w.shape, spec)
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _execute(
                "input_grad", policy.input_grad, d, False, spec.groups,
                dy.device, dy.dtype,
                lambda eng: eng.input_grad(dy, _weight_for(eng, w, spec), d,
                                           spec.groups)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _execute(
                "weight_grad", policy.weight_grad, d, False, spec.groups,
                dy.device, dy.dtype,
                lambda eng: _run_wgrad(x, dy, d, eng, spec)).to(w.dtype)
        return dx, dw, None, None


def _run_wgrad(x, dy, d: ConvDims, eng: Engine, spec) -> torch.Tensor:
    """One engine's weight grad, un-dilated when the engine took the
    materialized kernel: the whole engine-dependent pipeline, since a
    survivor may differ from the failed engine in ``native_dilation``."""
    dw = eng.weight_grad(x, dy, d, spec.groups)
    return dw if eng.native_dilation else _undilate_dweight(dw, spec)


_LEGACY_POSITIONAL = ("stride", "padding", "mode", "groups")


def _is_spec(value, cls) -> bool:
    """A spec in the spec slot: the spec itself, a dict of its ``make``
    kwargs, or None for the default geometry."""
    return value is None or isinstance(value, (cls, dict))


def _deprecated_mode(mode) -> EnginePolicy:
    warnings.warn(
        "conv2d(..., mode=...) is deprecated; pass policy='<engine>' "
        "(uniform) or an EnginePolicy (per-pass) instead",
        DeprecationWarning, stacklevel=4)
    return EnginePolicy.uniform(mode)


def _canon_call(args: tuple, kw: dict) -> tuple[ConvSpec, EnginePolicy | None]:
    """Interpret both call surfaces (``repro.core.conv._canon_call``):

    new:    conv2d(x, w, spec: ConvSpec, policy=...)  (or geometry kwargs)
    legacy: conv2d(x, w, stride, padding, mode, groups)  (mode deprecated)
    """
    spec = kw.pop("spec", None)
    policy = kw.pop("policy", None)
    mode = kw.pop("mode", None)
    geom = {k: kw.pop(k) for k in ("stride", "padding", "dilation", "groups",
                                   "layout") if k in kw}
    if kw:
        raise TypeError(f"conv2d got unexpected kwargs {sorted(kw)}")
    args = list(args)
    if args and _is_spec(args[0], ConvSpec):
        if spec is not None:
            raise TypeError("ConvSpec given both positionally and as spec=")
        spec = args.pop(0)
        if args:
            if policy is not None:
                raise TypeError("policy given twice")
            policy = args.pop(0)
        if args:
            raise TypeError("too many positional arguments after ConvSpec")
    elif args and isinstance(args[0], (str, EnginePolicy)):
        # conv2d(x, w, "pallas"): a leading policy with default or kwarg
        # geometry (a legacy stride is numeric, so this is unambiguous).
        if policy is not None:
            raise TypeError("policy given twice")
        policy = args.pop(0)
        if args:
            raise TypeError("too many positional arguments after policy")
    elif args:
        # Legacy positional (stride, padding, mode, groups).
        if len(args) > len(_LEGACY_POSITIONAL):
            raise TypeError("too many positional arguments")
        for name, val in zip(_LEGACY_POSITIONAL, args):
            if name == "mode":
                if mode is not None:
                    raise TypeError("mode given twice")
                mode = val
            else:
                if name in geom:
                    raise TypeError(f"{name} given twice")
                geom[name] = val
    if mode is not None:
        if policy is not None:
            raise TypeError("pass either policy= or the deprecated mode=, "
                            "not both")
        policy = _deprecated_mode(mode)
    if spec is None:
        spec = ConvSpec.make(**geom)
    elif geom:
        raise TypeError(
            f"geometry given both in the ConvSpec and as kwargs "
            f"{sorted(geom)}; put it all in the spec")
    return ConvSpec.coerce(spec), policy


def conv2d(x: torch.Tensor, w: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """NCHW x OIHW -> NCHW convolution with per-pass backprop engines.

    New surface: ``conv2d(x, w, spec, policy)``: ``spec`` a
    :class:`ConvSpec` (or a dict of ``ConvSpec.make`` kwargs, or None for a
    plain stride-1 conv), or the geometry kwargs ``stride= padding=
    dilation= groups= layout=``, which build it; ``policy`` an
    :class:`EnginePolicy`, a policy string, a bare engine name, or None for
    ``auto`` (also positional in the spec's place).  The legacy surface
    ``conv2d(x, w, stride, padding, mode, groups)`` still works; ``mode=``
    emits a ``DeprecationWarning``.  A surrounding :func:`conv_policy`
    overrides the policy.  The input grad is only computed when ``x``
    requires it.  ``spec.layout == "NHWC"`` transposes activations at the
    boundary.
    """
    spec, policy = _canon_call(args, kwargs)
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


def _t_forward(x, w, d: ConvDims, eng: Engine, spec: ConvTransposeSpec):
    """A transposed forward under one engine: the mirror input grad when
    the engine is transpose-native (zero space never built), else the
    zero-insertion materialization."""
    if not eng.native_transpose:
        return conv2d_transpose_materialized(x, w, spec, eng.name)
    return eng.input_grad(x, _weight_for(eng, w, spec), d, spec.groups)


class _Conv2dTranspose(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, spec: ConvTransposeSpec, policy: EnginePolicy):
        d = transpose_dims(x.shape, w.shape, spec)
        ctx.save_for_backward(x, w)
        ctx.spec, ctx.policy = spec, policy
        return _execute("forward", policy.forward, d, True, spec.groups,
                        x.device, x.dtype,
                        lambda eng: _t_forward(x, w, d, eng, spec))

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
            dx = _execute(
                "input_grad", policy.input_grad, d, True, spec.groups,
                dy.device, dy.dtype,
                lambda eng: eng.forward(dy, _weight_for(eng, w, spec), d,
                                        spec.groups)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _execute(
                "weight_grad", policy.weight_grad, d, True, spec.groups,
                dy.device, dy.dtype,
                lambda eng: _run_wgrad(dy, x, d, eng, spec)).to(w.dtype)
        return dx, dw, None, None


def _canon_transpose_call(args: tuple, kw: dict) \
        -> tuple[ConvTransposeSpec, EnginePolicy | None]:
    """conv2d_transpose(x, w, spec | policy, policy=..., <geometry kwargs>)
    -- the structured surface only (this API postdates ``mode=``)."""
    spec = kw.pop("spec", None)
    policy = kw.pop("policy", None)
    geom = {k: kw.pop(k) for k in ("stride", "padding", "output_padding",
                                   "dilation", "groups", "layout")
            if k in kw}
    if kw:
        raise TypeError(
            f"conv2d_transpose got unexpected kwargs {sorted(kw)}")
    args = list(args)
    if args and _is_spec(args[0], ConvTransposeSpec):
        if spec is not None:
            raise TypeError(
                "ConvTransposeSpec given both positionally and as spec=")
        spec = args.pop(0)
    if args:
        if policy is not None:
            raise TypeError("policy given twice")
        if not isinstance(args[0], (str, EnginePolicy)):
            raise TypeError(
                "expected a policy (str | EnginePolicy) after the spec, "
                f"got {args[0]!r}")
        policy = args.pop(0)
    if args:
        raise TypeError("too many positional arguments")
    if spec is None:
        spec = ConvTransposeSpec.make(**geom)
    elif geom:
        raise TypeError(
            f"geometry given both in the ConvTransposeSpec and as kwargs "
            f"{sorted(geom)}; put it all in the spec")
    return ConvTransposeSpec.coerce(spec), policy


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor, *args,
                     **kwargs) -> torch.Tensor:
    """NCHW x (C_in, C_out/g, K_h, K_w) -> NCHW TRANSPOSED convolution.

    ``conv2d_transpose(x, w, spec, policy)``: ``spec`` a
    :class:`ConvTransposeSpec` (or a dict of its ``make`` kwargs, or None),
    or the geometry kwargs ``stride= padding= output_padding= dilation=
    groups= layout=``, which build it; ``policy`` (also positional in the
    spec's place) selects the engine per pass as for
    :func:`conv2d`, and a surrounding :func:`conv_policy` overrides it.
    Under ``pallas`` the forward is ONE ``tap_gemm_phased`` launch over all
    ``s_h*s_w`` output phases (the zero-inserted input is never built), dX
    one ``tap_gemm`` and dW one ``tap_wgrad``; under ``traditional`` the
    forward zero-inserts the input and runs the explicit GEMM on
    ``matmul``.  ``spec.layout == "NHWC"`` transposes activations at the
    boundary."""
    spec, policy = _canon_transpose_call(args, kwargs)
    policy = _validate_policy(effective_policy(policy))
    if spec.layout == "NHWC":
        y = _Conv2dTranspose.apply(x.permute(0, 3, 1, 2), w,
                                   spec.with_layout("NCHW"), policy)
        return y.permute(0, 2, 3, 1)
    return _Conv2dTranspose.apply(x, w, spec, policy)


# ---------------------------------------------------------------------------
# 1-D and depthwise wrappers (Mamba2's temporal conv)
# ---------------------------------------------------------------------------

def _merge_policy(policy, mode):
    if mode is not None:
        if policy is not None:
            raise TypeError("pass either policy= or the deprecated mode=, "
                            "not both")
        return _deprecated_mode(mode)
    return policy


def conv1d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding=0,
           policy=None, groups: int = 1, dilation: int = 1, *,
           mode=None) -> torch.Tensor:
    """(B, C, L) x (N, C/g, K) -> (B, N, L_o) through the 2-D engines.

    padding: int (symmetric) or (lo, hi) along the temporal dim.  The
    stride and dilation apply on the degenerate (H = 1) axis too, where one
    row has no stride phases or dilation gaps."""
    policy = _merge_policy(policy, mode)
    if isinstance(padding, int):
        padding = (padding, padding)
    spec = ConvSpec.make(stride=stride, padding=((0, 0), tuple(padding)),
                         dilation=dilation, groups=groups)
    y = conv2d(x[:, :, None, :], w[:, :, None, :], spec, policy)
    return y[:, :, 0, :]


def conv1d_causal(x: torch.Tensor, w: torch.Tensor, policy=None,
                  groups: int = 1, *, mode=None) -> torch.Tensor:
    """Causal (left pad K - 1) stride-1 conv1d: (B, C, L) -> (B, N, L)."""
    k = w.shape[-1]
    return conv1d(x, w, 1, (k - 1, 0), _merge_policy(policy, mode), groups)


def depthwise_causal_conv1d(x: torch.Tensor, w: torch.Tensor, policy=None,
                            *, mode=None) -> torch.Tensor:
    """Causal depthwise conv of Mamba2: x (B, L, C), w (K, C) -> (B, L, C).

    Lowered as a grouped (groups == C) causal conv1d through
    :func:`conv2d`, so under ``pallas`` each pass is one launch of its tap
    kernel (C groups of one channel, K taps on an H = 1 plane).  When
    every pass of the effective policy resolves inside {lax, bp_phase,
    auto}, the layer is one library grouped conv (``F.conv1d(groups=C)``)
    as in the JAX package, whose stride-1 phase decomposition and auto rule
    degenerate to exactly that conv."""
    c = x.shape[-1]
    k = w.shape[0]
    p = effective_policy(_merge_policy(policy, mode))
    if {p.forward, p.input_grad, p.weight_grad} <= {"lax", "bp_phase", AUTO}:
        y = F.conv1d(F.pad(x.transpose(1, 2), (k - 1, 0)),
                     w.T[:, None, :], groups=c)
        return y.transpose(1, 2)
    y = conv1d_causal(x.transpose(1, 2), w.T[:, None, :], p, groups=c)
    return y.transpose(1, 2)


# ---------------------------------------------------------------------------
# Static introspection: what WOULD dispatch, and why
# ---------------------------------------------------------------------------

def output_shape(d: ConvDims) -> tuple[int, int, int, int]:
    return (d.B, d.N, d.H_o, d.W_o)


def policy_report(x_shape, w_shape, spec=None, policy=None,
                  device=None) -> dict:
    """Static dispatch summary for one conv layer under one policy: the
    per-pass engines the resolver would pick (with reasons) and each
    pass's kernel plan on ``device`` (``ops.plan_report``: variant,
    splits and, when tuned, the tuner's record; no plan without a device
    or on the CPU).

    ``spec`` may be a :class:`ConvTransposeSpec` (then ``w_shape`` is the
    transposed ``(C_in, C_out/g, K_h, K_w)`` convention): the report plans
    the MIRROR regular conv the transposed layer role-swaps onto, flags
    ``"transpose": True``, and adds the zero-insertion tap accounting
    (``taps.real`` vs ``taps.zero_inserted``)."""
    from repro_torch.kernels import ops
    if isinstance(spec, ConvTransposeSpec):
        d = transpose_dims(x_shape, w_shape, spec)
        report = {"passes": resolve_policy(d, policy, True, spec.groups,
                                           device),
                  "spec": str(spec), "transpose": True,
                  "plan": ops.plan_report(d, spec.groups, device),
                  "taps": transpose_tap_counts(d)}
    else:
        spec = ConvSpec.coerce(spec)
        d = spec_dims(x_shape, w_shape, spec)
        report = {"passes": resolve_policy(d, policy, False, spec.groups,
                                           device),
                  "spec": str(spec), "transpose": False,
                  "plan": ops.plan_report(d, spec.groups, device)}
    report["pallas_path"] = all(
        v["engine"] == "pallas" for v in report["passes"].values())
    return report


def conv_plan_report(x_shape, w_shape, stride=1, padding=0, groups: int = 1,
                     *, dilation=1, device=None) -> dict[str, object]:
    """``ops.plan_report`` of one conv layer given its array shapes instead
    of a ``ConvDims``: the taps, whether each kernel launches, and each
    pass's plan on ``device``.  Pure introspection, no tensors touched
    (the tuner may time candidates when ``config.autotune`` is on)."""
    from repro_torch.kernels import ops
    d = make_dims(x_shape, w_shape, stride, padding, groups, dilation)
    return ops.plan_report(d, groups, device)
