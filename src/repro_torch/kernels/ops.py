"""The kernel engine: tap tables, phase split, and the three conv passes.

Counterpart of ``repro.kernels.ops``.  Responsibilities:

  * layout prep (NCHW -> channels-last, padding, phase splitting) on
    COMPACT data, with the group dim kept in front so a grouped or
    depthwise conv is one kernel launch per pass;
  * static tap tables -- the BP-im2col address mapping resolved per
    stride phase, per axis (asymmetric strides) and dilation-native (only
    the ``k_taps_h * k_taps_w`` real taps are enumerated).  They equal the
    JAX planner's tables exactly;
  * each pass's launch plan (:func:`pass_plan`: the kernel's tile variant
    and split-K count, analytic or measured by ``kernels/autotune.py``
    when ``config.autotune`` asks for it);
  * calling the kernels of ``repro_torch.kernels.tap_gemm``.

The TPU planner's VMEM tile search has no counterpart: the CUDA kernels use
fixed tiles and stage no halo, so every geometry launches within the
card's limits (:func:`launch_gap` says when one would not); what a plan
chooses is the variant and the split count.  Channels are not padded to
128: ragged channel edges are masked inside the kernels.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.core import phase_decomp
from repro_torch.core.config import config
from repro_torch.core.im2col_ref import ConvDims, zero_pad
from repro_torch.ft.inject import fault_point
from repro_torch.kernels import tap_gemm as tg
from repro_torch.obs import events as obs_events

_cdiv = tg._cdiv

#: the three tap-kernel roles the plans (and the tuner) speak.
PLAN_ROLES = ("forward", "weight_grad", "input_grad")

#: the tuner's outcomes, ``{role}_autotune_{hit,miss,stale,poisoned,
#: measure_failed}`` -> count (``kernels/autotune.py``).
PLAN_EVENTS: dict[str, int] = {}


def _count_event(name: str) -> None:
    PLAN_EVENTS[name] = PLAN_EVENTS.get(name, 0) + 1
    obs_events.emit("plan", name)


def plan_events() -> dict[str, int]:
    return dict(PLAN_EVENTS)


def reset_plan_events() -> None:
    PLAN_EVENTS.clear()
    # Keep the bus-backed view in lockstep with the legacy dict (no-op off).
    obs_events.drop("plan")


def _taps_halo(taps) -> tuple[int, int]:
    if not taps:
        return 0, 0
    return max(t[-2] for t in taps), max(t[-1] for t in taps)


def _canonical(d: ConvDims) -> ConvDims:
    """Resolve the P_*_hi = -1 'symmetric' sentinel to explicit high-side
    pads and normalize the S_w sentinel, so geometrically identical layers
    share one cache entry."""
    sw = -1 if d.s_w == d.S else d.s_w
    if d.P_h_hi == d.p_h_hi and d.P_w_hi == d.p_w_hi and d.S_w == sw:
        return d
    return dataclasses.replace(d, P_h_hi=d.p_h_hi, P_w_hi=d.p_w_hi, S_w=sw)


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------

def _group_nhwc(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, G*C, H, W) -> contiguous channels-last (G, B, H, W, C)."""
    b, gc, h, w = x.shape
    return (x.reshape(b, groups, gc // groups, h, w).permute(1, 0, 3, 4, 2)
            .contiguous())


def _ungroup_nchw(y: torch.Tensor) -> torch.Tensor:
    """(G, B, H, W, C) -> (B, G*C, H, W)."""
    g, b, h, w, c = y.shape
    return y.permute(1, 0, 4, 2, 3).reshape(b, g * c, h, w)


def _phase_split(xp: torch.Tensor, s: tuple[int, int]) -> torch.Tensor:
    """(..., B, Hp, Wp, C) -> (..., s_h*s_w, B, ceil(Hp/s_h), ceil(Wp/s_w), C)
    phase planes; plane index = (h % s_h) * s_w + (w % s_w)."""
    s_h, s_w = s
    *lead, b, hp, wp, c = xp.shape
    hq, wq = _cdiv(hp, s_h), _cdiv(wp, s_w)
    xp = F.pad(xp, (0, 0, 0, wq * s_w - wp, 0, hq * s_h - hp))
    xp = xp.reshape(*lead, b, hq, s_h, wq, s_w, c)
    n = len(lead)
    perm = (*range(n), n + 2, n + 4, n, n + 1, n + 3, n + 5)
    return xp.permute(perm).reshape(*lead, s_h * s_w, b, hq, wq, c)


def _phase_unsplit(planes: torch.Tensor, s: tuple[int, int], h: int,
                   w: int) -> torch.Tensor:
    """(..., s_h*s_w, B, Hq, Wq, C) -> (..., B, h, w, C): the exact inverse
    of :func:`_phase_split` -- a reshape/permute/crop, no scatter."""
    s_h, s_w = s
    *lead, s2, b, hq, wq, c = planes.shape
    if s2 != s_h * s_w:
        raise ValueError(f"{s2} planes for stride {s}")
    n = len(lead)
    x = planes.reshape(*lead, s_h, s_w, b, hq, wq, c)
    perm = (*range(n), n + 2, n + 3, n, n + 4, n + 1, n + 5)
    return x.permute(perm).reshape(*lead, b, hq * s_h, wq * s_w, c)[
        ..., :h, :w, :]


# ---------------------------------------------------------------------------
# Tap tables
# ---------------------------------------------------------------------------

def _forward_taps(d: ConvDims) -> tuple[tuple[int, int, int], ...]:
    """Real kernel tap (kh, kw) -> (phase plane, du, dv) over the split
    input; only effective positions holding a real tap (multiples of
    D_h/D_w) are enumerated, in compact-kernel order."""
    return tuple(((kh % d.s_h) * d.s_w + (kw % d.s_w),
                  kh // d.s_h, kw // d.s_w)
                 for kh in range(0, d.K_h, d.D_h)
                 for kw in range(0, d.K_w, d.D_w))


@functools.lru_cache(maxsize=4096)
def _input_grad_geom(d: ConvDims):
    """The fused-phase input-grad geometry: (n_qh, n_qw, g_lo_h, g_lo_w,
    t_max, phase_specs, phase_taps, halo_h, halo_w) -- the JAX planner's
    tuple without its TPU channel padding.

    Each axis runs its own ``phase_geometry`` under its own stride; a
    kernel dilation drops the phase taps that land on a zero row/col of
    the dilated kernel.  Per-phase offsets are pre-shifted to a uniform
    base, so every phase reads one dY padded by ``g_lo`` on the low side;
    phases with no taps (or no outputs) are inactive: spec ``None``, no
    taps, zeros."""
    s_h, s_w = d.s_h, d.s_w
    a_h, a_w = d.K_h - 1 - d.P_h, d.K_w - 1 - d.P_w
    n_qh, n_qw = _cdiv(d.H_i, s_h), _cdiv(d.W_i, s_w)
    geo_h = [phase_decomp.phase_geometry(r, a_h, s_h, d.K_h, d.H_i, d.H_o)
             for r in range(s_h)]
    geo_w = [phase_decomp.phase_geometry(r, a_w, s_w, d.K_w, d.W_i, d.W_o)
             for r in range(s_w)]
    # Per-axis (source offset m, compact-kernel index) lists, zero taps
    # dropped: effective position c + m*s of the rotated kernel is real iff
    # divisible by D, and its compact index is (c + m*s) // D.
    taps_h = [tuple((m, (geo_h[r][0] + m * s_h) // d.D_h)
                    for m in range(geo_h[r][1])
                    if (geo_h[r][0] + m * s_h) % d.D_h == 0)
              for r in range(s_h)]
    taps_w = [tuple((m, (geo_w[r][0] + m * s_w) // d.D_w)
                    for m in range(geo_w[r][1])
                    if (geo_w[r][0] + m * s_w) % d.D_w == 0)
              for r in range(s_w)]
    active = {(r_h, r_w) for r_h in range(s_h) for r_w in range(s_w)
              if r_h < d.H_i and r_w < d.W_i
              and taps_h[r_h] and taps_w[r_w]}
    if active:
        min_off_h = min(geo_h[r][2] for r, _ in active)
        min_off_w = min(geo_w[c][2] for _, c in active)
    else:                                  # dI identically zero
        min_off_h = min_off_w = 0
    base_h, g_lo_h = max(0, min_off_h), max(0, -min_off_h)
    base_w, g_lo_w = max(0, min_off_w), max(0, -min_off_w)

    specs, taps_all, t_max = [], [], 1
    halo_h = halo_w = 0
    for r_h in range(s_h):
        off_h = geo_h[r_h][2]
        for r_w in range(s_w):
            off_w = geo_w[r_w][2]
            if (r_h, r_w) not in active:
                specs.append(None)
                taps_all.append(())
                continue
            sh = base_h + (off_h - min_off_h)
            sw = base_w + (off_w - min_off_w)
            th_, tw_ = taps_h[r_h], taps_w[r_w]
            taps_all.append(tuple(
                (ih * len(tw_) + iw, sh + mh, sw + mw)
                for ih, (mh, _) in enumerate(th_)
                for iw, (mw, _) in enumerate(tw_)))
            specs.append((tuple(kh for _, kh in th_),
                          tuple(kw for _, kw in tw_)))
            t_max = max(t_max, len(th_) * len(tw_))
            halo_h = max(halo_h, sh + th_[-1][0])
            halo_w = max(halo_w, sw + tw_[-1][0])
    return (n_qh, n_qw, g_lo_h, g_lo_w, t_max, tuple(specs),
            tuple(taps_all), halo_h, halo_w)


@dataclasses.dataclass(frozen=True)
class PhasePlan:
    """Fused input-grad launch: uniform geometry for ALL s_h*s_w output
    stride phases, realized as ONE ``tap_gemm_phased`` launch."""
    n_qh: int            # uniform per-phase output rows = ceil(H_i / s_h)
    n_qw: int
    g_lo_h: int          # global low-side dY padding (covers min offset)
    g_lo_w: int
    t_max: int           # widest per-phase tap table (stack padded to this)
    phase_specs: tuple   # per plane r_h*s_w+r_w: (row idxs, col idxs) into
                         # rot180(compact kernel), or None (phase gets zero)
    phase_taps: tuple    # per plane: tuple[(j, du, dv), ...]
    halo_h: int
    halo_w: int


def input_grad_plan(d: ConvDims) -> PhasePlan:
    return PhasePlan(*_input_grad_geom(_canonical(d)))


def launch_gap(pass_name: str, d: ConvDims, groups: int = 1,
               plan: tg.Plan | None = None,
               dtype=torch.float32) -> str | None:
    """None when the kernel of ``pass_name`` can launch for the per-group
    geometry ``d``, else the reason (recorded by the engine resolver).
    With a ``plan`` (:func:`pass_plan`), whether that plan can launch for
    ``groups`` groups on operands of ``dtype``
    (:func:`repro_torch.kernels.tap_gemm.plan_gap`); without one, the
    limits every plan shares."""
    if plan is not None:
        return tg.plan_gap(problem(pass_name, d, groups, dtype), plan)
    if pass_name == "input_grad":
        m = d.B * _cdiv(d.H_i, d.s_h) * _cdiv(d.W_i, d.s_w)
        return tg.launch_gap(m, d.C, d.s_h * d.s_w)
    return tg.launch_gap(d.B * d.H_o * d.W_o, d.N, 1)


# ---------------------------------------------------------------------------
# Launch plans: analytic, or measured (kernels/autotune.py)
# ---------------------------------------------------------------------------

def _check_role(role: str) -> None:
    if role not in PLAN_ROLES:
        raise ValueError(f"unknown plan role {role!r}; roles: {PLAN_ROLES}")


def _dtype_key(dtype) -> str:
    """The operand type's key in a :class:`~repro_torch.kernels.tap_gemm.
    Problem` (``"f32"`` or ``"bf16"``); raises on a type no kernel takes."""
    if dtype not in tg.DTYPES:
        raise TypeError(f"no tap kernel takes {dtype}; they take "
                        f"{' or '.join(map(str, tg.DTYPES))}")
    return tg.DTYPES[dtype]


@functools.lru_cache(maxsize=4096)
def _problem(role: str, d: ConvDims, groups: int,
             dtype: str = "f32") -> tg.Problem:
    if role == "input_grad":
        pp = input_grad_plan(d)
        return tg.Problem(role, groups,
                          tuple(len(t) for t in pp.phase_taps), d.N, d.C,
                          d.B * pp.n_qh * pp.n_qw, pp.n_qw, dtype)
    return tg.Problem(role, groups, (len(_forward_taps(d)),), d.C, d.N,
                      d.B * d.H_o * d.W_o, d.W_o, dtype)


def problem(role: str, d: ConvDims, groups: int = 1,
            dtype=torch.float32) -> tg.Problem:
    """What the plan of pass ``role`` depends on, for ``groups`` groups of
    the per-group geometry ``d`` with operands of ``dtype`` (the input
    grad's ``cin`` is dY's N channels, its ``cout`` dX's C)."""
    _check_role(role)
    return _problem(role, _canonical(d), groups, _dtype_key(dtype))


@functools.lru_cache(maxsize=4096)
def _analytic(role: str, d: ConvDims, groups: int, sms: int, dtype: str):
    prob = _problem(role, d, groups, dtype)
    plan = tg.analytic_plan(prob, sms)
    return plan, tg.plan_gap(prob, plan)


def pass_plan(role: str, d: ConvDims, groups: int, device,
              dtype=torch.float32) -> tg.Plan | None:
    """The plan the kernel of pass ``role`` launches with on ``device`` for
    operands of ``dtype``: the analytic plan, or with ``config.autotune``
    on, the tuner's (``kernels/autotune.py``: measured, served from the
    plan cache, or the analytic plan annotated; keyed by ``dtype`` too).
    A plan that cannot launch is never tuned.  None on a CPU device: the
    plain versions have no plan."""
    _check_role(role)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    d = _canonical(d)
    plan, gap = _analytic(role, d, groups, tg._sms(device),
                          _dtype_key(dtype))
    if config.autotune == "off" or gap is not None:
        return plan
    from repro_torch.kernels import autotune
    return autotune.tuned_plan(role, d, groups, device, plan, dtype)


def plan_cache_info():
    """The analytic plan memo's ``cache_info()`` (hits prove that a
    geometry's plan is worked out once; the metrics stream's
    ``plan_cache_hit_rate``)."""
    return _analytic.cache_info()


def plan_candidates(role: str, d: ConvDims, groups: int = 1,
                    k: int | None = None, device="cuda",
                    dtype=torch.float32) -> list[tg.Plan]:
    """The tuner's shortlist on ``device``'s card for operands of
    ``dtype``: up to ``k`` (``config.autotune_top_k``) valid plans, the
    analytic plan first
    (:func:`repro_torch.kernels.tap_gemm.candidate_plans`)."""
    _check_role(role)
    k = config.autotune_top_k if k is None else k
    prob = _problem(role, _canonical(d), groups, _dtype_key(dtype))
    return tg.candidate_plans(prob, tg._sms(torch.device(device)))[:k]


def plan_from_entry(role: str, d: ConvDims, groups: int, entry,
                    dtype=torch.float32) -> tg.Plan | None:
    """The plan of a PERSISTED ``[variant, splits]`` entry, revalidated
    against the current geometry, operand type and kernels; None when it
    is garbage or no longer launches (a stale plan-cache entry: the caller
    re-tunes)."""
    _check_role(role)
    try:
        variant, splits = entry
    except (TypeError, ValueError):
        return None
    if not isinstance(variant, str) or not isinstance(splits, int) \
            or isinstance(splits, bool):
        return None
    plan = tg.Plan(role, variant, splits)
    gap = tg.plan_gap(_problem(role, _canonical(d), groups,
                               _dtype_key(dtype)), plan)
    return plan if gap is None else None


def plan_report(d: ConvDims, groups: int = 1,
                device=None) -> dict[str, object]:
    """Static per-shape dispatch summary.  ``kernel_taps``: ``real`` taps
    the kernels run vs ``materialized`` (the zero-dilated extent).  Each
    pass carries the ``variant`` and ``splits`` of its plan on ``device``
    (:func:`pass_plan`; None without a device or on the CPU, whose plain
    versions have no plan) and, when the plan went through the tuner, an
    ``autotune`` record: ``autotuned``, ``measured_us``,
    ``candidates_timed``, ``cache`` (``hit|miss|stale|poisoned``)."""
    d = _canonical(d)
    taps = _forward_taps(d)
    pp = input_grad_plan(d)
    plans = {r: None if device is None else pass_plan(r, d, groups, device)
             for r in PLAN_ROLES}
    gaps = {r: launch_gap(r, d, groups, plans[r]) for r in PLAN_ROLES}

    def _plan(role: str) -> dict[str, object]:
        p = plans[role]
        t = {"fits": gaps[role] is None,
             "variant": None if p is None else p.variant,
             "splits": None if p is None else p.splits}
        if p is not None and p.cache:      # the plan went through the tuner
            t["autotune"] = {"autotuned": p.autotuned,
                             "measured_us": p.measured_us,
                             "candidates_timed": p.candidates_timed,
                             "cache": p.cache}
        return t

    return {
        "phases": d.s_h * d.s_w,
        "kernel_taps": {"real": d.k_taps_h * d.k_taps_w,
                        "materialized": d.K_h * d.K_w},
        "forward": {"taps": len(taps), "halo": list(_taps_halo(taps)),
                    **_plan("forward")},
        "weight_grad": {"taps": len(taps), "halo": list(_taps_halo(taps)),
                        **_plan("weight_grad")},
        "input_grad": {"fused": True, "t_max": pp.t_max,
                       "taps_total": sum(len(t) for t in pp.phase_taps),
                       "halo": [pp.halo_h, pp.halo_w],
                       **_plan("input_grad")},
        "pallas_path": all(g is None for g in gaps.values()),
    }


# ---------------------------------------------------------------------------
# Kernel operands (shared by the passes and by chip_smoke.py)
# ---------------------------------------------------------------------------

def _split_source(x: torch.Tensor, d: ConvDims, groups: int) -> torch.Tensor:
    """(B, G*C, H, W) -> padded, phase-split (G, s_h*s_w, B, Hq, Wq, C)."""
    xp = zero_pad(x, d.P_h, d.P_w, d.p_h_hi, d.p_w_hi)
    return _phase_split(_group_nhwc(xp, groups), (d.s_h, d.s_w)).contiguous()


def forward_operands(x, w, d: ConvDims, groups: int = 1):
    """``(src, wt, taps)`` of :func:`repro_torch.kernels.tap_gemm.tap_gemm`
    for a forward conv; ``w`` is the COMPACT kernel ``(G*N, C, kh, kw)``."""
    kh, kw = d.k_taps_h, d.k_taps_w
    wt = (w.reshape(groups, d.N, d.C, kh, kw).permute(0, 3, 4, 2, 1)
          .reshape(groups, kh * kw, d.C, d.N).contiguous())
    return _split_source(x, d, groups), wt, _forward_taps(_canonical(d))


@functools.lru_cache(maxsize=1024)
def _stack_index(d: ConvDims, device: torch.device):
    """Where each weight-stack slot of the input grad comes from:
    ``(slots, kh, kw, empty)`` as int64 tensors on ``device``.  Slot
    ``p * t_max + t`` (tap t of active phase p) holds the compact kernel's
    tap ``(kh, kw)`` (``rot180`` folded into the indices); the slots in
    ``empty`` (taps past a phase's count, phases without taps) are zero."""
    pp = input_grad_plan(d)
    kh_n, kw_n = d.k_taps_h, d.k_taps_w
    full, kh, kw = [], [], []
    for p, spec in enumerate(pp.phase_specs):
        if spec is None:
            continue
        rows, cols = spec
        for i, r in enumerate(rows):
            for j, c in enumerate(cols):
                full.append(p * pp.t_max + i * len(cols) + j)
                kh.append(kh_n - 1 - r)
                kw.append(kw_n - 1 - c)
    taken = set(full)
    empty = [k for k in range(len(pp.phase_specs) * pp.t_max)
             if k not in taken]
    return tuple(torch.tensor(v, dtype=torch.int64, device=device)
                 for v in (full, kh, kw, empty))


def input_grad_operands(dy, w, d: ConvDims, groups: int = 1):
    """``(src, w_stack, plan)`` of ``tap_gemm_phased`` for an input grad:
    the ``(G, PH, t_max, N, C)`` per-phase weight stacks gathered out of
    ``rot180(w)`` (an inactive phase's slots and those past a phase's taps
    are zero), written once into one tensor, and dY padded by ``g_lo`` on
    the low side."""
    pp = input_grad_plan(d)
    full, kh, kw, empty = _stack_index(_canonical(d), w.device)
    ph = len(pp.phase_specs)
    w_stack = w.new_empty((groups, ph, pp.t_max, d.N, d.C))
    slots = w_stack.view(groups, ph * pp.t_max, d.N, d.C)
    if len(empty):
        slots.index_fill_(1, empty, 0)
    if len(full):
        wk = w.reshape(groups, d.N, d.C, d.k_taps_h, d.k_taps_w)
        slots.index_copy_(1, full, wk[:, :, :, kh, kw].permute(0, 3, 1, 2))
    src = F.pad(_group_nhwc(dy, groups),
                (0, 0, pp.g_lo_w, 0, pp.g_lo_h, 0)).contiguous()
    return src, w_stack, pp


def weight_grad_operands(x, dy, d: ConvDims, groups: int = 1):
    """``(src, dy_nhwc, taps)`` of ``tap_wgrad`` for a weight grad."""
    return (_split_source(x, d, groups), _group_nhwc(dy, groups),
            _forward_taps(_canonical(d)))


# ---------------------------------------------------------------------------
# The three passes of the kernel engine
# ---------------------------------------------------------------------------

def conv2d_forward(x, w, d: ConvDims, groups: int = 1,
                   plan: tg.Plan | None = None) -> torch.Tensor:
    """Forward conv through ``tap_gemm``.  ``w`` is the COMPACT kernel
    (``k_taps_h x k_taps_w``); a dilation's zero taps are skipped by the
    tap table.  ``plan`` defaults to :func:`pass_plan`'s.  The
    ``pallas.forward.launch`` fault site comes first: a faulted pass
    launches nothing (and on CPU tensors runs no plain version)."""
    fault_point("pallas.forward.launch")
    if plan is None:
        plan = pass_plan("forward", d, groups, x.device, x.dtype)
    src, wt, taps = forward_operands(x, w, d, groups)
    y = tg.tap_gemm(src, wt, taps, d.H_o, d.W_o, plan)  # (G, B, Ho, Wo, N)
    return _ungroup_nchw(y).to(x.dtype)


def conv2d_input_grad(dy, w, d: ConvDims, groups: int = 1,
                      plan: tg.Plan | None = None) -> torch.Tensor:
    """Input grad through ONE ``tap_gemm_phased`` launch over all phases;
    ``plan`` defaults to :func:`pass_plan`'s; the
    ``pallas.input_grad.launch`` fault site comes first."""
    fault_point("pallas.input_grad.launch")
    if plan is None:
        plan = pass_plan("input_grad", d, groups, dy.device, dy.dtype)
    src, w_stack, pp = input_grad_operands(dy, w, d, groups)
    out = tg.tap_gemm_phased(src, w_stack, pp.phase_taps, pp.n_qh, pp.n_qw,
                             plan)
    di = _phase_unsplit(out, (d.s_h, d.s_w), d.H_i, d.W_i)  # (G, B, H, W, C)
    return _ungroup_nchw(di).to(dy.dtype)


def conv2d_weight_grad(x, dy, d: ConvDims, groups: int = 1,
                       plan: tg.Plan | None = None) -> torch.Tensor:
    """Weight grad through ``tap_wgrad``, at the compact kernel extent;
    ``plan`` defaults to :func:`pass_plan`'s; the
    ``pallas.weight_grad.launch`` fault site comes first."""
    fault_point("pallas.weight_grad.launch")
    if plan is None:
        plan = pass_plan("weight_grad", d, groups, x.device, x.dtype)
    src, dyn, taps = weight_grad_operands(x, dy, d, groups)
    dw = tg.tap_wgrad(src, dyn, taps, d.H_o, d.W_o, plan)  # (G, T, C, N)
    dw = dw.reshape(groups, d.k_taps_h, d.k_taps_w, d.C, d.N)
    return (dw.permute(0, 4, 3, 1, 2)
            .reshape(groups * d.N, d.C, d.k_taps_h, d.k_taps_w).to(x.dtype))
