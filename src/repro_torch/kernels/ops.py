"""The kernel engine: tap tables, phase split, and the three conv passes.

Counterpart of ``repro.kernels.ops``.  Responsibilities:

  * layout prep (NCHW -> channels-last, padding, phase splitting) on
    COMPACT data, with the group dim kept in front so a grouped or
    depthwise conv is one kernel launch per pass;
  * static tap tables -- the BP-im2col address mapping resolved per
    stride phase, per axis (asymmetric strides) and dilation-native (only
    the ``k_taps_h * k_taps_w`` real taps are enumerated).  They equal the
    JAX planner's tables exactly;
  * calling the kernels of ``repro_torch.kernels.tap_gemm``.

The TPU planner's VMEM tile search has no counterpart: the CUDA kernels use
fixed tiles and stage no halo, so every geometry launches within the
card's limits (:func:`launch_gap` says when one would not).  Channels are
not padded to 128: ragged channel edges are masked inside the kernels.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.core import phase_decomp
from repro_torch.core.im2col_ref import ConvDims, rot180, zero_pad
from repro_torch.kernels import tap_gemm as tg

_cdiv = tg._cdiv


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


def launch_gap(pass_name: str, d: ConvDims) -> str | None:
    """None when the kernel of ``pass_name`` can launch for the per-group
    geometry ``d``, else the reason (recorded by the engine resolver)."""
    if pass_name == "input_grad":
        m = d.B * _cdiv(d.H_i, d.s_h) * _cdiv(d.W_i, d.s_w)
        return tg.launch_gap(m, d.C, d.s_h * d.s_w)
    return tg.launch_gap(d.B * d.H_o * d.W_o, d.N, 1)


def plan_report(d: ConvDims) -> dict[str, object]:
    """Static per-shape dispatch summary.  ``kernel_taps``: ``real`` taps
    the kernels run vs ``materialized`` (the zero-dilated extent)."""
    d = _canonical(d)
    taps = _forward_taps(d)
    pp = input_grad_plan(d)
    gaps = {p: launch_gap(p, d) for p in ("forward", "input_grad",
                                          "weight_grad")}
    return {
        "phases": d.s_h * d.s_w,
        "kernel_taps": {"real": d.k_taps_h * d.k_taps_w,
                        "materialized": d.K_h * d.K_w},
        "forward": {"taps": len(taps), "halo": list(_taps_halo(taps)),
                    "fits": gaps["forward"] is None},
        "weight_grad": {"taps": len(taps), "halo": list(_taps_halo(taps)),
                        "fits": gaps["weight_grad"] is None},
        "input_grad": {"fused": True, "t_max": pp.t_max,
                       "taps_total": sum(len(t) for t in pp.phase_taps),
                       "halo": [pp.halo_h, pp.halo_w],
                       "fits": gaps["input_grad"] is None},
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


def input_grad_operands(dy, w, d: ConvDims, groups: int = 1):
    """``(src, w_stack, plan)`` of ``tap_gemm_phased`` for an input grad:
    the per-phase weight stacks gathered out of ``rot180(w)`` (zero-padded
    to ``t_max``; an inactive phase gets zeros) and dY padded by ``g_lo``
    on the low side."""
    pp = input_grad_plan(d)
    wf = rot180(w).reshape(groups, d.N, d.C, d.k_taps_h, d.k_taps_w)
    blocks = []
    for spec in pp.phase_specs:
        if spec is None:
            blocks.append(wf.new_zeros((groups, pp.t_max, d.N, d.C)))
            continue
        rows, cols = spec
        wk = wf[:, :, :, list(rows)][:, :, :, :, list(cols)]
        wk = wk.permute(0, 3, 4, 1, 2).reshape(groups, len(rows) * len(cols),
                                               d.N, d.C)
        blocks.append(F.pad(wk, (0, 0, 0, 0, 0, pp.t_max - wk.shape[1])))
    w_stack = torch.stack(blocks, dim=1).contiguous()   # (G, PH, T, N, C)
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

def conv2d_forward(x, w, d: ConvDims, groups: int = 1) -> torch.Tensor:
    """Forward conv through ``tap_gemm``.  ``w`` is the COMPACT kernel
    (``k_taps_h x k_taps_w``); a dilation's zero taps are skipped by the
    tap table."""
    src, wt, taps = forward_operands(x, w, d, groups)
    y = tg.tap_gemm(src, wt, taps, d.H_o, d.W_o)         # (G, B, Ho, Wo, N)
    return _ungroup_nchw(y).to(x.dtype)


def conv2d_input_grad(dy, w, d: ConvDims, groups: int = 1) -> torch.Tensor:
    """Input grad through ONE ``tap_gemm_phased`` launch over all phases."""
    src, w_stack, pp = input_grad_operands(dy, w, d, groups)
    out = tg.tap_gemm_phased(src, w_stack, pp.phase_taps, pp.n_qh, pp.n_qw)
    di = _phase_unsplit(out, (d.s_h, d.s_w), d.H_i, d.W_i)  # (G, B, H, W, C)
    return _ungroup_nchw(di).to(dy.dtype)


def conv2d_weight_grad(x, dy, d: ConvDims, groups: int = 1) -> torch.Tensor:
    """Weight grad through ``tap_wgrad``, at the compact kernel extent."""
    src, dyn, taps = weight_grad_operands(x, dy, d, groups)
    dw = tg.tap_wgrad(src, dyn, taps, d.H_o, d.W_o)     # (G, T, C, N) f32
    dw = dw.reshape(groups, d.k_taps_h, d.k_taps_w, d.C, d.N)
    return (dw.permute(0, 4, 3, 1, 2)
            .reshape(groups * d.N, d.C, d.k_taps_h, d.k_taps_w).to(x.dtype))
