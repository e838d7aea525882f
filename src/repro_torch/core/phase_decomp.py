"""Stride-phase decomposition: the ``bp_phase`` engine.

PyTorch counterpart of ``repro.core.phase_decomp``.  The zero pattern of
backprop is periodic with the forward stride, so grouping virtual
coordinates by phase ``(h mod s_h, w mod s_w)`` turns each phase of the
input gradient into a dense stride-1 correlation over the COMPACT dY with
a static kernel subsample, and turns the weight gradient into one dense
contraction per kernel tap against a strided view of the input.  The
per-phase correlations are library convs, as the JAX version leaves them
to XLA; no kernel of the port runs here.

Every function takes ``groups`` and serves a grouped conv in one call:
``w`` is ``(G*N, C, K_h, K_w)`` at the EFFECTIVE extent, ``d`` the
per-group :class:`ConvDims`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.im2col_ref import ConvDims, rot180, zero_pad


def phase_geometry(r: int, a: int, S: int, K: int, H_i: int, H_o: int):
    """Static per-phase geometry: tap start c_r, tap count M_r, input offset
    off_r, and the phase's output length.  Shared with the kernel planner
    (``repro_torch.kernels.ops``), which fuses all phases into one launch."""
    c_r = (a - r) % S
    M_r = (K - c_r + S - 1) // S          # number of taps kh = c_r + m*S < K
    off_r = (r + c_r - a) // S
    n_q = (H_i - r + S - 1) // S          # outputs q with q*S + r < H_i
    return c_r, M_r, off_r, n_q


def _iohw_to_oihw(wk: torch.Tensor, groups: int) -> torch.Tensor:
    """(G*N, C, kh, kw) read as IOHW per group -> torch's (G*C, N, kh, kw)."""
    gn, c, kh, kw = wk.shape
    return (wk.reshape(groups, gn // groups, c, kh, kw).transpose(1, 2)
            .reshape(groups * c, gn // groups, kh, kw))


def input_grad_phase(dy: torch.Tensor, w: torch.Tensor, d: ConvDims,
                     groups: int = 1) -> torch.Tensor:
    """dI via s_h*s_w dense stride-1 correlations over the compact dY."""
    s_h, s_w = d.s_h, d.s_w
    wf = rot180(w)
    if s_h == 1 and s_w == 1:
        # Degenerate: single phase == plain full-padding correlation.
        src = zero_pad(dy, d.K_h - 1 - d.P_h, d.K_w - 1 - d.P_w,
                       d.K_h - 1 - d.p_h_hi + d.R_h,
                       d.K_w - 1 - d.p_w_hi + d.R_w)
        return F.conv2d(src, _iohw_to_oihw(wf, groups), groups=groups)
    a_h = d.K_h - 1 - d.P_h
    a_w = d.K_w - 1 - d.P_w
    di = dy.new_zeros((dy.shape[0], d.C * groups, d.H_i, d.W_i))
    for r_h in range(min(s_h, d.H_i)):
        c_h, m_h, off_h, n_qh = phase_geometry(r_h, a_h, s_h, d.K_h, d.H_i,
                                               d.H_o)
        for r_w in range(min(s_w, d.W_i)):
            c_w, m_w, off_w, n_qw = phase_geometry(r_w, a_w, s_w, d.K_w,
                                                   d.W_i, d.W_o)
            if n_qh == 0 or n_qw == 0 or m_h == 0 or m_w == 0:
                continue  # no taps contribute: this phase of dI stays zero
            wk = wf[:, :, c_h::s_h, c_w::s_w][:, :, :m_h, :m_w]
            pad_lo_h, pad_lo_w = max(0, -off_h), max(0, -off_w)
            pad_hi_h = max(0, (n_qh - 1) + off_h + m_h - d.H_o)
            pad_hi_w = max(0, (n_qw - 1) + off_w + m_w - d.W_o)
            src = dy[:, :, max(0, off_h):, max(0, off_w):]
            src = zero_pad(src, pad_lo_h, pad_lo_w, pad_hi_h, pad_hi_w)
            out = F.conv2d(src, _iohw_to_oihw(wk, groups), groups=groups)
            di[:, :, r_h::s_h, r_w::s_w] = out[:, :, :n_qh, :n_qw]
    return di


def weight_grad_phase(x: torch.Tensor, dy: torch.Tensor, d: ConvDims,
                      groups: int = 1) -> torch.Tensor:
    """dW via K_h*K_w dense contractions against strided views of the
    input; returns ``(G*N, C, K_h, K_w)`` at the effective extent."""
    b = x.shape[0]
    xp = zero_pad(x, d.P_h, d.P_w, d.p_h_hi, d.p_w_hi)
    dyg = dy.reshape(b, groups, d.N, d.H_o, d.W_o).float()
    taps = []
    for kh in range(d.K_h):
        row = []
        for kw in range(d.K_w):
            v = xp[:, :, kh:kh + d.s_h * (d.H_o - 1) + 1:d.s_h,
                   kw:kw + d.s_w * (d.W_o - 1) + 1:d.s_w]
            v = v.reshape(b, groups, d.C, d.H_o, d.W_o).float()
            row.append(torch.einsum("bgnhw,bgchw->gnc", dyg, v)
                       .reshape(groups * d.N, d.C))
        taps.append(torch.stack(row, dim=-1))            # (G*N, C, K_w)
    return torch.stack(taps, dim=-2).to(x.dtype)         # (G*N, C, K_h, K_w)
