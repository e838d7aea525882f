"""BP-im2col: implicit im2col address mapping for backpropagation.

PyTorch counterpart of ``repro.core.bpim2col``: the paper's hardware
address generators (Section III) as integer index math,

    (virtual address) -> (is_nonzero, compact address)

following Algorithm 1 (transposed mode, loss calculation) and Algorithm 2
(dilated mode, gradient calculation) with the NZ predicates of Eqs. (2)-(4).
``gather_lowered_*`` build a lowered GEMM operand by gathering only from
the compact tensor (zeros injected where the map says NULL), and the
``*_implicit`` functions are the ``bp_im2col`` engine: gather, then the
hand-written ``repro_torch.kernels.matmul.matmul``.

JAX folds the index maps at trace time; here each map is built once per
geometry and device and cached (:func:`_gather_map`, sized to the conv
geometries of one model; :func:`clear_gather_maps` releases them).  Every
address fits in int32 -- Algorithm 1's map at Table II layer 1 has 57.8 M
entries, 231 MB -- so the maps and their temporaries are int32 (an int64
temporary of that size would cost 462 MB).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.im2col_ref import (ConvDims, _dweight, rot180,
                                         weight_patches)
from repro_torch.kernels.matmul import matmul


# ---------------------------------------------------------------------------
# NZ detection (Eqs. (2)-(4))
# ---------------------------------------------------------------------------

def in_area0_transposed(h, w, d: ConvDims):
    """Eq. (2): upper/left zero-padding area of the zero-spaced dY."""
    return (h < d.K_h - 1 - d.P_h) | (w < d.K_w - 1 - d.P_w)


def in_area1_transposed(h, w, d: ConvDims):
    """Eq. (3): zero-insertion grid + lower/right padding, per axis (the
    period is that axis's forward stride)."""
    hh = h - (d.K_h - 1 - d.P_h)
    ww = w - (d.K_w - 1 - d.P_w)
    return (hh % d.s_h > 0) | (ww % d.s_w > 0)


def nz_transposed(h, w, d: ConvDims):
    """True where the virtual zero-spaced dY pixel (h, w) is NON-zero, i.e.
    fails Eq. (2) and Eq. (3) and lands inside the stored H_o x W_o."""
    hh = h - (d.K_h - 1 - d.P_h)
    ww = w - (d.K_w - 1 - d.P_w)
    hp = hh // d.s_h
    wp = ww // d.s_w
    ok = (~in_area0_transposed(h, w, d)) & (~in_area1_transposed(h, w, d))
    ok &= (hp >= 0) & (hp < d.H_o) & (wp >= 0) & (wp < d.W_o)
    return ok, hp, wp


def nz_dilated(h, w, d: ConvDims):
    """Eq. (4): virtual zero-inserted dY pixel (h, w) is non-zero iff
    h % s_h == 0 and w % s_w == 0; compact position (h/s_h, w/s_w)."""
    ok = (h % d.s_h == 0) & (w % d.s_w == 0)
    hp = h // d.s_h
    wp = w // d.s_w
    ok &= (hp < d.H_o) & (wp < d.W_o)
    return ok, hp, wp


# ---------------------------------------------------------------------------
# Algorithms 1 and 2: virtual address -> compact address
# ---------------------------------------------------------------------------

def algorithm1(addr_in: torch.Tensor, d: ConvDims):
    """Transposed mode: flat addresses of the virtual stationary matrix B
    (N*K_h*K_w, B*H_i*W_i) -> compact addresses in the stored dY
    (B, N, H_o, W_o), flattened row-major.  Returns ``(valid, addr_out)``;
    ``addr_out`` is -1 (the paper's NULL) where the pixel is zero space."""
    cols = d.B * d.H_i * d.W_i
    row = addr_in // cols
    col = addr_in % cols
    b = col // (d.H_i * d.W_i)
    temp1 = row // d.K_w
    w_k = row % d.K_w
    n = temp1 // d.K_h
    h_k = temp1 % d.K_h
    temp2 = col % (d.H_i * d.W_i)
    h = temp2 // d.W_i + h_k
    w = temp2 % d.W_i + w_k
    ok, hp, wp = nz_transposed(h, w, d)
    addr_out = (b * (d.N * d.H_o * d.W_o) + n * (d.H_o * d.W_o)
                + hp * d.W_o + wp)
    return ok, torch.where(ok, addr_out, -1)


def algorithm2(addr_in: torch.Tensor, d: ConvDims):
    """Dilated mode: flat addresses of the virtual dynamic matrix A (the
    zero-inserted dY as an (N, B, H_o'', W_o'') stream) -> compact dY
    addresses; returns ``(valid, addr_out)`` with -1 NULLs."""
    plane = d.B * d.H_o2 * d.W_o2
    n = addr_in // plane
    col = addr_in % plane
    temp = col // d.W_o2
    w = col % d.W_o2
    b = temp // d.H_o2
    h = temp % d.H_o2
    ok, hp, wp = nz_dilated(h, w, d)
    addr_out = (b * (d.N * d.H_o * d.W_o) + n * (d.H_o * d.W_o)
                + hp * d.W_o + wp)
    return ok, torch.where(ok, addr_out, -1)


@functools.lru_cache(maxsize=8)
def _gather_map(mode: str, d: ConvDims, device: torch.device) -> torch.Tensor:
    """The int32 gather map of one geometry on one device, built once:
    the compact address of every virtual entry, or B*N*H_o*W_o (a zero
    slot appended to the compact dY) for NULL.  ``mode`` is ``"loss"``
    (Algorithm 1, rows x cols of matrix B) or ``"grad_t"`` (Algorithm 2,
    stored transposed as (B*H_o''*W_o'', N) for the weight-grad GEMM)."""
    null = d.B * d.N * d.H_o * d.W_o
    if mode == "loss":
        rows, cols = d.lowered_B_shape_loss()
        algo = algorithm1
    else:
        rows, cols = d.N, d.B * d.H_o2 * d.W_o2
        algo = algorithm2
    addr = torch.arange(rows * cols, dtype=torch.int32, device=device)
    ok, out = algo(addr, d)
    del addr
    idx = torch.where(ok, out, null).reshape(rows, cols)
    return idx if mode == "loss" else idx.t().contiguous()


def clear_gather_maps() -> None:
    """Release every cached gather map (and the device memory it holds)."""
    _gather_map.cache_clear()


def _gather(dy: torch.Tensor, d: ConvDims, groups: int,
            mode: str) -> torch.Tensor:
    """Gather a lowered operand per group from the compact dY
    (B, G*N, H_o, W_o): (G, *map shape).  Only compact data is read."""
    b = dy.shape[0]
    idx = _gather_map(mode, d, dy.device)
    flat = (dy.reshape(b, groups, -1).transpose(0, 1)
            .reshape(groups, -1))                     # (G, B*N*H_o*W_o)
    flat = F.pad(flat, (0, 1))                        # the NULL slot
    return flat.index_select(1, idx.reshape(-1)).reshape(groups, *idx.shape)


def gather_lowered_B_loss(dy: torch.Tensor, d: ConvDims) -> torch.Tensor:
    """The lowered stationary matrix B of the loss calculation,
    (N*K_h*K_w, B*H_i*W_i), gathered from compact dY without ever building
    the zero-spaced dY."""
    return _gather(dy, d, 1, "loss")[0]


def gather_lowered_A_grad(dy: torch.Tensor, d: ConvDims) -> torch.Tensor:
    """The zero-inserted dY stream (N, B*H_o''*W_o'') of the gradient
    calculation, gathered through Algorithm 2 (no reorganization)."""
    return _gather(dy, d, 1, "grad_t")[0].t()


# ---------------------------------------------------------------------------
# End-to-end implicit backprop (gather + GEMM): the bp_im2col engine
# ---------------------------------------------------------------------------

def input_grad_implicit(dy: torch.Tensor, w: torch.Tensor, d: ConvDims,
                        groups: int = 1) -> torch.Tensor:
    """Loss calculation via BP-im2col: dI = Tr(rot180(W)) @ B_lowered, where
    B_lowered is gathered from the compact dY; one ``matmul`` launch for
    all groups.  ``w`` is the effective (dense-extent) kernel."""
    if tuple(w.shape[-2:]) != (d.K_h, d.K_w):
        raise ValueError(f"kernel {tuple(w.shape)} is not the effective "
                         f"extent ({d.K_h}, {d.K_w})")
    bm = _gather(dy, d, groups, "loss")             # (G, N*Kh*Kw, B*Hi*Wi)
    wm = (rot180(w).reshape(groups, d.N, d.C, d.K_h * d.K_w).transpose(1, 2)
          .reshape(groups, d.C, -1).contiguous())   # (G, C, N*Kh*Kw)
    di = matmul(wm, bm)                             # (G, C, B*Hi*Wi)
    return (di.reshape(groups, d.C, dy.shape[0], d.H_i, d.W_i)
            .permute(2, 0, 1, 3, 4).reshape(dy.shape[0], groups * d.C,
                                            d.H_i, d.W_i))


def weight_grad_implicit(x: torch.Tensor, dy: torch.Tensor, d: ConvDims,
                         groups: int = 1) -> torch.Tensor:
    """Gradient calculation via BP-im2col: the rows of matrix A come
    through Algorithm 2 from compact dY; matrix B is the im2col of the
    padded input (no zero space beyond ordinary padding)."""
    a_t = _gather(dy, d, groups, "grad_t")          # (G, B*Ho''*Wo'', N)
    return _dweight(matmul(weight_patches(x, d, groups), a_t), d)


# ---------------------------------------------------------------------------
# Sparsity / traffic analysis (paper Section II claims, Fig. 8 overlays)
# ---------------------------------------------------------------------------

def lowered_sparsity_loss(d: ConvDims) -> float:
    """Exact fraction of zero entries in the lowered matrix B of the loss
    calc -- the paper reports 75%..93.91% for stride>=2 workloads."""
    rows, cols = d.lowered_B_shape_loss()
    hs = np.arange(d.H_i)[:, None] + np.arange(d.K_h)[None, :]  # (H_i, K_h)
    ws = np.arange(d.W_i)[:, None] + np.arange(d.K_w)[None, :]
    hh = hs - (d.K_h - 1 - d.P_h)
    ww = ws - (d.K_w - 1 - d.P_w)
    ok_h = (hh >= 0) & (hh % d.s_h == 0) & (hh // d.s_h < d.H_o)
    ok_w = (ww >= 0) & (ww % d.s_w == 0) & (ww // d.s_w < d.W_o)
    nz = ok_h.sum() * ok_w.sum()
    return 1.0 - nz / (rows * cols / d.N / d.B)  # per (n, b) plane ratio


def lowered_sparsity_grad(d: ConvDims) -> float:
    """Fraction of zeros in the zero-inserted dY consumed by the grad calc."""
    return d.zero_space_sparsity_grad()


def bp_traffic_elems_loss(d: ConvDims) -> dict[str, int]:
    """Traffic under BP-im2col for loss calc: no reorganization; off-chip
    streams compact dY; buffer feeds only non-zero lowered entries."""
    compact = d.B * d.N * d.H_o * d.W_o
    rows, cols = d.lowered_B_shape_loss()
    nonzero_lowered = int(round((1.0 - lowered_sparsity_loss(d)) * rows * cols))
    return {
        "reorg_read": 0,
        "reorg_write": 0,
        "offchip_stream": compact,
        "buffer_stream": nonzero_lowered,
        "extra_storage": 0,
    }


def bp_traffic_elems_grad(d: ConvDims) -> dict[str, int]:
    compact = d.B * d.N * d.H_o * d.W_o
    return {
        "reorg_read": 0,
        "reorg_write": 0,
        "offchip_stream": compact,
        "buffer_stream": compact,   # only non-zero rows of matrix A stream
        "extra_storage": 0,
    }
