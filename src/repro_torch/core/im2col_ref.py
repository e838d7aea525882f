"""Conv geometry (paper Table I), the library-conv oracle and the explicit
im2col baseline.

PyTorch counterpart of ``repro.core.im2col_ref``.  Layouts match the paper
and the JAX package exactly, so tests compare like with like:

  inputs    I   : (B, C, H_i, W_i)      NCHW
  kernels   W   : (N, C, K_h, K_w)      OIHW
  outputs   Y   : (B, N, H_o, W_o)

``conv2d_lax``/``conv_grads_lax`` keep the JAX names: they are the ``lax``
engine and the numeric ground truth, realized here as ``F.conv2d`` plus
``torch.nn.grad.conv2d_input``/``conv2d_weight``.  The ``*_explicit``
functions are the ``traditional`` engine: they build the zero-spaced
tensors and the lowered matrices with torch ops and multiply them through
the hand-written ``repro_torch.kernels.matmul.matmul``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.nn import grad as nn_grad

from repro_torch.kernels.matmul import matmul


@dataclasses.dataclass(frozen=True)
class ConvDims:
    """Static geometry of one convolutional layer (paper Table I symbols).

    ``P_h``/``P_w`` are the LOW-side (top/left) pads; ``P_h_hi``/``P_w_hi``
    default to the ``-1`` "symmetric" sentinel.  ``S_w`` defaults to ``-1``
    meaning "same as ``S``".  ``K_h``/``K_w`` are the EFFECTIVE
    (zero-dilated) kernel extents; ``D_h``/``D_w`` only say which effective
    taps are real (positions ``i*D_h``, ``j*D_w``).
    """

    B: int       # batch
    C: int       # input channels
    H_i: int     # input height
    W_i: int     # input width
    N: int       # output channels
    K_h: int     # kernel height (EFFECTIVE extent: (taps-1)*D_h + 1)
    K_w: int     # kernel width  (EFFECTIVE extent: (taps-1)*D_w + 1)
    S: int = 1   # row stride (and column stride when S_w == -1)
    P_h: int = 0
    P_w: int = 0
    P_h_hi: int = -1   # -1: symmetric (same as P_h)
    P_w_hi: int = -1   # -1: symmetric (same as P_w)
    S_w: int = -1      # -1: symmetric (same as S)
    D_h: int = 1       # kernel dilation (1: dense kernel)
    D_w: int = 1

    def __post_init__(self):
        if self.D_h < 1 or self.D_w < 1:
            raise ValueError(f"dilation must be >= 1, got {(self.D_h, self.D_w)}")
        if (self.K_h - 1) % self.D_h or (self.K_w - 1) % self.D_w:
            raise ValueError(
                f"effective kernel extent ({self.K_h}, {self.K_w}) is not "
                f"(taps-1)*D + 1 for dilation ({self.D_h}, {self.D_w})")

    @property
    def s_h(self) -> int:
        return self.S

    @property
    def s_w(self) -> int:
        return self.S if self.S_w < 0 else self.S_w

    @property
    def k_taps_h(self) -> int:
        """Real (non-zero) kernel taps along H: the compact kernel height."""
        return (self.K_h - 1) // self.D_h + 1

    @property
    def k_taps_w(self) -> int:
        return (self.K_w - 1) // self.D_w + 1

    @property
    def has_dilation(self) -> bool:
        return self.D_h > 1 or self.D_w > 1

    @property
    def p_h_hi(self) -> int:
        return self.P_h if self.P_h_hi < 0 else self.P_h_hi

    @property
    def p_w_hi(self) -> int:
        return self.P_w if self.P_w_hi < 0 else self.P_w_hi

    @property
    def H_o(self) -> int:
        return (self.H_i + self.P_h + self.p_h_hi - self.K_h) // self.s_h + 1

    @property
    def W_o(self) -> int:
        return (self.W_i + self.P_w + self.p_w_hi - self.K_w) // self.s_w + 1

    # Zero-inserted sizes (Table I): H_o'' / W_o''
    @property
    def H_o2(self) -> int:
        return self.H_o + (self.H_o - 1) * (self.s_h - 1)

    @property
    def W_o2(self) -> int:
        return self.W_o + (self.W_o - 1) * (self.s_w - 1)

    # Zero-inserted AND zero-padded sizes (Table I): H_o''' / W_o'''
    @property
    def H_o3(self) -> int:
        return (self.H_o2 + (self.K_h - 1 - self.P_h)
                + (self.K_h - 1 - self.p_h_hi) + self.R_h)

    @property
    def W_o3(self) -> int:
        return (self.W_o2 + (self.K_w - 1 - self.P_w)
                + (self.K_w - 1 - self.p_w_hi) + self.R_w)

    # Tiling remainder: input rows/cols that no forward window covers.
    @property
    def R_h(self) -> int:
        return (self.H_i + self.P_h + self.p_h_hi - self.K_h
                - (self.H_o - 1) * self.s_h)

    @property
    def R_w(self) -> int:
        return (self.W_i + self.P_w + self.p_w_hi - self.K_w
                - (self.W_o - 1) * self.s_w)

    def validate(self) -> None:
        if self.H_o < 1 or self.W_o < 1:
            raise ValueError(f"empty output plane ({self.H_o}x{self.W_o})")
        if self.K_h - 1 - self.P_h < 0 or self.K_w - 1 - self.P_w < 0:
            raise ValueError("transposed-conv padding K-1-P must be non-negative")
        if self.K_h - 1 - self.p_h_hi + self.R_h < 0 or \
                self.K_w - 1 - self.p_w_hi + self.R_w < 0:
            raise ValueError("high-side transposed-conv padding K-1-P_hi+R "
                             "must be non-negative")

    # ---- element counts used by the perf model and sparsity analysis ----

    def lowered_B_shape_loss(self) -> tuple[int, int]:
        """Virtual stationary matrix B during loss calc: rows x cols."""
        return (self.N * self.K_h * self.K_w, self.B * self.H_i * self.W_i)

    def lowered_A_shape_grad(self) -> tuple[int, int]:
        """Virtual dynamic matrix A during gradient calc (zero-inserted dY)."""
        return (self.B * self.H_o2 * self.W_o2, 1)  # per (n) column stream

    def zero_space_sparsity_loss(self) -> float:
        """Fraction of zero pixels in the zero-spaced dY (H_o''' x W_o''')
        consumed by loss calculation."""
        return 1.0 - self.H_o * self.W_o / (self.H_o3 * self.W_o3)

    def zero_space_sparsity_grad(self) -> float:
        """Fraction of zero pixels in the zero-inserted dY (H_o'' x W_o'')."""
        return 1.0 - self.H_o * self.W_o / (self.H_o2 * self.W_o2)


def zero_pad(x: torch.Tensor, ph: int, pw: int, ph_hi: int | None = None,
             pw_hi: int | None = None) -> torch.Tensor:
    """Spatial zero padding on the last two dims (asymmetric if *_hi given)."""
    ph_hi = ph if ph_hi is None else ph_hi
    pw_hi = pw if pw_hi is None else pw_hi
    if ph == 0 and pw == 0 and ph_hi == 0 and pw_hi == 0:
        return x
    return F.pad(x, (pw, pw_hi, ph, ph_hi))


def insert_zeros(x: torch.Tensor, S) -> torch.Tensor:
    """Insert S-1 zeros between spatial elements: (..., H, W) -> (..., H'', W'')
    (the JAX package's ``zero_insert``).  ``S`` is an int or a per-axis pair
    ``(s_h, s_w)``.  This builds the zero space the implicit engines avoid."""
    s_h, s_w = (S, S) if isinstance(S, int) else S
    if s_h == 1 and s_w == 1:
        return x
    *lead, h, w = x.shape
    out = x.new_zeros((*lead, h + (h - 1) * (s_h - 1), w + (w - 1) * (s_w - 1)))
    out[..., ::s_h, ::s_w] = x
    return out


def insert_zeros_pad(dy: torch.Tensor, d: ConvDims) -> torch.Tensor:
    """dY (B, N, H_o, W_o) -> zero-spaced dY_ei (the JAX package's
    ``zero_insert_pad``): zeros inserted, then padded K-1-P on top/left and
    K-1-P_hi+R on bottom/right, so a stride-1 valid conv over it gives the
    full H_i x W_i input gradient."""
    return zero_pad(insert_zeros(dy, (d.s_h, d.s_w)),
                    d.K_h - 1 - d.P_h, d.K_w - 1 - d.P_w,
                    d.K_h - 1 - d.p_h_hi + d.R_h,
                    d.K_w - 1 - d.p_w_hi + d.R_w)


def rot180(w: torch.Tensor) -> torch.Tensor:
    """Kernel-wise 180-degree rotation on the two trailing spatial dims."""
    return torch.flip(w, (-2, -1))


# ---------------------------------------------------------------------------
# Explicit im2col and the baseline's three GEMMs (the "traditional" engine)
# ---------------------------------------------------------------------------

def _im2col_groups(x: torch.Tensor, kh: int, kw: int, stride,
                   groups: int) -> torch.Tensor:
    """(B, G*C, H, W) -> (G, B*H_o*W_o, C*kh*kw): each group's lowered
    dynamic matrix, columns in (C, kh, kw) order, materialized."""
    s_h, s_w = (stride, stride) if isinstance(stride, int) else stride
    b = x.shape[0]
    cols = F.unfold(x, (kh, kw), stride=(s_h, s_w))     # (B, G*C*kh*kw, L)
    return (cols.reshape(b, groups, -1, cols.shape[-1]).permute(1, 0, 3, 2)
            .reshape(groups, -1, cols.shape[1] // groups).contiguous())


def im2col(x: torch.Tensor, kh: int, kw: int, stride=1) -> torch.Tensor:
    """Lower (B, C, H, W) into the dynamic matrix (B*H_o*W_o, C*kh*kw).

    ``stride`` is an int or a per-axis ``(s_h, s_w)`` pair.  The column
    order (C, kh, kw) is that of ``conv_general_dilated_patches``.  This
    materializes the matrix copy -- the storage/bandwidth overhead the
    implicit algorithms avoid."""
    return _im2col_groups(x, kh, kw, stride, 1)[0]


def _merge_groups(y: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """(G, B*h*w, C) GEMM output -> (B, G*C, h, w)."""
    g, _, c = y.shape
    return y.reshape(g, b, h, w, c).permute(1, 0, 4, 2, 3).reshape(
        b, g * c, h, w)


def _cropped_input(x: torch.Tensor, d: ConvDims, groups: int) -> torch.Tensor:
    """pad(I) without the tiling remainder, per group with batch and
    channels swapped: (G*C, B, K_h + (H_o-1)*s_h, K_w + (W_o-1)*s_w)."""
    xe = _padded(x, d)[:, :, :d.K_h + (d.H_o - 1) * d.s_h,
                       :d.K_w + (d.W_o - 1) * d.s_w]
    b, _, h, w = xe.shape
    return xe.reshape(b, groups, d.C, h, w).permute(1, 2, 0, 3, 4).reshape(
        groups * d.C, b, h, w)


def weight_patches(x: torch.Tensor, d: ConvDims, groups: int = 1):
    """The gradient calculation's lowered input, (G, C*K_h*K_w,
    B*H_o''*W_o''): the im2col of Tr(pad(I)) with the zero-inserted dY's
    extent as the kernel (shared by the explicit and implicit engines)."""
    patches = F.unfold(_cropped_input(x, d, groups), (d.H_o2, d.W_o2))
    return (patches.transpose(1, 2)
            .reshape(groups, d.C * d.K_h * d.K_w, -1).contiguous())


def _dweight(dwt: torch.Tensor, d: ConvDims) -> torch.Tensor:
    """(G, C*K_h*K_w, N) -> OIHW (G*N, C, K_h, K_w)."""
    g = dwt.shape[0]
    return dwt.reshape(g, d.C, d.K_h, d.K_w, d.N).permute(0, 4, 1, 2, 3) \
        .reshape(g * d.N, d.C, d.K_h, d.K_w)


def conv2d_forward_explicit(x: torch.Tensor, w: torch.Tensor, d: ConvDims,
                            groups: int = 1) -> torch.Tensor:
    """Inference: Y = im2col(pad(I)) @ W -- traditional im2col, one
    ``matmul`` launch for all groups."""
    a = _im2col_groups(_padded(x, d), d.K_h, d.K_w, (d.s_h, d.s_w), groups)
    b = w.reshape(groups, d.N, -1).transpose(1, 2).contiguous()
    return _merge_groups(matmul(a, b), x.shape[0], d.H_o, d.W_o)


def input_grad_explicit(dy: torch.Tensor, w: torch.Tensor, d: ConvDims,
                        groups: int = 1) -> torch.Tensor:
    """Loss calculation with full zero-space materialization.

    dI = conv(dY_ei, Tr(rot180(W))), stride 1.  The zero-spaced dY_ei and
    its im2col copy are both physically built (what the paper measures as
    'Reorganization' + 'Computation')."""
    a = _im2col_groups(insert_zeros_pad(dy, d), d.K_h, d.K_w, 1, groups)
    wt = rot180(w).reshape(groups, d.N, d.C, d.K_h * d.K_w).transpose(1, 2)
    b = wt.reshape(groups, d.C, -1).transpose(1, 2).contiguous()
    return _merge_groups(matmul(a, b), dy.shape[0], d.H_i, d.W_i)


def weight_grad_explicit(x: torch.Tensor, dy: torch.Tensor, d: ConvDims,
                         groups: int = 1) -> torch.Tensor:
    """Gradient calculation with full zero-space materialization.

    Tr(dW) = conv(Tr(pad(I)), Tr(zero_insert(dY))), stride 1: the batch is
    the contraction and the zero-inserted dY the convolving kernel of
    extent (H_o'', W_o'')."""
    b = dy.shape[0]
    dyi = insert_zeros(dy, (d.s_h, d.s_w))          # (B, G*N, Ho'', Wo'')
    bm = (dyi.reshape(b, groups, d.N, -1).permute(1, 0, 3, 2)
          .reshape(groups, -1, d.N).contiguous())   # (G, B*Ho''*Wo'', N)
    return _dweight(matmul(weight_patches(x, d, groups), bm), d)


def _padded(x: torch.Tensor, d: ConvDims) -> torch.Tensor:
    return zero_pad(x, d.P_h, d.P_w, d.p_h_hi, d.p_w_hi)


def conv2d_lax(x: torch.Tensor, w: torch.Tensor, d: ConvDims,
               groups: int = 1) -> torch.Tensor:
    """Library forward conv; ``w`` has the EFFECTIVE extent ``K_h x K_w``."""
    return F.conv2d(_padded(x, d), w, stride=(d.s_h, d.s_w), groups=groups)


def conv2d_input_lax(dy: torch.Tensor, w: torch.Tensor, d: ConvDims,
                     groups: int = 1) -> torch.Tensor:
    """dI of :func:`conv2d_lax`: the library input grad over the padded
    plane, cropped back to ``H_i x W_i`` (exact for asymmetric padding)."""
    hp = d.H_i + d.P_h + d.p_h_hi
    wp = d.W_i + d.P_w + d.p_w_hi
    dxp = nn_grad.conv2d_input((dy.shape[0], w.shape[1] * groups, hp, wp), w,
                               dy, stride=(d.s_h, d.s_w), groups=groups)
    return dxp[:, :, d.P_h:d.P_h + d.H_i, d.P_w:d.P_w + d.W_i]


def conv2d_weight_lax(x: torch.Tensor, dy: torch.Tensor, d: ConvDims,
                      groups: int = 1) -> torch.Tensor:
    """dW of :func:`conv2d_lax` at the effective extent, OIHW."""
    return nn_grad.conv2d_weight(_padded(x, d),
                                 (dy.shape[1], x.shape[1] // groups,
                                  d.K_h, d.K_w),
                                 dy, stride=(d.s_h, d.s_w), groups=groups)


def conv_grads_lax(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                   d: ConvDims, groups: int = 1):
    """(dI, dW) from the library conv -- the numeric ground truth."""
    return (conv2d_input_lax(dy, w, d, groups),
            conv2d_weight_lax(x, dy, d, groups))


# ---------------------------------------------------------------------------
# Byte/element accounting for the perf model (what reorganization costs)
# ---------------------------------------------------------------------------

def reorg_traffic_elems_loss(d: ConvDims) -> dict[str, int]:
    """Elements read+written by the zero-space reorganization of dY for the
    loss calc, and elements streamed to buffer B, under traditional im2col."""
    compact = d.B * d.N * d.H_o * d.W_o
    spaced = d.B * d.N * d.H_o3 * d.W_o3
    lowered = d.N * d.K_h * d.K_w * d.B * d.H_i * d.W_i  # stationary matrix B
    return {
        "reorg_read": compact,
        "reorg_write": spaced,
        "offchip_stream": spaced,       # zero-spaced map shipped to chip
        "buffer_stream": lowered,       # lowered matrix entries fed to PEs
        "extra_storage": spaced - compact,
    }


def reorg_traffic_elems_grad(d: ConvDims) -> dict[str, int]:
    compact = d.B * d.N * d.H_o * d.W_o
    spaced = d.B * d.N * d.H_o2 * d.W_o2
    return {
        "reorg_read": compact,
        "reorg_write": spaced,
        "offchip_stream": spaced,
        "buffer_stream": spaced,        # matrix A rows stream zero-inserted dY
        "extra_storage": spaced - compact,
    }
