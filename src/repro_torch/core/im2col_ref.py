"""Conv geometry (paper Table I) and the library-conv oracle.

PyTorch counterpart of ``repro.core.im2col_ref``.  Layouts match the paper
and the JAX package exactly, so tests compare like with like:

  inputs    I   : (B, C, H_i, W_i)      NCHW
  kernels   W   : (N, C, K_h, K_w)      OIHW
  outputs   Y   : (B, N, H_o, W_o)

``conv2d_lax``/``conv_grads_lax`` keep the JAX names: they are the ``lax``
engine and the numeric ground truth, realized here as ``F.conv2d`` plus
``torch.nn.grad.conv2d_input``/``conv2d_weight``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.nn import grad as nn_grad


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


def zero_pad(x: torch.Tensor, ph: int, pw: int, ph_hi: int | None = None,
             pw_hi: int | None = None) -> torch.Tensor:
    """Spatial zero padding on the last two dims (asymmetric if *_hi given)."""
    ph_hi = ph if ph_hi is None else ph_hi
    pw_hi = pw if pw_hi is None else pw_hi
    if ph == 0 and pw == 0 and ph_hi == 0 and pw_hi == 0:
        return x
    return F.pad(x, (pw, pw_hi, ph, ph_hi))


def rot180(w: torch.Tensor) -> torch.Tensor:
    """Kernel-wise 180-degree rotation on the two trailing spatial dims."""
    return torch.flip(w, (-2, -1))


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
