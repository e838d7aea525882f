"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes the same function as its CUDA kernel in
``repro_torch/csrc/`` (``tap_gemm.cu``, ``matmul.cu``) with ordinary tensor
ops, not the kernel's blocks step by step.  The kernel wrappers in
``repro_torch.kernels.tap_gemm`` and ``repro_torch.kernels.matmul`` use them
for tensors on the CPU; ``chip_smoke.py`` holds each kernel against its
plain version on the card.

Every function accepts optional leading dims (the kernels' group dim):
``src (..., P, B, Hs, Ws, CIN)`` etc.  Reads past the source plane are zero,
as the kernels mask them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _cover(src: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-extend the (Hs, Ws) axes of a channels-last tensor so every
    window up to (rows, cols) lies inside it."""
    hs, ws = src.shape[-3], src.shape[-2]
    if hs >= rows and ws >= cols:
        return src
    return F.pad(src, (0, 0, 0, max(0, cols - ws), 0, max(0, rows - hs)))


def tap_gemm_ref(src, w, taps, oh, ow):
    """out[..., b, oh, ow, :] = sum_t src[..., p_t, b, oh+du_t, ow+dv_t, :] @ w[..., t].

    src (..., P, B, Hs, Ws, CIN), w (..., T, CIN, COUT) -> (..., B, oh, ow, COUT).
    """
    halo_h = max((du for _, du, _ in taps), default=0)
    halo_w = max((dv for _, _, dv in taps), default=0)
    s = _cover(src, oh + halo_h, ow + halo_w)
    out = src.new_zeros((*src.shape[:-5], src.shape[-4], oh, ow, w.shape[-1]),
                        dtype=torch.float32)
    for t, (p, du, dv) in enumerate(taps):
        xs = s[..., p, :, du:du + oh, dv:dv + ow, :].float()
        out = out + torch.einsum("...bhwc,...cn->...bhwn", xs, w[..., t, :, :].float())
    return out.to(src.dtype)


def tap_gemm_phased_ref(src, w, phase_taps, oh, ow):
    """All-phases input grad: phase p is ``tap_gemm_ref``'s arithmetic over
    its own taps ``(j, du, dv)`` (weight ``w[..., p, j]``), on the one
    shared source; a phase without taps is zero.

    src (..., B, Hs, Ws, CIN), w (..., PH, T, CIN, COUT)
    -> (..., PH, B, oh, ow, COUT).
    """
    halo_h = max((du for taps in phase_taps for _, du, _ in taps), default=0)
    halo_w = max((dv for taps in phase_taps for _, _, dv in taps), default=0)
    s = _cover(src, oh + halo_h, ow + halo_w)
    planes = []
    for p, taps in enumerate(phase_taps):
        acc = src.new_zeros((*src.shape[:-3], oh, ow, w.shape[-1]),
                            dtype=torch.float32)
        for j, du, dv in taps:
            xs = s[..., du:du + oh, dv:dv + ow, :].float()
            acc = acc + torch.einsum("...bhwc,...cn->...bhwn", xs,
                                     w[..., p, j, :, :].float())
        planes.append(acc)
    return torch.stack(planes, dim=-5).to(src.dtype)


def tap_wgrad_ref(src, dy, taps, oh, ow):
    """dW[..., t] = sum_{b,oh,ow} src[..., p_t, b, oh+du, ow+dv, :]^T dy[..., b, oh, ow, :].

    src (..., P, B, Hs, Ws, CIN), dy (..., B, oh, ow, COUT)
    -> float32 (..., T, CIN, COUT).
    """
    halo_h = max((du for _, du, _ in taps), default=0)
    halo_w = max((dv for _, _, dv in taps), default=0)
    s = _cover(src, oh + halo_h, ow + halo_w)
    dyf = dy.float()
    return torch.stack(
        [torch.einsum("...bhwc,...bhwn->...cn",
                      s[..., p, :, du:du + oh, dv:dv + ow, :].float(), dyf)
         for p, du, dv in taps], dim=-3)


def matmul_ref(a, b, out_dtype=None):
    """``a (..., M, K) @ b (..., K, N)`` summed in float32, returned as
    ``out_dtype or a.dtype`` (``repro.kernels.ref.matmul_ref``)."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)
