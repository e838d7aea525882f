"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

Counterpart of ``repro.kernels.flash_attention``: online-softmax attention
on ``(B, H, L, D)``, causal or full, float32 sums, output in ``q.dtype``,
plus grouped key/value heads (``k``, ``v`` may have ``Hk`` heads with
``H % Hk == 0``; query head h reads head ``h // (H // Hk)``).  It runs the
attention of every prefill of the LM server
(``repro_torch.models.attention._sdpa``), MLA's at head dim 192 and
recurrentgemma-9b's at 256 (its prompts that fit the local window).

Both types run on the tensor cores (``mma.sync``).  bfloat16 inputs
round each probability to bf16 before the P V product, where the TPU
kernel keeps float32 P.  float32 inputs take TF32 products three to a
pair: each operand x splits into hi = tf32(x) and lo = tf32(x - hi), and
a b sums a_hi b_lo + a_lo b_hi + a_hi b_hi in float32, about 2^-21 of
|a b| from the exact product, float32's own scale, where one TF32 product
(2^-11) would miss the float32 path's 1e-5; P stays float32 as in the
TPU kernel.

The TPU kernel's ``block_q``/``block_k`` tile arguments and its
``interpret`` flag are dropped: the CUDA kernel's tiles are fixed and
ragged edges are masked instead of padded.  A causal call with ``Lq > Lk``
raises (a query row would have no key; the TPU kernel's output there is an
artefact of its padding).  The kernel has no backward (nor has the TPU
kernel): with grad mode on and an operand that requires grad the wrapper
raises, on the card and on the CPU alike, rather than return an output
that drops the gradient.  On a CUDA tensor the wrapper checks its
operands and launches the kernel (built at first use by
``repro_torch.kernels.build``) or raises; it never falls back.  On a CPU
tensor it returns the plain version
``repro_torch.kernels.ref.flash_attention_ref``.
``LAUNCHES["flash_attention"]`` counts kernel launches of both types,
``LAUNCHES["flash_attention_f32"]`` those of the float32 instance alone
(CUDA only).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.tap_gemm import GRID_YZ_MAX, _on_cuda, _stream

#: kernel launches, counted only where the CUDA kernel launches.
LAUNCHES: dict[str, int] = {"flash_attention": 0, "flash_attention_f32": 0}

#: the largest head dim the kernel's shared-memory tiles hold (instances
#: for D <= 64, 128, 192 and 256, and 80 in float32; the TPU kernel takes
#: any D, ROADMAP B4).
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention.argtypes = ([_P] * 4 + [_I] * 8
                                    + [ctypes.c_float, _P])
    lib.flash_attention.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, H, Lq, D), k/v (B, Hk, Lk, D) -> (B, H, Lq, D) in ``q.dtype``;
    ``scale`` defaults to ``D ** -0.5``."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be "
                         f"(B, H, Lq, D) and two equal (B, Hk, Lk, D)")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention: the kernel has no backward; "
                           "call it with grad mode off or on operands that "
                           "do not require grad")
    b, h, lq, d = q.shape
    hk, lk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hk == 0 or h % hk:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} disagree (batch, head dim, or "
                         f"{h} query heads not a multiple of {hk})")
    if lk == 0:
        raise ValueError("flash_attention: no keys")
    if causal and lq > lk:
        raise ValueError(f"flash_attention: causal with {lq} queries > {lk} "
                         f"keys leaves a row without a key")
    scale = d ** -0.5 if scale is None else float(scale)
    if not _on_cuda("flash_attention", q):
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: operands on {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: the CUDA kernel takes float32 or "
                        f"bfloat16 operands of one type, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: operands must be contiguous")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} outside the "
                         f"kernel's 1..{MAX_HEAD_DIM}")
    if b * h > GRID_YZ_MAX:
        raise ValueError(f"flash_attention: {b * h} batch x heads exceed the "
                         f"grid's y limit {GRID_YZ_MAX}")
    out = torch.empty_like(q)
    if lq == 0:
        return out
    err = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, h, hk, lq, lk, d, int(causal),
        scale, _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES["flash_attention"] += 1
    if q.dtype == torch.float32:
        LAUNCHES["flash_attention_f32"] += 1
    return out
