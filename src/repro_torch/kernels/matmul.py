"""Wrapper of the hand-written CUDA GEMM (``csrc/matmul.cu``).

Counterpart of ``repro.kernels.matmul``: ``(M, K) @ (K, N)`` with float32
accumulation and an output of ``out_dtype or a.dtype``, with an optional
leading batch dimension ``G`` on both operands (the groups of a grouped
conv, one launch for all of them).  It is the GEMM under the
``traditional`` and ``bp_im2col`` conv engines.

The TPU kernel's ``bm``/``bn``/``bk`` tile arguments and its ``interpret``
flag are dropped: the CUDA kernel has four fixed tiles (:data:`VARIANTS`),
one picked per shape by :func:`matmul_plan`, and ragged edges are masked
instead of padded to 128.  On a CUDA tensor the wrapper checks its
operands and launches the kernel (built at first use by
``repro_torch.kernels.build``) or raises; it never falls back.  On a CPU
tensor it returns the plain version ``repro_torch.kernels.ref.matmul_ref``.
``LAUNCHES["matmul"]`` counts kernel launches (CUDA only).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.tap_gemm import (GRID_YZ_MAX, INT32_MAX, Tile,
                                          _cdiv, _on_cuda, _sms, _stream,
                                          split_count)

#: kernel launches, counted only where the CUDA kernel launches (one per
#: call; the split-K reduction belongs to the same call).
LAUNCHES: dict[str, int] = {"matmul": 0}

#: the kernel's tiles (``gemm::``, ``tall::`` and ``mirror::`` in
#: csrc/matmul.cu) as the split-K plan sees them
#: (:class:`repro_torch.kernels.tap_gemm.Tile`): 64 x 64 with 8 x 8 sums a
#: thread (64 threads, 18,432 B of shared memory); 64 x 16 with 4 x 4 for
#: 8 < N <= 16 (12,288 B); for an edge of at most 8, 128 x 8 (N <= 8) and
#: 8 x 128 (M <= 8) with one row or column a thread (128 threads,
#: 38,912 B and 34,816 B).  ``per_sm`` is the least over each variant's
#: float32 instances that the card's occupancy calculator gives;
#: ``chip_smoke.py`` holds it to the card.
VARIANTS = {"64x64": Tile(64, 64, 16, 6), "64x16": Tile(64, 16, 16, 12),
            "128x8": Tile(128, 8, 32, 5), "8x128": Tile(8, 128, 32, 6)}
#: the C entry's variant codes
_CODE = {"64x64": 0, "128x8": 1, "8x128": 2, "64x16": 3}
DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("matmul")
    lib.matmul.argtypes = [_P] * 4 + [_I] * 8 + [_P]
    lib.matmul_blocks_per_sm.argtypes = [_I] * 4 + [_P]
    lib.matmul.restype = lib.matmul_blocks_per_sm.restype = ctypes.c_int
    return lib


def matmul_variant(m: int, n: int) -> str:
    """The tile of an ``(m, k) @ (k, n)`` product: 128 x 8 when ``n <= 8``
    and 8 x 128 when ``m <= 8`` (the smaller edge decides), else 64 x 16
    when ``n <= 16``, else 64 x 64."""
    if min(m, n) <= 8:
        return "128x8" if n <= m else "8x128"
    return "64x16" if n <= 16 else "64x64"


def matmul_plan(g: int, m: int, k: int, n: int,
                sms: int) -> tuple[str, int]:
    """``(variant, splits)`` of ``g`` products ``(m, k) @ (k, n)`` on a card
    of ``sms`` SMs: the variant's tiles over every group, split over ``k``
    until they fill the card
    (:func:`repro_torch.kernels.tap_gemm.split_count`)."""
    variant = matmul_variant(m, n)
    tile = VARIANTS[variant]
    tiles = g * _cdiv(m, tile.rows) * _cdiv(n, tile.cols)
    return variant, split_count(tile, tiles, k, sms, g)


def blocks_per_sm(variant: str, in_bf16: bool, vec_a: bool,
                  vec_b: bool) -> int:
    """Blocks of one instance an SM of the current card holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    blocks = ctypes.c_int(0)
    err = _lib().matmul_blocks_per_sm(_CODE[variant], int(in_bf16),
                                      int(vec_a), int(vec_b),
                                      ctypes.addressof(blocks))
    if err != 0:
        raise RuntimeError(f"matmul_blocks_per_sm: CUDA error {err}")
    return blocks.value


def launch_gap(m: int, k: int, n: int, groups: int = 1) -> str | None:
    """None when a ``(groups, m, k) @ (groups, k, n)`` product fits the
    kernel's launch limits, else why not."""
    if max(m, k, n) > INT32_MAX:
        return f"({m}, {k}, {n}) exceeds the kernel's 32-bit index"
    if _cdiv(n, VARIANTS[matmul_variant(m, n)].cols) > GRID_YZ_MAX:
        return f"{n} output columns exceed the grid's y limit"
    if groups > GRID_YZ_MAX:
        return f"{groups} batches exceed the grid's z limit"
    return None


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a ([G,] M, K) @ b ([G,] K, N) -> ([G,] M, N)`` in ``out_dtype or
    a.dtype``, summed in float32."""
    if a.dim() != b.dim() or a.dim() not in (2, 3):
        raise ValueError(f"matmul: operands {tuple(a.shape)} and "
                         f"{tuple(b.shape)} must both be 2-D or both 3-D")
    a3, b3 = (a, b) if a.dim() == 3 else (a[None], b[None])
    g, m, k = a3.shape
    g2, k2, n = b3.shape
    if (g2, k2) != (g, k):
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} disagree")
    out_dtype = out_dtype or a.dtype
    if not _on_cuda("matmul", a):
        return ref.matmul_ref(a, b, out_dtype)
    if b.device != a.device:
        raise ValueError(f"matmul: operands on {a.device} and {b.device}")
    if a.dtype not in DTYPES or b.dtype != a.dtype or out_dtype not in DTYPES:
        raise TypeError(f"matmul: the CUDA kernel takes float32 or bfloat16 "
                        f"operands of one type and output, got {a.dtype}, "
                        f"{b.dtype} -> {out_dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul: operands must be contiguous")
    gap = launch_gap(m, k, n, g)
    if gap:
        raise ValueError(f"matmul: {gap}")
    out = torch.empty((g, m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0 or k == 0:
        return out.zero_() if a.dim() == 3 else out[0].zero_()
    variant, splits = matmul_plan(g, m, k, n, _sms(a.device))
    part = out if splits == 1 and out_dtype == torch.float32 else torch.empty(
        (splits, g, m, n), dtype=torch.float32, device=a.device)
    err = _lib().matmul(a3.data_ptr(), b3.data_ptr(), part.data_ptr(),
                        out.data_ptr(), int(a.dtype == torch.bfloat16),
                        int(out_dtype == torch.bfloat16), g, m, k, n,
                        _CODE[variant], splits, _stream(a))
    if err != 0:
        raise RuntimeError(f"matmul: CUDA launch failed with error {err}")
    LAUNCHES["matmul"] += 1
    return out if a.dim() == 3 else out[0]
