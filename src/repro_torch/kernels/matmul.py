"""Wrapper of the hand-written CUDA GEMM (``csrc/matmul.cu``).

Counterpart of ``repro.kernels.matmul``: ``(M, K) @ (K, N)`` with float32
accumulation and an output of ``out_dtype or a.dtype``, with an optional
leading batch dimension ``G`` on both operands (the groups of a grouped
conv, one launch for all of them).  It is the GEMM under the
``traditional`` and ``bp_im2col`` conv engines.

The TPU kernel's ``bm``/``bn``/``bk`` tile arguments and its ``interpret``
flag are dropped: the CUDA kernel's tiles are fixed, and ragged edges are
masked instead of padded to 128.  On a CUDA tensor the wrapper checks its
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
from repro_torch.kernels.tap_gemm import (GRID_YZ_MAX, INT32_MAX, _cdiv,
                                          _on_cuda, _stream, wgrad_splits)

#: kernel launches, counted only where the CUDA kernel launches (one per
#: call; the split-K reduction belongs to the same call).
LAUNCHES: dict[str, int] = {"matmul": 0}

#: the kernel's fixed output tile (must match BM, BN in csrc/matmul.cu).
TILE_M, TILE_N = 64, 64
DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("matmul")
    lib.matmul.argtypes = [_P] * 4 + [_I] * 7 + [_P]
    lib.matmul.restype = ctypes.c_int
    return lib


def launch_gap(m: int, k: int, n: int, groups: int = 1) -> str | None:
    """None when a ``(groups, m, k) @ (groups, k, n)`` product fits the
    kernel's launch limits, else why not."""
    if max(m, k, n) > INT32_MAX:
        return f"({m}, {k}, {n}) exceeds the kernel's 32-bit index"
    if _cdiv(n, TILE_N) > GRID_YZ_MAX:
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
    tiles = _cdiv(m, TILE_M) * _cdiv(n, TILE_N)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    splits = wgrad_splits(tiles * g, k, sms, g)
    part = out if splits == 1 else torch.empty(
        (splits, g, m, n), dtype=torch.float32, device=a.device)
    err = _lib().matmul(a3.data_ptr(), b3.data_ptr(), part.data_ptr(),
                        out.data_ptr(), int(a.dtype == torch.bfloat16),
                        int(out_dtype == torch.bfloat16), g, m, k, n, splits,
                        _stream(a))
    if err != 0:
        raise RuntimeError(f"matmul: CUDA launch failed with error {err}")
    LAUNCHES["matmul"] += 1
    return out if a.dim() == 3 else out[0]
