"""The hand-written CUDA kernels (``tap_gemm``, ``matmul``,
``flash_attention``), their plain versions (``ref``), the build
(``build``) and the kernel engine's conv passes (``ops``).
:func:`launch_counts` gathers every wrapper's count (``flash_attention``
of both types, and ``flash_attention_f32`` of the float32 instance alone)."""

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import tap_gemm as _tg


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel name, across every wrapper module."""
    return {**_tg.LAUNCHES, **_mm.LAUNCHES, **_fa.LAUNCHES}


def reset_launch_counts() -> None:
    _tg.reset_launch_counts()
    _mm.LAUNCHES["matmul"] = 0
    for key in _fa.LAUNCHES:
        _fa.LAUNCHES[key] = 0


__all__ = ["launch_counts", "reset_launch_counts"]
