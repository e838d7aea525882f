"""The hand-written CUDA kernels (``tap_gemm``, ``matmul``), their plain
versions (``ref``), the build (``build``) and the kernel engine's conv
passes (``ops``).  :func:`launch_counts` gathers every wrapper's count."""

from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import tap_gemm as _tg


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel name, across every wrapper module."""
    return {**_tg.LAUNCHES, **_mm.LAUNCHES}


def reset_launch_counts() -> None:
    _tg.reset_launch_counts()
    _mm.LAUNCHES["matmul"] = 0


__all__ = ["launch_counts", "reset_launch_counts"]
