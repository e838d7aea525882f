"""The hand-written CUDA tap-GEMM kernels (``tap_gemm``), their plain
versions (``ref``), the build (``build``) and the kernel engine's conv
passes (``ops``)."""

from repro_torch.kernels.tap_gemm import (LAUNCHES, launch_counts,
                                          reset_launch_counts)

__all__ = ["LAUNCHES", "launch_counts", "reset_launch_counts"]
