"""PyTorch/CUDA port of BP-im2col for one NVIDIA H100.

Beside the JAX package ``repro`` (the reference), this package runs the
paper's training scenario -- a strided CNN whose three conv passes run the
BP-im2col tap-GEMM datapath -- and the paper's baseline engines
(``traditional``, ``bp_im2col``), transposed convs and Mamba2's depthwise
causal conv, with hand-written CUDA kernels (``csrc/tap_gemm.cu``,
``csrc/matmul.cu``), and serves and trains the LM families ported so far
(``csrc/flash_attention.cu``).  It imports
neither ``jax`` nor ``repro``.
"""

from repro_torch.core import (ConvDims, ConvSpec, ConvTransposeSpec,
                              EnginePolicy, conv1d, conv1d_causal, conv2d,
                              conv2d_transpose, conv_policy,
                              depthwise_causal_conv1d, dispatch_events,
                              policy_decisions, reset_dispatch_events)
from repro_torch.device import resolve_device

__all__ = ["ConvDims", "ConvSpec", "ConvTransposeSpec", "EnginePolicy",
           "conv1d", "conv1d_causal", "conv2d", "conv2d_transpose",
           "conv_policy", "depthwise_causal_conv1d", "dispatch_events",
           "policy_decisions", "reset_dispatch_events", "resolve_device"]
