"""Conv geometry, engine policy, the per-pass dispatching ``conv2d`` and
``conv2d_transpose`` (with the 1-D and depthwise causal wrappers), and
their static reports.  The runtime configuration
is ``repro_torch.core.config.config``."""

from repro_torch.core.convspec import (AUTO, PASSES, ConvSpec,
                                       ConvTransposeSpec, EnginePolicy)
from repro_torch.core.conv import (ENGINES, conv1d, conv1d_causal, conv2d,
                                   conv2d_transpose,
                                   conv2d_transpose_materialized,
                                   conv_plan_report, conv_policy,
                                   depthwise_causal_conv1d,
                                   dispatch_events, make_dims, output_shape,
                                   policy_decisions, policy_report,
                                   register_engine, reset_dispatch_events,
                                   resolve_engine, resolve_policy,
                                   spec_dims, transpose_dims)
from repro_torch.core.im2col_ref import ConvDims

__all__ = ["AUTO", "PASSES", "ConvSpec", "ConvTransposeSpec",
           "EnginePolicy", "ENGINES", "conv1d", "conv1d_causal", "conv2d",
           "conv2d_transpose", "conv2d_transpose_materialized",
           "conv_plan_report", "conv_policy", "depthwise_causal_conv1d",
           "dispatch_events", "make_dims", "output_shape",
           "policy_decisions", "policy_report", "register_engine",
           "reset_dispatch_events", "resolve_engine", "resolve_policy",
           "spec_dims", "transpose_dims", "ConvDims"]
