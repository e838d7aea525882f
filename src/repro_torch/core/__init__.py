"""Conv geometry, engine policy and the per-pass dispatching ``conv2d`` and
``conv2d_transpose``."""

from repro_torch.core.convspec import (AUTO, PASSES, ConvSpec,
                                       ConvTransposeSpec, EnginePolicy)
from repro_torch.core.conv import (ENGINES, conv2d, conv2d_transpose,
                                   conv2d_transpose_materialized,
                                   conv_policy, dispatch_events, make_dims,
                                   policy_decisions, register_engine,
                                   reset_dispatch_events, resolve_engine,
                                   resolve_policy, spec_dims, transpose_dims)
from repro_torch.core.im2col_ref import ConvDims

__all__ = ["AUTO", "PASSES", "ConvSpec", "ConvTransposeSpec",
           "EnginePolicy", "ENGINES", "conv2d", "conv2d_transpose",
           "conv2d_transpose_materialized", "conv_policy",
           "dispatch_events", "make_dims", "policy_decisions",
           "register_engine", "reset_dispatch_events", "resolve_engine",
           "resolve_policy", "spec_dims", "transpose_dims", "ConvDims"]
