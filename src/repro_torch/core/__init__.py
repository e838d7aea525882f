"""Conv geometry, engine policy and the per-pass dispatching ``conv2d``."""

from repro_torch.core.convspec import AUTO, PASSES, ConvSpec, EnginePolicy
from repro_torch.core.conv import (ENGINES, conv2d, conv_policy,
                                   dispatch_events, make_dims,
                                   policy_decisions, register_engine,
                                   reset_dispatch_events, resolve_engine,
                                   resolve_policy, spec_dims)
from repro_torch.core.im2col_ref import ConvDims

__all__ = ["AUTO", "PASSES", "ConvSpec", "EnginePolicy", "ENGINES",
           "conv2d", "conv_policy", "dispatch_events", "make_dims",
           "policy_decisions", "register_engine", "reset_dispatch_events",
           "resolve_engine", "resolve_policy", "spec_dims", "ConvDims"]
