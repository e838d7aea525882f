"""Distributed substrate: sharding rules, activation constraints, and
mesh-parallel conv lowerings (counterpart of ``repro.dist``)."""

from repro_torch.dist import sharding
from repro_torch.dist import conv_parallel
from repro_torch.dist.constraints import constrain_batch, set_activation_policy
from repro_torch.dist.conv_parallel import ConvParallel, conv_mesh

__all__ = ["sharding", "conv_parallel", "constrain_batch",
           "set_activation_policy", "ConvParallel", "conv_mesh"]
