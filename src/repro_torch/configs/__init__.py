"""The paper's conv workloads, and the LM configs of the serving path.

``get_config(name)``/``get_smoke_config(name)`` know SmolLM-360M only: the
other architectures of the JAX package come with their families (ROADMAP
A10) and raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

from repro_torch.configs import smollm_360m
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.paper_cnn import (BATCH, NETWORKS, TABLE2_LAYERS,
                                           dims, table2_dims)

_ARCHS = {"smollm-360m": smollm_360m, "smollm_360m": smollm_360m}


def _module(name: str):
    if name not in _ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet: the port serves "
            f"smollm-360m only; the other families come with ROADMAP A10")
    return _ARCHS[name]


def get_config(name: str) -> ArchConfig:
    return _module(name).FULL


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).SMOKE


__all__ = ["ArchConfig", "BATCH", "NETWORKS", "TABLE2_LAYERS", "dims",
           "get_config", "get_smoke_config", "table2_dims"]
