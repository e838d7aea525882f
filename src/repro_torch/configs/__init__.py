"""The paper's conv workloads, and the LM configs of the serving path.

``get_config(name)``/``get_smoke_config(name)`` know the dense SmolLM-360M,
the MoE family (moonshot-v1-16b-a3b; deepseek-v3-671b, with MLA), the
SSM family (mamba2-370m) and the hybrid family (recurrentgemma-9b), by
the JAX package's module names and their dashed aliases: the other
architectures of the JAX package (the remaining dense configs, the VLM
and audio families) come with ROADMAP A10 and raise
``NotImplementedError`` until then.
"""

from __future__ import annotations

from repro_torch.configs import (deepseek_v3_671b, mamba2_370m,
                                 moonshot_v1_16b_a3b, recurrentgemma_9b,
                                 smollm_360m)
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.paper_cnn import (BATCH, NETWORKS, TABLE2_LAYERS,
                                           dims, table2_dims)

_ARCHS = {alias: mod
          for mod in (deepseek_v3_671b, mamba2_370m, moonshot_v1_16b_a3b,
                      recurrentgemma_9b, smollm_360m)
          for alias in (mod.FULL.name, mod.__name__.rsplit(".", 1)[1])}


def _module(name: str):
    if name not in _ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet: the port serves "
            f"{', '.join(sorted(a for a in _ARCHS if '-' in a))}; the other "
            f"configs come with ROADMAP A10")
    return _ARCHS[name]


def get_config(name: str) -> ArchConfig:
    return _module(name).FULL


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).SMOKE


__all__ = ["ArchConfig", "BATCH", "NETWORKS", "TABLE2_LAYERS", "dims",
           "get_config", "get_smoke_config", "table2_dims"]
