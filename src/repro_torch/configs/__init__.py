"""The paper's conv workloads, and the LM configs of the serving path.

``get_config(name)``/``get_smoke_config(name)`` know every architecture
of the JAX package (``repro.configs.ARCH_IDS``): the dense family
(smollm-360m, granite-3-8b, minicpm-2b, phi4-mini-3.8b), the MoE family
(moonshot-v1-16b-a3b; deepseek-v3-671b, with MLA), the SSM family
(mamba2-370m), the hybrid family (recurrentgemma-9b), the VLM
(internvl2-76b) and the audio encoder (hubert-xlarge), by module name,
config name and the module name dashed (``phi4-mini-3-8b`` beside
``phi4-mini-3.8b``), as the JAX package's ``ALIASES``.  A name neither
knows raises ``NotImplementedError``.
"""

from __future__ import annotations

from repro_torch.configs import (deepseek_v3_671b, granite_3_8b,
                                 hubert_xlarge, internvl2_76b, mamba2_370m,
                                 minicpm_2b, moonshot_v1_16b_a3b,
                                 phi4_mini_3_8b, recurrentgemma_9b,
                                 smollm_360m)
from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeCfg,
                                      applicable_shapes)
from repro_torch.configs.paper_cnn import (BATCH, NETWORKS, TABLE2_LAYERS,
                                           dims, table2_dims)

_MODULES = (deepseek_v3_671b, moonshot_v1_16b_a3b, recurrentgemma_9b,
            internvl2_76b, smollm_360m, phi4_mini_3_8b, minicpm_2b,
            granite_3_8b, hubert_xlarge, mamba2_370m)

#: the architectures, by module name, in the JAX package's order.
ARCH_IDS = [mod.__name__.rsplit(".", 1)[1] for mod in _MODULES]

_ARCHS = {alias: mod
          for mod in _MODULES
          for module in (mod.__name__.rsplit(".", 1)[1],)
          for alias in (mod.FULL.name, module, module.replace("_", "-"))}


def _module(name: str):
    if name not in _ARCHS:
        raise NotImplementedError(
            f"unknown architecture {name!r}: the port knows "
            f"{', '.join(sorted(set(m.FULL.name for m in _ARCHS.values())))}")
    return _ARCHS[name]


def get_config(name: str) -> ArchConfig:
    return _module(name).FULL


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).SMOKE


def all_arch_ids() -> list[str]:
    return list(ARCH_IDS)


__all__ = ["ARCH_IDS", "ArchConfig", "BATCH", "NETWORKS", "SHAPES",
           "ShapeCfg", "TABLE2_LAYERS", "all_arch_ids", "applicable_shapes",
           "dims", "get_config", "get_smoke_config", "table2_dims"]
