"""Architecture configuration of the port's LM path.

PyTorch-package copy of ``repro.configs.base.ArchConfig`` with the fields
the dense GQA family reads (the port imports nothing of the JAX package).
``dtype``/``adtype`` are torch dtypes.  ``reduced()`` derives the
CPU-scale smoke variant from the full config as the JAX package does.

The JAX config's ``attn_impl`` is left out: the port does not choose
attention by a flag (every full-sequence causal call on the card runs the
flash-attention kernel).  Fields of the other families (MoE, MLA ranks,
SSM, RG-LRU, frontends) and the conv policy come with them (ROADMAP A10);
``local_window`` and ``use_mla`` stay so that such a config is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense (the only family ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    attn_kind: str = "causal"         # causal | bidir (encoder-only)
    local_window: Optional[int] = None
    rope_theta: float = 10000.0
    use_mla: bool = False
    param_dtype: str = "float32"
    act_dtype: str = "float32"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    remat: str = "block"              # none | block (training only)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.act_dtype)

    @property
    def is_encoder_only(self) -> bool:
        return self.attn_kind == "bidir"

    def reduced(self, **overrides) -> "ArchConfig":
        """CPU-scale variant preserving family structure (the same widths
        as ``repro.configs.base.ArchConfig.reduced``)."""
        base = dict(
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4
                                  // max(self.n_heads, 1))),
            head_dim=16,
            d_ff=128,
            vocab=256,
        )
        if self.local_window:
            base.update(local_window=32)
        base.update(overrides)
        return dataclasses.replace(self, **base)
