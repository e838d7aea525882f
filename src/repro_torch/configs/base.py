"""Architecture configuration of the port's LM path.

PyTorch-package copy of ``repro.configs.base.ArchConfig``, field for
field (the port imports nothing of the JAX package): GQA or MLA
attention, Mamba2's SSD block, the RG-LRU block and the (rec, rec, attn)
layer pattern with its local attention window, the VLM and audio
families' frontend stubs (``frontend``, ``d_frontend``,
``frontend_tokens``), and the per-pass conv engine policy of the model's
convs (``conv_policy``, with the deprecated ``conv_mode``).  ``dtype``/
``adtype`` are torch dtypes.  ``reduced()`` derives the CPU-scale smoke
variant from the full config as the JAX package does, MoE, MLA, SSM,
window and frontend overrides included.

``attn_impl`` is carried for parity and read by nothing, as in the JAX
package, whose models never read it either: attention is chosen by the
call (``repro_torch.models.attention._sdpa``: a full-sequence call that
no gradient flows through and no window masks runs the flash-attention
kernel).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | vlm | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    attn_kind: str = "causal"         # causal | bidir (encoder-only)
    local_window: Optional[int] = None
    # hybrid: the repeating block pattern, e.g. ("rec", "rec", "attn")
    layer_pattern: Optional[tuple[str, ...]] = None
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0       # deepseek-v3: first k layers stay dense
    capacity_factor: float = 1.25
    # MLA (deepseek-v3)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0                # multi-token-prediction extra blocks
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # recurrent (RG-LRU / Griffin)
    rglru_conv: int = 4
    rglru_width: int = 0              # recurrent block width (defaults d_model)
    # modality frontend stubs
    frontend: Optional[str] = None    # vision | audio
    d_frontend: int = 0
    frontend_tokens: int = 0
    param_dtype: str = "float32"
    act_dtype: str = "float32"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # Per-pass conv backprop engine selection (the paper): an EnginePolicy
    # string -- "auto", a uniform engine name, or
    # "fwd=...,dgrad=...,wgrad=..." (repro_torch.core.EnginePolicy.parse).
    conv_policy: str = "auto"
    # DEPRECATED: the old uniform engine knob.  When set it wins over
    # conv_policy (mapped to a uniform EnginePolicy) with a warning.
    conv_mode: Optional[str] = None
    attn_impl: str = "xla"            # xla | flash; read by nothing
    remat: str = "block"              # none | block (training only)

    @property
    def conv_engine_policy(self) -> str:
        """The effective conv EnginePolicy string: ``conv_mode`` (deprecated,
        uniform) when set, else ``conv_policy``.  Model code reads this."""
        if self.conv_mode is not None:
            warnings.warn(
                "ArchConfig.conv_mode is deprecated; set conv_policy "
                "(e.g. conv_policy=\"fwd=pallas,dgrad=auto,wgrad=bp_phase\" "
                "or a uniform engine name) instead",
                DeprecationWarning, stacklevel=2)
            return self.conv_mode
        return self.conv_policy

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.act_dtype)

    @property
    def is_encoder_only(self) -> bool:
        return self.attn_kind == "bidir"

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs only: SSM + hybrid (local attention window)."""
        return self.family in ("ssm", "hybrid")

    def layer_kind(self, i: int) -> str:
        """'attn' | 'rec' | 'ssm' for block i."""
        if self.family == "ssm":
            return "ssm"
        if self.layer_pattern:
            return self.layer_pattern[i % len(self.layer_pattern)]
        return "attn"

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and i >= self.first_dense_layers

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
        if self.n_experts:
            base.update(n_experts=8, moe_top_k=min(2, self.moe_top_k),
                        n_shared_experts=min(1, self.n_shared_experts),
                        moe_d_ff=64,
                        first_dense_layers=min(1, self.first_dense_layers))
        if self.use_mla:
            base.update(q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
                        qk_rope_head_dim=8, v_head_dim=16, head_dim=24)
        if self.ssm_state:
            base.update(ssm_state=16, ssm_head_dim=16)
        if self.local_window:
            base.update(local_window=32)
        if self.frontend:
            base.update(d_frontend=32, frontend_tokens=8)
        if self.mtp_depth:
            base.update(mtp_depth=1)
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    """One production workload shape of the dry run
    (``repro_torch.launch.dryrun``)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode | long_decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "long_decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """The shapes an architecture runs: an encoder-only model has no
    decode step, and the 500k-token decode needs sub-quadratic attention
    (the SSM and hybrid families)."""
    out = ["train_4k", "prefill_32k"]
    if not cfg.is_encoder_only:
        out.append("decode_32k")
        if cfg.supports_long_context:
            out.append("long_500k")
    return out
