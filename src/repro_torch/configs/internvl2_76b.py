"""internvl2-76b [vlm] -- arXiv:2404.16821.

LLM backbone: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The vision encoder (InternViT-6B) is a stub: the batch carries 256
precomputed patch embeddings of width ``d_frontend=3200``, which a linear
projector (``frontend_proj``) maps into the LM sequence ahead of the text.
A copy of ``repro.configs.internvl2_76b``.
"""

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    frontend="vision",
    d_frontend=3200,
    frontend_tokens=256,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
)

SMOKE = FULL.reduced(name="internvl2-76b-smoke",
                     param_dtype="float32", act_dtype="float32")
