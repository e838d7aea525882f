"""smollm-360m [dense] -- hf:HuggingFaceTB/SmolLM-360M (llama arch).

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.  A copy of
``repro.configs.smollm_360m``.
"""

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab=49152,
    tie_embeddings=True,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
)

SMOKE = FULL.reduced(name="smollm-360m-smoke", n_heads=3, n_kv_heads=1,
                     param_dtype="float32", act_dtype="float32")
