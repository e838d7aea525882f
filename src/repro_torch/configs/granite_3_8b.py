"""granite-3-8b [dense] -- hf:ibm-granite/granite-3.0-8b-base.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.  A copy of
``repro.configs.granite_3_8b``.
"""

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab=49155,
    tie_embeddings=True,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
)

SMOKE = FULL.reduced(name="granite-3-8b-smoke",
                     param_dtype="float32", act_dtype="float32")
