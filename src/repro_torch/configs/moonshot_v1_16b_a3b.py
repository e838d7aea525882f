"""moonshot-v1-16b-a3b [moe] -- hf:moonshotai/Moonlight-16B-A3B.

48L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=163840, 64 routed experts
top-6 + 2 shared, first layer dense (d_ff 11264), untied head.  A copy of
``repro.configs.moonshot_v1_16b_a3b``: at these widths the model holds
28,386,592,768 parameters (the name's "16B" counts fewer).
"""

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=11264,                   # dense first layer
    vocab=163840,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
)

SMOKE = FULL.reduced(name="moonshot-v1-16b-a3b-smoke",
                     param_dtype="float32", act_dtype="float32")
