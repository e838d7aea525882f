"""phi4-mini-3.8b [dense] -- arXiv:2412.08905.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064; RoPE + SwiGLU + GQA,
untied head.  A copy of ``repro.configs.phi4_mini_3_8b``.
"""

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=200064,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
)

SMOKE = FULL.reduced(name="phi4-mini-3.8b-smoke",
                     param_dtype="float32", act_dtype="float32")
