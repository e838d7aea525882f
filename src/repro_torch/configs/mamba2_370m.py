"""mamba2-370m [ssm] -- arXiv:2405.21060 (SSD, state-space duality).

48L d_model=1024 attn-free vocab=50280, ssm_state=128, expand=2 (d_inner
2048, 32 heads of 64), causal depthwise Conv1D width 4 (hosts BP-im2col).
A copy of ``repro.configs.mamba2_370m``.
"""

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,                   # d_inner / ssm_head_dim
    n_kv_heads=32,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
)

SMOKE = FULL.reduced(name="mamba2-370m-smoke", n_heads=4, n_kv_heads=4,
                     d_model=64, ssm_state=16, ssm_head_dim=32,
                     param_dtype="float32", act_dtype="float32")
