"""deepseek-v3-671b [moe] -- arXiv:2412.19437 / hf:deepseek-ai/DeepSeek-V3.

61L d_model=7168 128H d_ff(moe expert)=2048 vocab=129280, MoE 1 shared + 256
routed top-8, MLA (q_lora 1536, kv_lora 512, nope 128, rope 64, v 128), MTP.
First 3 layers dense (d_ff 18432).  A copy of
``repro.configs.deepseek_v3_671b``.  No one card holds the 61 layers; the
port serves its first layers at these widths (``dataclasses.replace`` of
``n_layers``).
"""

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,                 # qk = nope 128 + rope 64
    d_ff=18432,                   # dense layers
    vocab=129280,
    n_experts=256,
    n_shared_experts=1,
    moe_top_k=8,
    moe_d_ff=2048,
    first_dense_layers=3,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mtp_depth=1,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
)

SMOKE = FULL.reduced(name="deepseek-v3-671b-smoke",
                     param_dtype="float32", act_dtype="float32")
