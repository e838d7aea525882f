"""recurrentgemma-9b [hybrid] -- arXiv:2402.19427 (Griffin).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; RG-LRU recurrent
blocks + local attention, pattern 2 recurrent : 1 attention, window 2048.
Temporal Conv1D (width 4) inside each recurrent block hosts the paper's
BP-im2col conv engine.  A copy of ``repro.configs.recurrentgemma_9b``.
"""

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    layer_pattern=("rec", "rec", "attn"),
    local_window=2048,
    rglru_conv=4,
    rglru_width=4096,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
)

SMOKE = FULL.reduced(name="recurrentgemma-9b-smoke", rglru_width=64,
                     param_dtype="float32", act_dtype="float32")
