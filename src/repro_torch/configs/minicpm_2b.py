"""minicpm-2b [dense] -- arXiv:2404.06395 (llama-like; trained with WSD).

40L d_model=2304 36H (kv=36, MHA) d_ff=5760 vocab=122753.  The WSD
(warmup-stable-decay) schedule is ``repro_torch.optim.schedule.wsd``, the
launcher's default for this arch.  A copy of ``repro.configs.minicpm_2b``.
"""

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab=122753,
    tie_embeddings=True,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
)

SMOKE = FULL.reduced(name="minicpm-2b-smoke", n_heads=4, n_kv_heads=4,
                     param_dtype="float32", act_dtype="float32")
