"""hubert-xlarge [audio] -- arXiv:2106.07447 (encoder-only, w2v2 arch).

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.  The waveform conv
feature encoder is a stub: the batch carries precomputed frame embeddings
of width ``d_frontend=512``, which a linear projector (``frontend_proj``)
maps to the model width.  Encoder-only: bidirectional attention, no decode.
A copy of ``repro.configs.hubert_xlarge``.
"""

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    attn_kind="bidir",
    frontend="audio",
    d_frontend=512,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
)

SMOKE = FULL.reduced(name="hubert-xlarge-smoke",
                     param_dtype="float32", act_dtype="float32")
