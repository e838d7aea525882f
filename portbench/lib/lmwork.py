"""Analytic work of one LM training step.

``model_flops`` is a copy of the program's ``launch/dryrun.py::
model_flops`` for a dense model (6 operations a parameter a trained
token; recomputation not counted), with the parameters counted here from
the configuration's published sizes, not from the program's tree."""

from __future__ import annotations


def mamba2_sizes(config: dict) -> dict:
    """Derived sizes of a Mamba2 configuration file."""
    d = config["d_model"]
    di = config["expand"] * d
    heads = di // config["headdim"]
    ds = config["d_state"]
    mult = config["pad_vocab_size_multiple"]
    rows = -(-config["vocab_size"] // mult) * mult
    return {"d_model": d, "d_inner": di, "heads": heads, "d_state": ds,
            "conv_channels": di + 2 * ds, "proj_out": 2 * di + 2 * ds + heads,
            "vocab_rows": rows, "layers": config["n_layer"],
            "width": config["d_conv"],
            "gated_norm_eps": config["gated_norm_eps"]}


def mamba2_param_count(config: dict) -> int:
    s = mamba2_sizes(config)
    d, di, h = s["d_model"], s["d_inner"], s["heads"]
    per_layer = (d                          # pre-norm scale
                 + d * s["proj_out"]        # in_proj
                 + s["width"] * s["conv_channels"]  # depthwise conv
                 + 3 * h                    # A_log, dt_bias, D
                 + di                       # gated norm scale
                 + di * d)                  # out_proj
    head = 0 if config["tie_embeddings"] else s["vocab_rows"] * d
    return s["vocab_rows"] * d + d + s["layers"] * per_layer + head


def model_flops(n_params: int, tokens: int) -> float:
    """6 N tokens: a training step's forward and backward."""
    return 6.0 * n_params * tokens
