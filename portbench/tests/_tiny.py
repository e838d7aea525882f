"""Cells of the benchmark cut to CPU size for the tests: the same
configuration and traffic files, with their sizes replaced."""

from __future__ import annotations

import copy

from portbench.lib import bench

CONV_LAYERS = [
    {"name": "k3s2", "H": 9, "C": 3, "N": 5, "K": 3, "S": 2, "P": 1},
    {"name": "k1s2", "H": 8, "C": 6, "N": 8, "K": 1, "S": 2, "P": 0},
    {"name": "k7s2", "H": 12, "C": 2, "N": 4, "K": 7, "S": 2, "P": 3},
]

LM_SIZES = {"d_model": 64, "n_layer": 2, "vocab_size": 250,
            "pad_vocab_size_multiple": 16, "d_state": 16, "headdim": 32}


def tiny(cell: bench.Cell) -> bench.Cell:
    """``cell`` at a size a CPU test run holds."""
    c = copy.deepcopy(cell)
    if c.config["entry"] == "conv_layers":
        c.config["layers"] = CONV_LAYERS
        c.traffic = dict(c.traffic, batch=4, warmup_steps=1, trace_steps=2,
                         enqueue_steps=2)
    else:
        c.config.update(LM_SIZES)
        c.traffic = dict(c.traffic, batch=4, seq=128, trace_steps=1)
    return c


def cell(name: str) -> bench.Cell:
    return tiny(bench.resolve(name))
