"""``mfu.<family>``: the step's share (%) of the chip's peak.

The cell's analytic operations a step (``flops_per_step`` of its
driver: for the conv cells 2 per multiply-add of every pass of every
layer, ``lib/convwork.py``; for a language model ``6 N tokens``,
``lib/lmwork.py``, the program's ``model_flops`` copied, recomputation
not counted) times the window's steps, over the window's seconds and the
peak for the configuration's type (``lib/peaks.py``: 495 TFLOP/s for
float32, 989 for bfloat16)."""

from portbench.lib.peaks import FLOPS


def read(ctx):
    if ctx.window["seconds"] <= 0:
        return None
    flops = ctx.cell.flops_per_step() * ctx.window["steps"]
    return 100.0 * flops / ctx.window["seconds"] \
        / FLOPS[ctx.cell.config["dtype"]]
