"""``conv_roofline.<family>``: the share (%) of their roofline that the
conv passes' kernels reach in the traced stretch (``.cnn`` over the conv
cells' layers, ``.lm`` over a language model's depthwise convs).

The bound of each pass the program's ``conv:*`` spans ran (the larger of
its operations over the peak and its bytes, each operand once, over
3.35 TB/s; ``lib/convwork.py``), summed, over the device time of every
device operation launched inside those spans (``lib/profile.py``),
whichever kernels the program uses for them.  Read from the stretch
traced with the host (``run.py``)."""

from portbench.lib.convwork import conv_roofline


def read(ctx):
    if ctx.spans_stretch is None:
        return None
    return conv_roofline(ctx.conv_spans, ctx.cell.conv_layers(),
                         ctx.spans_stretch.conv_device_s)
