"""The work of one conv pass: operations and bytes from its shapes.

A pass is the forward, the input grad or the weight grad of one conv
layer.  Each does the same multiply-adds, ``B * H_o * W_o * N * C * taps``
per group (the input grad and the weight grad over the compact
tensors: the zero space the paper removes is not work), and each touches
the same three tensors, the input (or its grad), the kernel (or its grad)
and the output (or its grad): counted once each, read or written once.
"""

from __future__ import annotations

import dataclasses

PASSES = ("forward", "input_grad", "weight_grad")


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """A whole conv layer: ``C`` and ``N`` are the channels of one group,
    padding per side, stride per axis, no dilation."""
    B: int
    C: int
    H: int
    W: int
    N: int
    K_h: int
    K_w: int
    S_h: int
    S_w: int
    P_top: int
    P_bottom: int
    P_left: int
    P_right: int
    groups: int = 1

    @property
    def H_o(self) -> int:
        return (self.H + self.P_top + self.P_bottom - self.K_h) \
            // self.S_h + 1

    @property
    def W_o(self) -> int:
        return (self.W + self.P_left + self.P_right - self.K_w) \
            // self.S_w + 1

    def span_key(self) -> tuple:
        """What a program span's ``dims`` say of the layer (per group; no
        padding, no group count)."""
        return (self.B, self.C, self.H, self.W, self.N, self.K_h, self.K_w,
                self.S_h, self.S_w)


def square(batch: int, layer: dict) -> ConvGeometry:
    """A layer of a configuration's ``layers`` list: ``H`` (= W), ``C``,
    ``N``, ``K``, ``S``, ``P`` as in the paper's Table II."""
    h, k, s, p = layer["H"], layer["K"], layer["S"], layer["P"]
    return ConvGeometry(batch, layer["C"], h, h, layer["N"], k, k, s, s,
                        p, p, p, p)


def causal_depthwise(batch: int, length: int, channels: int,
                     width: int) -> ConvGeometry:
    """A causal depthwise conv over a sequence, as a conv over a plane of
    one row: ``channels`` groups of one channel, ``width - 1`` zeros on
    the left."""
    return ConvGeometry(batch, 1, 1, length, 1, 1, width, 1, 1, 0, 0,
                        width - 1, 0, channels)


def span_key(dims: dict) -> tuple:
    """The key of a program span's ``dims`` annotation."""
    return tuple(int(dims[k]) for k in ("B", "C", "H_i", "W_i", "N", "K_h",
                                        "K_w", "s_h", "s_w"))


def macs(g: ConvGeometry) -> int:
    return g.groups * g.B * g.H_o * g.W_o * g.N * g.C * g.K_h * g.K_w


def pass_flops(g: ConvGeometry) -> int:
    """Operations of one pass (2 per multiply-add); the same for each of
    the three passes."""
    return 2 * macs(g)


def pass_bytes(g: ConvGeometry, itemsize: int) -> int:
    """Bytes of one pass: input, kernel and output, each once."""
    x = g.groups * g.B * g.C * g.H * g.W
    w = g.groups * g.N * g.C * g.K_h * g.K_w
    y = g.groups * g.B * g.N * g.H_o * g.W_o
    return (x + w + y) * itemsize


def conv_roofline(spans: list[dict], layers: dict, device_s: float):
    """The share (%) of the roofline that the device time of the conv
    spans reaches: the sum over the spans of each pass's bound, over
    ``device_s``, the device time of every kernel launched inside them.
    ``layers`` maps a span key to ``(geometry, dtype name)``.  None when
    there is nothing to read; raises on a span of a layer ``layers`` does
    not hold."""
    from portbench.lib.peaks import ITEMSIZE, bound_s
    if not spans or device_s <= 0:
        return None
    total = 0.0
    for s in spans:
        key = span_key(s["args"]["dims"])
        if key not in layers:
            raise KeyError(f"a conv span of an unknown layer: {key}")
        g, dtype = layers[key]
        total += bound_s(pass_flops(g), pass_bytes(g, ITEMSIZE[dtype]),
                         dtype)
    return 100.0 * total / device_s
