"""The three passes of a conv layer in plain float32 PyTorch.

``torch.nn.functional.conv2d`` and its two grads (``torch.nn.grad``),
with TF32 off for the call, so every product and sum is float32.  With
``precision`` the operands are first rounded to a lower precision
(``lib.precision``): the control, which computes the same passes in TF32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from portbench.lib.precision import BITS, round_mantissa


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def passes(x, w, dy, stride: int, padding: int,
           precision: str | None = None):
    """``(y, dx, dw)`` of ``conv2d(x, w)`` (NCHW, OIHW, one group) and its
    grads at the upstream grad ``dy``."""
    if precision is not None:
        x, w, dy = (round_mantissa(t.float(), BITS[precision])
                    for t in (x, w, dy))
    with no_tf32(), torch.no_grad():
        y = F.conv2d(x, w, stride=stride, padding=padding)
        dx = torch.nn.grad.conv2d_input(x.shape, w, dy, stride=stride,
                                        padding=padding)
        dw = torch.nn.grad.conv2d_weight(x, w.shape, dy, stride=stride,
                                         padding=padding)
    return y, dx, dw
