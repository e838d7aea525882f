"""Model layers of the port."""

from repro_torch.models.layers import conv2d_apply, init_conv2d

__all__ = ["conv2d_apply", "init_conv2d"]
