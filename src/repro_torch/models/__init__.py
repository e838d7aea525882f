"""Model layers of the port, the conv autoencoder, and the dense LM
(``attention``, ``transformer``, ``model``)."""

from repro_torch.models.layers import (conv2d_apply, conv2d_transpose_apply,
                                       init_conv2d, init_conv2d_transpose)

__all__ = ["conv2d_apply", "conv2d_transpose_apply", "init_conv2d",
           "init_conv2d_transpose"]
