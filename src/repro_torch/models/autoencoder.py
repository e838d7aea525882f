"""Conv autoencoder: a strided conv encoder and a transposed-conv decoder.

Counterpart of the autoencoder in ``repro.models.model``.  Every
upsampling layer of the decoder goes through ``conv2d_transpose``, so the
decoder's forward is the paper's transposed mode running as a forward
pass: one ``tap_gemm_phased`` launch per layer under ``pallas``, the
physically zero-inserted input and an explicit GEMM on ``matmul`` under
``traditional``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    """A small conv -> conv_transpose autoencoder.  Carries
    ``conv_policy``, the field ``make_train_step`` reads."""

    name: str = "conv_autoencoder"
    c_in: int = 3
    widths: tuple[int, ...] = (16, 32)    # encoder channel widths, stride 2
    k: int = 3
    param_dtype: str = "float32"
    conv_policy: str = "auto"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


def init_autoencoder(generator: torch.Generator, cfg: AutoencoderConfig,
                     device=None):
    """Params ``{"enc": [...], "dec": [...]}``: per-stage encoder convs
    (stride 2) and the mirror decoder transposed convs (stride 2,
    output_padding 1: exact 2x upsampling of even planes), drawn in the
    JAX package's order from ``generator`` on the CPU, then moved to
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    chans = (cfg.c_in, *cfg.widths)
    n = len(cfg.widths)
    enc = [L.init_conv2d(generator, chans[i], chans[i + 1], cfg.k, cfg.dtype,
                         device=dev) for i in range(n)]
    dec = [L.init_conv2d_transpose(generator, chans[i + 1], chans[i], cfg.k,
                                   cfg.dtype, device=dev)
           for i in reversed(range(n))]
    return {"enc": enc, "dec": dec}


def autoencoder_apply(params, x: torch.Tensor, cfg: AutoencoderConfig,
                      policy=None) -> torch.Tensor:
    """x (B, C, H, W) -> reconstruction (B, C, H, W); H and W must be
    divisible by 2**len(widths).  ``policy`` defaults to the config's."""
    policy = policy if policy is not None else cfg.conv_policy
    pad = cfg.k // 2
    h = x
    for p in params["enc"]:
        h = F.relu(L.conv2d_apply(p, h, stride=2, padding=pad,
                                  policy=policy))
    for i, p in enumerate(params["dec"]):
        h = L.conv2d_transpose_apply(p, h, stride=2, padding=pad,
                                     output_padding=1, policy=policy)
        if i < len(params["dec"]) - 1:
            h = F.relu(h)
    return h


def autoencoder_loss(params, batch, cfg: AutoencoderConfig):
    """Reconstruction MSE over ``batch["image"]``: the ``loss=`` plugin
    for ``make_train_step``; returns ``(loss, metrics)``."""
    x = batch["image"]
    x_hat = autoencoder_apply(params, x, cfg)
    mse = torch.mean(torch.square(x_hat.float() - x.float()))
    return mse, {"mse": mse, "loss": mse}
