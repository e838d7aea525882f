"""RecurrentGemma / Griffin (arXiv:2402.19427) recurrent block
(counterpart of ``repro.models.recurrent``).

Structure per recurrent block:
    branch 1: W_x -> temporal Conv1D (width 4, causal, BP-im2col engine)
              -> RG-LRU
    branch 2: W_gate -> GeLU (tanh approximation, ``jax.nn.gelu``'s default)
    merge   : elementwise product -> W_out

RG-LRU recurrence (diagonal, so associative-scan friendly):
    r_t = sigmoid(W_r x_t),  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(lambda) * r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The temporal conv routes through ``repro_torch.core.depthwise_causal_conv1d``
under ``cfg.conv_engine_policy``: under ``pallas`` its three passes run the
tap kernels' depthwise variant ``dw`` (``rglru_width`` groups of one
channel).  The full-sequence recurrence is a log-depth scan in plain
PyTorch with the JAX package's combine (its ``lax.associative_scan`` is no
Pallas kernel).  Beyond the JAX block, :func:`recurrent_block` can also
return what a scan of decode steps leaves in the cache (``return_cache``),
which the one-pass prefill of ``models/model.py`` writes.

In the train step on ``tp`` blocks (``repro_torch.dist.tensor_parallel``)
each rank computes its block of the ``W`` channels (:func:`recurrent_block`).

Dtypes are the JAX package's: ``r``, ``i``, ``lam`` and the recurrence in
float32, the gate and its product with ``h`` in the activation type, the
recurrent state ``h`` float32 and the conv state in ``cfg.adtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.conv import depthwise_causal_conv1d
from repro_torch.device import resolve_device
from repro_torch.dist import tensor_parallel as TP
from repro_torch.models import layers as L

RG_C = 8.0


def rec_width(cfg: ArchConfig) -> int:
    return cfg.rglru_width or cfg.d_model


def init_recurrent(generator: torch.Generator, cfg: ArchConfig, nl=None,
                   device=None):
    """One (or ``nl`` stacked) recurrent block's parameters, drawn like the
    other layers (``layers._draw``: on the card from a CUDA generator)."""
    d, w = cfg.d_model, rec_width(cfg)

    def shape(*s):
        return s if nl is None else (nl, *s)
    return {
        "wx": L.init_linear(generator, d, w, cfg.dtype, nl, device=device),
        "wgate": L.init_linear(generator, d, w, cfg.dtype, nl,
                               device=device),
        "conv_w": {"w": L._draw(generator, shape(cfg.rglru_conv, w), 0.2,
                                cfg.dtype, device)},
        "wr": L.init_linear(generator, w, w, cfg.dtype, nl, device=device),
        "wi": L.init_linear(generator, w, w, cfg.dtype, nl, device=device),
        # softplus^-1 spread
        "lam": {"w": torch.full(shape(w), 0.65, dtype=torch.float32,
                                device=resolve_device(device))},
        "wout": L.init_linear(generator, w, d, cfg.dtype, nl,
                              scale=w ** -0.5, device=device),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _rglru_scan(x, r, i, lam):
    """Full-sequence RG-LRU.  x, r, i (B, L, W) float32, lam (W,) -> h
    (B, L, W).

    An inclusive scan of ``h_t = a_t h_{t-1} + b_t`` with the JAX
    package's combine ``((a1, b1), (a2, b2)) -> (a1 a2, b1 a2 + b2)``, by
    doubling (Hillis-Steele): after the step of shift ``s`` each position
    holds the combine of the ``2 s`` positions ending at it, so
    ``ceil(log2 L)`` steps of whole-tensor ops cover the sequence (10 at
    1,024 tokens).  No ``exp(cumsum(log a))`` closed form: ``log a``
    reaches -8.6 a step, and its running sum overflows ``exp`` in float32
    within a few dozen positions."""
    log_a = -RG_C * F.softplus(lam)[None, None, :] * r           # <= 0
    a = torch.exp(log_a)
    h = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x)
    length = x.shape[1]
    shift = 1
    while shift < length:
        h = torch.cat([h[:, :shift],
                       h[:, :-shift] * a[:, shift:] + h[:, shift:]], dim=1)
        if 2 * shift < length:
            a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]],
                          dim=1)
        shift *= 2
    return h


def recurrent_block(p, x, cfg: ArchConfig, return_cache: bool = False):
    """x (B, L, D) -> (B, L, D), full-sequence; with ``return_cache``,
    ``(y, h, conv)``: the recurrent state after the last position (B, W)
    in float32 and the last ``rglru_conv - 1`` conv inputs (B,
    rglru_conv - 1, W) in ``cfg.adtype``, zero on the left of a prompt
    shorter than that -- what a scan of decode steps leaves in the
    cache.

    Where ``p`` holds this rank's block of the channels (the train step
    under ``tp``: ``lam`` holds W / model of them), the layer computes
    its channels only: ``wx`` and ``wgate`` on ``x`` entering the block,
    the conv and the scan on its channels, the gates ``r`` and ``i`` of
    its channels from the conv output gathered whole over ``model`` (``wr``
    and ``wi`` are dense ``W x W``), and ``wout``'s rows, whose partial
    outputs are summed over ``model``; the cache is its channels'."""
    cut = TP.is_block(rec_width(cfg), p["lam"]["w"].shape[-1])
    xe = TP.enter(x) if cut else x
    xb = L.linear(p["wx"], xe)                                   # (B,L,W)
    xc = depthwise_causal_conv1d(xb, p["conv_w"]["w"],
                                 cfg.conv_engine_policy)
    xa = TP.gather(xc) if cut else xc
    r = torch.sigmoid(L.linear(p["wr"], xa).float())
    i = torch.sigmoid(L.linear(p["wi"], xa).float())
    h = _rglru_scan(xc.float(), r, i, p["lam"]["w"])
    gate = _gelu(L.linear(p["wgate"], xe))
    if cut:
        out = TP.leave(L.linear(p["wout"], (h.to(x.dtype) * gate).float()))
        out = out.to(x.dtype)
    else:
        out = L.linear(p["wout"], h.to(x.dtype) * gate)
    if not return_cache:
        return out
    conv = F.pad(xb, (0, 0, cfg.rglru_conv - 1, 0))[:, x.shape[1]:]
    return out, h[:, -1], conv.to(cfg.adtype)


def recurrent_init_state(cfg: ArchConfig, batch: int, nl: int, device=None):
    w = rec_width(cfg)
    dev = resolve_device(device)
    return {
        "h": torch.zeros((nl, batch, w), dtype=torch.float32, device=dev),
        "conv": torch.zeros((nl, batch, cfg.rglru_conv - 1, w),
                            dtype=cfg.adtype, device=dev),
    }


def recurrent_decode(p, x, h_state, conv_state, cfg: ArchConfig):
    """Single-token step.  x (B, 1, D) -> (out (B, 1, D), new h (B, W),
    new conv state (B, rglru_conv - 1, W))."""
    xb = L.linear(p["wx"], x)[:, 0]                              # (B,W)
    hist = torch.cat([conv_state, xb[:, None, :].to(conv_state.dtype)],
                     dim=1)
    w = p["conv_w"]["w"].to(hist.dtype)
    xc = torch.einsum("bkc,kc->bc", hist, w)
    new_conv_state = hist[:, 1:]
    r = torch.sigmoid(L.linear(p["wr"], xc).float())
    i = torch.sigmoid(L.linear(p["wi"], xc).float())
    a = torch.exp(-RG_C * F.softplus(p["lam"]["w"])[None] * r)
    new_h = a * h_state + torch.sqrt(torch.clamp(1 - a * a, min=1e-12)) \
        * (i * xc.float())
    gate = _gelu(L.linear(p["wgate"], x))[:, 0]
    out = L.linear(p["wout"], new_h.to(x.dtype) * gate)
    return out[:, None, :], new_h, new_conv_state
