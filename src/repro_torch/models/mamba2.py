"""Mamba2 (SSD, arXiv:2405.21060) block: chunked state-space duality
(counterpart of ``repro.models.mamba2``).

Training and prefill use the chunked SSD algorithm: a within-chunk
quadratic (attention-like) term plus an across-chunk linear state
recurrence, so memory is O(L*Q + L/Q * state) instead of O(L * state) for
the naive scan.  Decode is the O(1) recurrent update.  The inter-chunk
recurrence is a Python loop over the chunks where the JAX package has
``lax.scan``.

Beyond the JAX block, :func:`_ssd_chunked` takes any length: a ragged last
chunk is padded with positions whose ``dt`` is 0 (applied after the
softplus), which neither decay the state nor add to it, and it returns the
final state.  With it :func:`mamba2_block` can also return the cache a
scan of decode steps would build (``return_cache``: the final SSM state
and the last ``ssm_conv - 1`` conv inputs), which the one-pass prefill of
``models/model.py`` writes.

The causal depthwise Conv1D (width ``ssm_conv``) routes through
``repro_torch.core.depthwise_causal_conv1d`` under ``cfg.conv_engine_policy``:
under ``pallas`` its three passes run the hand-written tap kernels.

Dtypes are the JAX package's: the SSM state is in ``cfg.adtype``, the
attention-like term is float32 cast to the activation type, ``dt`` and
``a_log`` are float32.  The intra-chunk decay is masked before its ``exp``
(``exp(-inf) = 0``) where the JAX block masks after it: the same values,
and no ``0 * inf`` in the gradient where the unmasked decay overflows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import config
from repro_torch.core.conv import depthwise_causal_conv1d
from repro_torch.device import resolve_device
from repro_torch.dist import tensor_parallel as TP
from repro_torch.models import layers as L


def __getattr__(name):
    # The deprecated alias of the JAX package's old module constant: the
    # SSD chunk length lives at config.ssd_chunk (read per call).
    if name == "CHUNK":
        return config.ssd_chunk
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_heads(cfg: ArchConfig) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def init_mamba2(generator: torch.Generator, cfg: ArchConfig, nl=None,
                device=None):
    """One (or ``nl`` stacked) Mamba2 layer's parameters, drawn like the
    other layers (``layers._draw``: on the card from a CUDA generator)."""
    di, h, ds = d_inner(cfg), n_heads(cfg), cfg.ssm_state
    dev = resolve_device(device)

    def shape(*s):
        return s if nl is None else (nl, *s)
    # in_proj packs [z, x, B, C, dt]
    proj_out = 2 * di + 2 * ds + h
    return {
        "in_proj": L.init_linear(generator, cfg.d_model, proj_out, cfg.dtype,
                                 nl, device=device),
        "conv_w": {"w": L._draw(generator, shape(cfg.ssm_conv, di + 2 * ds),
                                0.2, cfg.dtype, device)},
        "a_log": {"w": torch.zeros(shape(h), dtype=torch.float32,
                                   device=dev)},
        "dt_bias": {"w": torch.zeros(shape(h), dtype=torch.float32,
                                     device=dev)},
        "d_skip": {"w": torch.ones(shape(h), dtype=torch.float32,
                                   device=dev)},
        "norm": L.init_rmsnorm(di, cfg.dtype, nl, device),
        "out_proj": L.init_linear(generator, di, cfg.d_model, cfg.dtype, nl,
                                  scale=di ** -0.5, device=device),
    }


def _ssd_chunked(xh, dt, a_log, B, C):
    """Chunked SSD: ``(y, state)``.

    xh (B,L,H,P)  dt (B,L,H)  a_log (H,)  B,C (B,L,S)  ->  y (B,L,H,P) and
    the state after position L - 1, (B,H,P,S) in ``xh``'s type.  The chunk
    is ``min(config.ssd_chunk, L)``; a ragged last chunk is padded with
    ``dt = 0`` positions (no decay, no update), whose outputs are dropped.
    """
    b, l, h, p = xh.shape
    s = B.shape[-1]
    # SSD chunk length: intra-chunk (quadratic) work scales ~Q per token,
    # the inter-chunk state recurrence ~1/Q.
    q = min(config.ssd_chunk, l)
    nc = -(-l // q)
    pad = nc * q - l
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))

    la = dt * (-torch.exp(a_log))[None, None, :]             # log a_t (B,L,H)
    la = la.reshape(b, nc, q, h)
    dt_r = dt.reshape(b, nc, q, h)
    xr = xh.reshape(b, nc, q, h, p)
    Br = B.reshape(b, nc, q, s)
    Cr = C.reshape(b, nc, q, s)
    cum = torch.cumsum(la, dim=2)                            # (B,nc,Q,H)

    # ---- intra-chunk (quadratic within chunk) ----
    cb = torch.einsum("bnis,bnjs->bnij", Cr, Br)             # (B,nc,Q,Q)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Qi,Qj,H)
    mask = torch.ones(q, q, dtype=torch.bool, device=xh.device).tril()
    att = torch.exp(decay.masked_fill(~mask[None, None, :, :, None],
                                      float("-inf")))
    att = att * cb[..., None] * dt_r[:, :, None, :, :]       # (B,nc,Qi,Qj,H)
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", att.to(xr.dtype), xr)

    # ---- chunk states & inter-chunk recurrence ----
    last = cum[:, :, -1:, :]                                 # (B,nc,1,H)
    state_w = torch.exp(last - cum) * dt_r                   # (B,nc,Q,H)
    states = torch.einsum("bnqs,bnqh,bnqhp->bnhps",
                          Br, state_w.to(xr.dtype), xr)      # (B,nc,H,P,S)
    chunk_decay = torch.exp(last[:, :, 0, :]).to(xr.dtype)   # (B,nc,H)
    state = xr.new_zeros((b, h, p, s))
    prev = []                                # the state entering chunk n
    for n in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, n, :, None, None] + states[:, n]
    prev_states = torch.stack(prev, dim=1)                   # (B,nc,H,P,S)

    y_inter = torch.einsum("bnqs,bnqh,bnhps->bnqhp",
                           Cr, torch.exp(cum).to(xr.dtype), prev_states)
    y = (y_intra + y_inter).reshape(b, nc * q, h, p)[:, :l]
    return y, state


def _split_proj(zxbcdt, cfg: ArchConfig):
    di, ds = d_inner(cfg), cfg.ssm_state
    return torch.split(zxbcdt, [di, di, ds, ds, n_heads(cfg)], dim=-1)


def _proj_on_heads(w, x, di: int, ds: int):
    """``in_proj`` on this rank's heads (the train step on ``tp``
    blocks): ``w`` holds its z, x and dt columns around B and C's whole
    (``dist.tensor_parallel``'s take).  z, x and dt read ``x`` entering
    the heads' block; B and C, which every head reads, the replicated
    ``x`` itself, so that their share of its grad is counted once."""
    xe = TP.enter(x)
    zx = xe @ w[..., :2 * di].to(x.dtype)
    bc = x @ w[..., 2 * di:2 * di + 2 * ds].to(x.dtype)
    dt = xe @ w[..., 2 * di + 2 * ds:].to(x.dtype)
    return (*torch.split(zx, [di, di], dim=-1),
            *torch.split(bc, [ds, ds], dim=-1), dt)


def _shared_into_heads(Bc, Cc):
    """B and C, the same on every ``model`` rank, into this rank's heads:
    their grads summed over ``model``."""
    return TP.enter(Bc), TP.enter(Cc)


def _norm_on_heads(p, y, width: int, eps: float = 1e-6):
    """``layers.rmsnorm`` over all ``width`` channels of which ``y``
    holds this rank's block: the sum of squares summed over ``model``
    (forward and backward: each rank's channels read the whole sum)."""
    y32 = y.float()
    ss = TP.enter(TP.leave((y32 * y32).sum(dim=-1, keepdim=True)))
    out = y32 * torch.rsqrt(ss / width + eps)
    return (out * p["scale"].float()).to(y.dtype)


def mamba2_block(p, x, cfg: ArchConfig, return_cache: bool = False):
    """Full-sequence forward.  x (B, L, D) -> (B, L, D); with
    ``return_cache``, ``(y, ssm, conv)``: the SSM state after the last
    position (B, H, P, S) and the last ``ssm_conv - 1`` conv inputs
    (B, ssm_conv - 1, d_inner + 2 ssm_state), zero on the left of a prompt
    shorter than that, both in ``cfg.adtype`` -- what a scan of decode
    steps leaves in the cache.

    Where ``p`` holds this rank's block of the heads (the train step under
    ``tp``: ``a_log`` holds H / model heads), the layer computes its heads
    only: their z, x and dt (B and C whole), the conv over its x channels
    and B and C's, the SSD of its heads, the gated norm over every
    channel (its sum of squares summed over ``model``) and ``out_proj``'s
    rows, whose partial outputs are summed over ``model``; the cache is
    its heads' and channels'."""
    b, l, _ = x.shape
    h, ds, dh = n_heads(cfg), cfg.ssm_state, cfg.ssm_head_dim
    hb = p["a_log"]["w"].shape[-1]
    di = hb * dh
    cut = TP.is_block(h, hb)
    if cut:
        z, xs, Bc, Cc, dt = _proj_on_heads(p["in_proj"]["w"], x, di, ds)
    else:
        z, xs, Bc, Cc, dt = _split_proj(L.linear(p["in_proj"], x), cfg)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)                # (B,L,di+2S)
    conv_out = depthwise_causal_conv1d(conv_in, p["conv_w"]["w"],
                                       cfg.conv_engine_policy)
    conv_out = F.silu(conv_out)
    xs, Bc, Cc = torch.split(conv_out, [di, ds, ds], dim=-1)
    if cut:
        Bc, Cc = _shared_into_heads(Bc, Cc)
    dt = F.softplus(dt.float() + p["dt_bias"]["w"][None, None, :])
    xh = xs.reshape(b, l, hb, dh)
    y, state = _ssd_chunked(xh, dt, p["a_log"]["w"], Bc.to(xh.dtype),
                            Cc.to(xh.dtype))
    y = y + xh * p["d_skip"]["w"][None, None, :, None].to(xh.dtype)
    y = y.reshape(b, l, di)
    if cut:
        y = _norm_on_heads(p["norm"], y * F.silu(z), h * dh)
        out = TP.leave(L.linear(p["out_proj"], y.float())).to(y.dtype)
    else:
        y = L.rmsnorm(p["norm"], y * F.silu(z))
        out = L.linear(p["out_proj"], y)
    if not return_cache:
        return out
    conv = F.pad(conv_in, (0, 0, cfg.ssm_conv - 1, 0))[:, l:]
    return out, state.to(cfg.adtype), conv.to(cfg.adtype)


def mamba2_init_state(cfg: ArchConfig, batch: int, nl: int, device=None):
    di, h, ds, dh = d_inner(cfg), n_heads(cfg), cfg.ssm_state, \
        cfg.ssm_head_dim
    dev = resolve_device(device)
    return {
        "ssm": torch.zeros((nl, batch, h, dh, ds), dtype=cfg.adtype,
                           device=dev),
        "conv": torch.zeros((nl, batch, cfg.ssm_conv - 1, di + 2 * ds),
                            dtype=cfg.adtype, device=dev),
    }


def mamba2_decode(p, x, ssm_state, conv_state, cfg: ArchConfig):
    """Single-token recurrent step.  x (B,1,D) -> (out (B,1,D), new SSM
    state, new conv state)."""
    b = x.shape[0]
    di, h, dh = d_inner(cfg), n_heads(cfg), cfg.ssm_head_dim
    ds = cfg.ssm_state
    z, xs, Bc, Cc, dt = _split_proj(L.linear(p["in_proj"], x)[:, 0], cfg)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)                # (B, di+2S)
    hist = torch.cat([conv_state, conv_in[:, None, :].to(conv_state.dtype)],
                     dim=1)                                  # (B, K, ch)
    w = p["conv_w"]["w"].to(hist.dtype)                      # (K, ch)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", hist, w))
    new_conv_state = hist[:, 1:]
    xs, Bc, Cc = torch.split(conv_out, [di, ds, ds], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"]["w"][None])
    a = torch.exp(dt * (-torch.exp(p["a_log"]["w"]))[None])  # (B,H)
    xh = xs.reshape(b, h, dh)
    upd = torch.einsum("bh,bhp,bs->bhps", dt.to(xh.dtype), xh,
                       Bc.to(xh.dtype))
    new_ssm = ssm_state * a[:, :, None, None].to(ssm_state.dtype) \
        + upd.to(ssm_state.dtype)
    y = torch.einsum("bhps,bs->bhp", new_ssm.to(xh.dtype), Cc.to(xh.dtype))
    y = y + xh * p["d_skip"]["w"][None, :, None].to(xh.dtype)
    y = y.reshape(b, di)
    y = L.rmsnorm(p["norm"], y * F.silu(z))
    out = L.linear(p["out_proj"], y)[:, None, :]
    return out, new_ssm, new_conv_state
