"""The port's Mamba2 block, RG-LRU block and GQA prefill as they were before
any of them computed on Mamba2 heads, RG-LRU channels or MQA query heads
of a ``model`` block: the reference ``tests/_torch_spmd_worker.py`` holds
the layers' whole-tensor paths (serving, the unsharded step) to, bit for
bit.  Their GQA prefill still computes on whole query heads with whole KV
groups, as before.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.conv import depthwise_causal_conv1d
from repro_torch.dist import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models.attention import _out_proj, _sdpa, _split_heads
from repro_torch.models.mamba2 import (_split_proj, _ssd_chunked, d_inner,
                                       n_heads)
from repro_torch.models.recurrent import _gelu, _rglru_scan


def mamba2_block(p, x, cfg, return_cache: bool = False):
    b, l, _ = x.shape
    di, h, ds, dh = d_inner(cfg), n_heads(cfg), cfg.ssm_state, \
        cfg.ssm_head_dim
    z, xs, Bc, Cc, dt = _split_proj(L.linear(p["in_proj"], x), cfg)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)
    conv_out = depthwise_causal_conv1d(conv_in, p["conv_w"]["w"],
                                       cfg.conv_engine_policy)
    conv_out = F.silu(conv_out)
    xs, Bc, Cc = torch.split(conv_out, [di, ds, ds], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"]["w"][None, None, :])
    xh = xs.reshape(b, l, h, dh)
    y, state = _ssd_chunked(xh, dt, p["a_log"]["w"], Bc.to(xh.dtype),
                            Cc.to(xh.dtype))
    y = y + xh * p["d_skip"]["w"][None, None, :, None].to(xh.dtype)
    y = y.reshape(b, l, di)
    y = L.rmsnorm(p["norm"], y * F.silu(z))
    out = L.linear(p["out_proj"], y)
    if not return_cache:
        return out
    conv = F.pad(conv_in, (0, 0, cfg.ssm_conv - 1, 0))[:, l:]
    return out, state.to(cfg.adtype), conv.to(cfg.adtype)


def recurrent_block(p, x, cfg, return_cache: bool = False):
    xb = L.linear(p["wx"], x)
    xc = depthwise_causal_conv1d(xb, p["conv_w"]["w"],
                                 cfg.conv_engine_policy)
    r = torch.sigmoid(L.linear(p["wr"], xc).float())
    i = torch.sigmoid(L.linear(p["wi"], xc).float())
    h = _rglru_scan(xc.float(), r, i, p["lam"]["w"])
    gate = _gelu(L.linear(p["wgate"], x))
    out = L.linear(p["wout"], h.to(x.dtype) * gate)
    if not return_cache:
        return out
    conv = F.pad(xb, (0, 0, cfg.rglru_conv - 1, 0))[:, x.shape[1]:]
    return out, h[:, -1], conv.to(cfg.adtype)


def gqa_prefill(p, x, cfg, *, window=None, positions=None):
    b, l, _ = x.shape
    dh = cfg.head_dim
    h, hk = p["wq"]["w"].shape[-1] // dh, p["wk"]["w"].shape[-1] // dh
    cut = TP.is_block(cfg.n_heads, h)
    if cut != TP.is_block(cfg.n_kv_heads, hk):
        raise RuntimeError(f"{h} of {cfg.n_heads} query heads with {hk} of "
                           f"{cfg.n_kv_heads} KV heads")
    if cut:
        x = TP.enter(x)
    if positions is None:
        positions = torch.arange(l, device=x.device)
    ang = L.rope_freqs(dh, cfg.rope_theta, positions)
    q = L.apply_rope(_split_heads(L.linear(p["wq"], x), h, dh), ang)
    k = L.apply_rope(_split_heads(L.linear(p["wk"], x), hk, dh), ang)
    v = _split_heads(L.linear(p["wv"], x), hk, dh)
    o = _sdpa(q, k, v, causal=not cfg.is_encoder_only, window=window)
    return _out_proj(p["wo"], o.reshape(b, l, h * dh), cut), k, v
