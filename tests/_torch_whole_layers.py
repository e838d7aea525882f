"""The port's Mamba2 block, RG-LRU block and GQA prefill as they were before
any of them computed on Mamba2 heads, RG-LRU channels or MQA query heads
of a ``model`` block, and its MLA prefill, input embedding (the
frontends) and MTP head as they were before any of them computed on MLA
heads or ``d_model`` columns: the reference ``tests/_torch_spmd_worker.py``
holds the layers' whole-tensor paths (serving, the unsharded step) to,
bit for bit.  Their GQA prefill still computes on whole query heads with
whole KV groups, as before.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.conv import depthwise_causal_conv1d
from repro_torch.dist import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
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


def _mla_qkv(p, x, cfg, positions):
    b, l, _ = x.shape
    h, kvr = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    ang = L.rope_freqs(dr, cfg.rope_theta, positions)
    q = L.linear(p["wq_b"], L.rmsnorm(p["q_norm"], L.linear(p["wq_a"], x)))
    q = q.reshape(b, l, h, dn + dr)
    q_nope, q_rope = q[..., :dn], L.apply_rope(q[..., dn:], ang)
    kv = L.linear(p["wkv_a"], x)
    c_kv = L.rmsnorm(p["kv_norm"], kv[..., :kvr])
    k_rope = L.apply_rope(kv[..., None, kvr:], ang)            # (B,L,1,dr)
    kvu = L.linear(p["wkv_b"], c_kv).reshape(b, l, h, dn + dv)
    k_nope, v = kvu[..., :dn], kvu[..., dn:]
    return q_nope, q_rope, k_nope, k_rope, v, c_kv


def mla_prefill(p, x, cfg, *, positions=None):
    b, l, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(l, device=x.device)
    q_nope, q_rope, k_nope, k_rope, v, c_kv = _mla_qkv(p, x, cfg, positions)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_rope.expand(b, l, h, dr)], dim=-1)
    if dv < dn + dr:
        v = F.pad(v, (0, dn + dr - dv))
    o = _sdpa(q_cat, k_cat, v, causal=True, scale=(dn + dr) ** -0.5)
    o = o[..., :dv].reshape(b, l, h * dv)
    return L.linear(p["wo"], o), c_kv, k_rope[:, :, 0]


def embed_inputs(params, batch, cfg):
    if cfg.family == "audio":
        return L.linear(params["frontend_proj"],
                        batch["frontend"].to(cfg.adtype))
    x = L.embed(params["embed"], batch["tokens"], cfg.vocab).to(cfg.adtype)
    if cfg.family == "vlm" and "frontend" in batch:
        img = L.linear(params["frontend_proj"],
                       batch["frontend"].to(cfg.adtype))
        x = torch.cat([img, x], dim=1)
    return x


def mtp_forward(params, batch, h, cfg):
    from repro_torch.models.model import _lm_head
    p = params["mtp"]
    nxt = torch.roll(batch["tokens"], -1, dims=1)
    e = L.embed(params["embed"], nxt, cfg.vocab).to(h.dtype)
    hcat = torch.cat([L.rmsnorm(p["norm_h"], h, cfg.norm_eps),
                      L.rmsnorm(p["norm_e"], e, cfg.norm_eps)], dim=-1)
    hm = L.linear(p["proj"], hcat)
    hm = T.attn_block(T._layers(p["block"])[0], hm, cfg)[0]
    return _lm_head(params, cfg, hm)
