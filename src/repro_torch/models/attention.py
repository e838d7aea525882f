"""Grouped-query attention (counterpart of the GQA part of
``repro.models.attention``).

Entry points, as in the JAX package:
  * ``gqa_train``   -- full-sequence forward (and ``gqa_prefill``, which
                       also returns the rope'd keys and values a prefill
                       writes to the cache)
  * ``gqa_decode``  -- single-token step against a KV cache, with a scalar
                       position (one clock for the batch) or a per-lane
                       ``(B,)`` position vector (continuous batching)

Layouts are the JAX package's: q (B, L, H, D), k/v (B, L, Hk, D), caches
(n_layers, B, L_max, Hk, D).

``_sdpa`` sends a full-sequence causal call with no ``window`` and no
``kv_len`` to the flash-attention kernel wrapper
(``repro_torch.kernels.flash_attention``: the CUDA kernel on the card, its
plain version on the CPU) only when no gradient can flow through it (grad
mode off, or none of q, k, v requires grad): the kernel has no backward,
in the JAX package as here, and the JAX package trains through its XLA
attention.  Every other call -- training, decode -- runs the JAX
package's plain attention at that length: ``_sdpa_dense``, or
``_sdpa_blockwise`` (the online softmax over key blocks, in plain
PyTorch) for more than ``config.blockwise_kv_threshold`` keys.  A local
window and MLA come with their families (ROADMAP A10) and raise.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import config
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L

NEG_INF = -1e30
#: keys per block of ``_sdpa_blockwise`` (the JAX package's ``BLOCK_K``).
BLOCK_K = 512


def init_gqa(generator: torch.Generator, cfg: ArchConfig, nl=None,
             device=None):
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": L.init_linear(generator, d, h * dh, cfg.dtype, nl,
                            device=device),
        "wk": L.init_linear(generator, d, hk * dh, cfg.dtype, nl,
                            device=device),
        "wv": L.init_linear(generator, d, hk * dh, cfg.dtype, nl,
                            device=device),
        "wo": L.init_linear(generator, h * dh, d, cfg.dtype, nl,
                            scale=(h * dh) ** -0.5, device=device),
    }


def _split_heads(x, n, dh):
    return x.reshape(*x.shape[:-1], n, dh)


def _lane(v):
    """A per-lane (B,) position tensor -> (B, 1, 1), to broadcast over the
    (Lq, Lk) mask; a scalar int stays as it is."""
    return v[:, None, None] if torch.is_tensor(v) else v


def _sdpa_dense(q, k, v, *, causal, q_offset, kv_len, scale):
    """q (B,Lq,H,D), k/v (B,Lk,Hk,D) -> (B,Lq,H,D); the JAX package's dense
    attention (scores in the inputs' type, softmax in float32).
    ``q_offset`` and ``kv_len`` are ints or per-lane (B,) tensors."""
    b, lq, h, dh = q.shape
    lk, hk = k.shape[1], k.shape[2]
    qh = q.reshape(b, lq, hk, h // hk, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qh, k).float() * scale
    q_pos = _lane(q_offset) + torch.arange(lq, device=q.device)[:, None]
    k_pos = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if kv_len is not None:
        mask = mask & (k_pos < _lane(kv_len))
    mask = mask.expand(b, lq, lk)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return out.reshape(b, lq, h, dh)


def _sdpa_blockwise(q, k, v, *, causal, q_offset, kv_len, scale):
    """The JAX package's blockwise attention: an online softmax over key
    blocks of ``BLOCK_K``, in float32 (a loop of plain PyTorch in place
    of its ``lax.scan``).  ``q_offset`` and ``kv_len`` are scalars."""
    b, lq, h, dh = q.shape
    lk, hk = k.shape[1], k.shape[2]
    g = h // hk
    qh = q.reshape(b, lq, hk, g, dh).float() * scale
    q_pos = q_offset + torch.arange(lq, device=q.device)
    m = torch.full((b, hk, g, lq), NEG_INF, device=q.device)
    den = torch.zeros((b, hk, g, lq), device=q.device)
    acc = torch.zeros((b, hk, g, lq, dh), device=q.device)
    for start in range(0, lk, BLOCK_K):
        kb = k[:, start:start + BLOCK_K].float()
        vb = v[:, start:start + BLOCK_K].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qh, kb)
        k_pos = start + torch.arange(kb.shape[1], device=q.device)
        mask = torch.ones((lq, kb.shape[1]), dtype=torch.bool,
                          device=q.device)
        if kv_len is not None:
            mask = mask & (k_pos[None, :] < kv_len)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        den = den * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                                    vb)
        m = m_new
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, lq, h, dh).to(q.dtype)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _sdpa(q, k, v, *, causal: bool, window: int | None = None,
          q_offset=0, kv_len=None, scale: float | None = None):
    """q (B,Lq,H,D), k/v (B,Lk,Hk,D) -> (B,Lq,H,D).

    GQA: query head h attends kv head h // (H/Hk); ``kv_len`` masks cache
    positions >= len.  A full-sequence causal call through which no
    gradient flows runs the flash kernel (heads-first copies in and out);
    the rest is dense, or blockwise past the key-length threshold."""
    if window is not None:
        raise NotImplementedError("local-window attention is not ported "
                                  "yet (ROADMAP A10)")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if (causal and kv_len is None and isinstance(q_offset, int)
            and q_offset == 0 and q.shape[1] == k.shape[1]
            and not _needs_grad(q, k, v)):
        o = flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(),
                            causal=True, scale=scale)
        return o.transpose(1, 2)
    if k.shape[1] > config.blockwise_kv_threshold and q.shape[1] > 1:
        return _sdpa_blockwise(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len, scale=scale)
    return _sdpa_dense(q, k, v, causal=causal, q_offset=q_offset,
                       kv_len=kv_len, scale=scale)


def gqa_prefill(p, x, cfg: ArchConfig, *, window=None, positions=None):
    """x (B, L, D) -> (out (B, L, D), k, v (B, L, Hk, Dh)): full-sequence
    attention, and the rope'd keys and values of every position."""
    b, l, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if positions is None:
        positions = torch.arange(l, device=x.device)
    ang = L.rope_freqs(dh, cfg.rope_theta, positions)
    q = L.apply_rope(_split_heads(L.linear(p["wq"], x), h, dh), ang)
    k = L.apply_rope(_split_heads(L.linear(p["wk"], x), hk, dh), ang)
    v = _split_heads(L.linear(p["wv"], x), hk, dh)
    o = _sdpa(q, k, v, causal=not cfg.is_encoder_only, window=window)
    return L.linear(p["wo"], o.reshape(b, l, h * dh)), k, v


def gqa_train(p, x, cfg: ArchConfig, *, window=None, positions=None):
    return gqa_prefill(p, x, cfg, window=window, positions=positions)[0]


def gqa_init_cache(cfg: ArchConfig, batch: int, max_len: int, nl: int,
                   device=None):
    shape = (nl, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.adtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.adtype, device=dev)}


def gqa_decode(p, x, cache_k, cache_v, pos, cfg: ArchConfig, *, window=None):
    """x (B,1,D); cache_k/v (B,Lmax,Hk,Dh) -> (out, cache_k, cache_v).

    ``pos`` is an int (one position clock for the whole batch) or a
    per-lane (B,) tensor (every lane writes its own slot).  The caches are
    updated in place (the JAX version returns new arrays): a step writes one
    position per lane instead of copying the cache."""
    if window is not None:
        raise NotImplementedError("local-window attention is not ported "
                                  "yet (ROADMAP A10)")
    b = x.shape[0]
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_lane = torch.is_tensor(pos)
    if per_lane:
        ang = L.rope_freqs(dh, cfg.rope_theta, pos)[:, None, :]
    else:
        ang = L.rope_freqs(dh, cfg.rope_theta,
                           torch.full((1,), pos, device=x.device))
    q = L.apply_rope(_split_heads(L.linear(p["wq"], x), h, dh), ang)
    k = L.apply_rope(_split_heads(L.linear(p["wk"], x), hk, dh), ang)
    v = _split_heads(L.linear(p["wv"], x), hk, dh)
    if per_lane:
        lanes = torch.arange(b, device=x.device)
        cache_k[lanes, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[lanes, pos] = v[:, 0].to(cache_v.dtype)
    else:
        cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    o = _sdpa(q, cache_k, cache_v, causal=False, q_offset=pos,
              kv_len=pos + 1)
    return L.linear(p["wo"], o.reshape(b, 1, h * dh)), cache_k, cache_v
