"""Attention variants: grouped-query attention and DeepSeek-V3's MLA
(counterpart of ``repro.models.attention``).

Entry points, as in the JAX package:
  * ``gqa_train`` / ``mla_train`` -- full-sequence forward (and
    ``gqa_prefill`` / ``mla_prefill``, which also return what a prefill
    writes to the cache: the rope'd keys and values, or MLA's normed
    latent ``c_kv`` and rope'd shared key ``k_rope``)
  * ``gqa_decode`` / ``mla_decode`` -- single-token step against a cache,
    with a scalar position (one clock for the batch) or a per-lane ``(B,)``
    position vector (continuous batching).  ``mla_decode`` absorbs
    ``wkv_b`` into the query and the output, so it attends in the latent
    space and the cache holds only the latents.

Layouts are the JAX package's: q (B, L, H, D), k/v (B, L, Hk, D), caches
(n_layers, B, L_max, Hk, D); MLA caches (n_layers, B, L_max, kv_lora_rank)
and (n_layers, B, L_max, qk_rope_head_dim).

``_sdpa`` sends a full-sequence call (no ``kv_len``, no query offset,
as many queries as keys) to the flash-attention kernel wrapper
(``repro_torch.kernels.flash_attention``: the CUDA kernel on the card, its
plain version on the CPU), causal or full as the call asks (the audio
encoder's bidirectional attention runs it full), only when no gradient
can flow through it (grad mode off, or none of q, k, v requires grad):
the kernel has no backward, in the JAX package as here, and the JAX
package trains through its XLA attention.  Every other call --
training, decode -- runs the JAX package's plain attention at that
length: ``_sdpa_dense``, or ``_sdpa_blockwise`` (the online softmax over
key blocks, in plain PyTorch) for more than
``config.blockwise_kv_threshold`` keys.  MLA's full-sequence call takes
the same route at head dim ``qk_nope + qk_rope`` (192 at DeepSeek-V3's
widths), its ``v`` zero-padded to that dim and the output cropped, as in
the JAX package.

In the train step on ``tp`` blocks (``repro_torch.dist.tensor_parallel``)
``gqa_prefill`` attends over the query heads and KV groups whose columns
the rank holds (or, where the KV heads do not divide, its query heads
against K and V computed whole) and ``mla_prefill`` over its MLA heads
(the latents and the shared rope key computed whole), each summing
``wo``'s partial outputs over ``model``.  ``mla_decode``'s absorbed
latents run on no ``tp`` path: serving computes whole.

A local ``window`` (RecurrentGemma's attention layers) masks keys at or
more than ``window`` positions behind the query (``q_pos - k_pos <
window``), in the dense and the blockwise path, with scalar or per-lane
query offsets.  The flash kernel takes no window (nor does the TPU
kernel): a windowed call goes to it only when it has no more queries than
the window, where the mask excludes nothing.  :func:`_sdpa_local_window`
(the JAX package's: each block of ``window`` queries against the ``2 *
window`` keys before and at it, never the keys outside the window) sits
behind ``WINDOW_SKIP = False``, as there, so it runs on no path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import config
from repro_torch.device import resolve_device
from repro_torch.dist import tensor_parallel as TP
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


def _sdpa_dense(q, k, v, *, causal, q_offset, kv_len, scale, window=None):
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
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    if kv_len is not None:
        mask = mask & (k_pos < _lane(kv_len))
    mask = mask.expand(b, lq, lk)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return out.reshape(b, lq, h, dh)


def _sdpa_blockwise(q, k, v, *, causal, q_offset, kv_len, scale,
                    window=None):
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
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
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


#: When True, a full-sequence causal call with a local window of at most
#: half its length attends over the key blocks inside the window only
#: (:func:`_sdpa_local_window`, O(L W) instead of O(L^2)); False, as in the
#: JAX package, so it runs on no path.
WINDOW_SKIP = False


def _sdpa_local_window(q, k, v, *, window: int, scale: float):
    """Causal local-window self-attention that never touches keys outside
    the window (the JAX package's).  q/k/v (B, L, *, D) of one length;
    query block i of ``window`` rows attends the ``2 window`` keys
    ``[(i - 1) W, (i + 1) W)``, masked to the exact window."""
    b, l, h, dh = q.shape
    hk = k.shape[2]
    g = h // hk
    w = window
    pad = (-l) % w
    lp = l + pad
    nq = lp // w
    qp = F.pad(q, (0, 0, 0, 0, 0, pad))
    # Keys get a leading block of W zeros, so block i - 1 always exists.
    kp = F.pad(k, (0, 0, 0, 0, w, pad))
    vp = F.pad(v, (0, 0, 0, 0, w, pad))
    qb = qp.reshape(b, nq, w, hk, g, dh).float() * scale
    kb = kp.reshape(b, nq + 1, w, hk, dh)
    vb = vp.reshape(b, nq + 1, w, hk, dh)
    k2 = torch.cat([kb[:, :-1], kb[:, 1:]], dim=2)        # (B, nq, 2W, Hk, D)
    v2 = torch.cat([vb[:, :-1], vb[:, 1:]], dim=2)
    logits = torch.einsum("bnqkgd,bnskd->bnkgqs", qb, k2.float())
    # Query block i, row qi: absolute query i W + qi; slab index s covers
    # absolute key (i - 1) W + s.  The window: 0 <= q - k < window, with
    # k >= 0 (the leading zero block) and k < l (the tail padding).
    dev = q.device
    qi = torch.arange(w, device=dev)
    si = torch.arange(2 * w, device=dev)
    d = w + qi[:, None] - si[None, :]                      # (W, 2W)
    base = (d >= 0) & (d < window)
    k_abs = (torch.arange(nq, device=dev)[:, None] - 1) * w + si[None, :]
    in_range = (k_abs >= 0) & (k_abs < l)
    mask = base[None] & in_range[:, None, :]               # (nq, W, 2W)
    logits = logits.masked_fill(~mask[None, :, None, None], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bnkgqs,bnskd->bnqkgd", p.to(v.dtype), v2)
    return o.reshape(b, lp, h, dh)[:, :l]


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _sdpa(q, k, v, *, causal: bool, window: int | None = None,
          q_offset=0, kv_len=None, scale: float | None = None):
    """q (B,Lq,H,D), k/v (B,Lk,Hk,D) -> (B,Lq,H,D).

    GQA: query head h attends kv head h // (H/Hk); ``window`` is a local
    attention window (RecurrentGemma); ``kv_len`` masks cache positions >=
    len.  A full-sequence call, causal or full, through which no gradient
    flows, and whose window (if any) spans all its queries, runs the flash
    kernel (heads-first copies in and out); the rest (training, decode) is
    dense, or blockwise past the key-length threshold."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if (WINDOW_SKIP and window is not None and causal
            and q.shape[1] == k.shape[1] and q.shape[1] >= 2 * window
            and kv_len is None and isinstance(q_offset, int)
            and q_offset == 0):
        return _sdpa_local_window(q, k, v, window=window, scale=scale)
    if (kv_len is None and isinstance(q_offset, int) and q_offset == 0
            and q.shape[1] == k.shape[1]
            and (window is None or q.shape[1] <= window)
            and not _needs_grad(q, k, v)):
        o = flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(),
                            causal=causal, scale=scale)
        return o.transpose(1, 2)
    if k.shape[1] > config.blockwise_kv_threshold and q.shape[1] > 1:
        return _sdpa_blockwise(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len, scale=scale, window=window)
    return _sdpa_dense(q, k, v, causal=causal, q_offset=q_offset,
                       kv_len=kv_len, scale=scale, window=window)


def _out_proj(p, o, cut: bool):
    """``wo`` on the heads' outputs; on a block of the heads, the partial
    outputs summed over ``model`` in float32 and rounded once, as the
    whole contraction is."""
    if not cut:
        return L.linear(p, o)
    return TP.leave(L.linear(p, o.float())).to(o.dtype)


def gqa_prefill(p, x, cfg: ArchConfig, *, window=None, positions=None):
    """x (B, L, D) -> (out (B, L, D), k, v (B, L, Hk, Dh)): full-sequence
    attention, and the rope'd keys and values of every position.  Where
    ``p`` holds this rank's block of the heads (the train step under
    ``tp``: ``wq`` a column block of whole query heads, ``wo`` the row
    block), it attends over its own heads and ``wo``'s partial outputs
    are summed over ``model``.  ``wk``/``wv`` are then the column blocks of
    their KV groups, or, where the KV heads do not divide (MQA), whole:
    K and V are computed from the replicated ``x`` (not the one entering
    the block, whose grad is summed over ``model`` already) and enter the
    rank's heads, so their grads sum every rank's heads; ``k``/``v`` are
    its heads' or whole."""
    b, l, _ = x.shape
    dh = cfg.head_dim
    h, hk = p["wq"]["w"].shape[-1] // dh, p["wk"]["w"].shape[-1] // dh
    cut = TP.is_block(cfg.n_heads, h)
    kv_cut = TP.is_block(cfg.n_kv_heads, hk)
    if kv_cut and not cut:
        raise RuntimeError(f"{h} of {cfg.n_heads} query heads with {hk} of "
                           f"{cfg.n_kv_heads} KV heads")
    xq = TP.enter(x) if cut else x
    xkv = xq if kv_cut else x
    if positions is None:
        positions = torch.arange(l, device=x.device)
    ang = L.rope_freqs(dh, cfg.rope_theta, positions)
    q = L.apply_rope(_split_heads(L.linear(p["wq"], xq), h, dh), ang)
    k = L.apply_rope(_split_heads(L.linear(p["wk"], xkv), hk, dh), ang)
    v = _split_heads(L.linear(p["wv"], xkv), hk, dh)
    if cut and not kv_cut:
        k, v = TP.enter(k), TP.enter(v)
    o = _sdpa(q, k, v, causal=not cfg.is_encoder_only, window=window)
    return _out_proj(p["wo"], o.reshape(b, l, h * dh), cut), k, v


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
    position per lane instead of copying the cache.  ``window`` masks the
    keys ``window`` or more positions behind ``pos``."""
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
    o = _sdpa(q, cache_k, cache_v, causal=False, window=window,
              q_offset=pos, kv_len=pos + 1)
    return L.linear(p["wo"], o.reshape(b, 1, h * dh)), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------

def init_mla(generator: torch.Generator, cfg: ArchConfig, nl=None,
             device=None):
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    lin = lambda d_in, d_out, **kw: L.init_linear(  # noqa: E731
        generator, d_in, d_out, cfg.dtype, nl, device=device, **kw)
    return {
        "wq_a": lin(d, qr),
        "q_norm": L.init_rmsnorm(qr, cfg.dtype, nl, device),
        "wq_b": lin(qr, h * (dn + dr)),
        "wkv_a": lin(d, kvr + dr),
        "kv_norm": L.init_rmsnorm(kvr, cfg.dtype, nl, device),
        "wkv_b": lin(kvr, h * (dn + dv)),
        "wo": lin(h * dv, d, scale=(h * dv) ** -0.5),
    }


def _latents_into_heads(cq, c_kv, k_rope):
    """MLA's normed latents and shared rope key, the same on every
    ``model`` rank, into this rank's heads: their grads summed over
    ``model``."""
    return TP.enter(cq), TP.enter(c_kv), TP.enter(k_rope)


def mla_prefill(p, x, cfg: ArchConfig, *, positions=None):
    """x (B, L, D) -> (out (B, L, D), c_kv (B, L, kv_lora_rank), k_rope
    (B, L, qk_rope_head_dim)): full-sequence attention, and the normed
    latent and rope'd shared key of every position -- what
    :func:`mla_decode` writes to the cache.  Where ``p`` holds this
    rank's block of the heads (the train step under ``tp``: ``wq_b``/
    ``wkv_b`` column blocks of whole heads, ``wo`` the row block), the
    latents and the rope key are computed whole from the replicated ``x``
    and enter the rank's heads (so their grads sum every rank's heads),
    it attends over its own heads and ``wo``'s partial outputs are
    summed over ``model``."""
    b, l, _ = x.shape
    kvr = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    h = p["wq_b"]["w"].shape[-1] // (dn + dr)
    cut = TP.is_block(cfg.n_heads, h)
    if positions is None:
        positions = torch.arange(l, device=x.device)
    ang = L.rope_freqs(dr, cfg.rope_theta, positions)
    cq = L.rmsnorm(p["q_norm"], L.linear(p["wq_a"], x))
    kv = L.linear(p["wkv_a"], x)
    c_kv = L.rmsnorm(p["kv_norm"], kv[..., :kvr])
    k_rope = L.apply_rope(kv[..., None, kvr:], ang)            # (B,L,1,dr)
    c_in, k_in = c_kv, k_rope
    if cut:
        cq, c_in, k_in = _latents_into_heads(cq, c_kv, k_rope)
    q = L.linear(p["wq_b"], cq).reshape(b, l, h, dn + dr)
    q_nope, q_rope = q[..., :dn], L.apply_rope(q[..., dn:], ang)
    kvu = L.linear(p["wkv_b"], c_in).reshape(b, l, h, dn + dv)
    k_nope, v = kvu[..., :dn], kvu[..., dn:]
    # Fold the shared rope key into per-head features so the common
    # attention core applies at head dim dn + dr; pad v to it and crop.
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_in.expand(b, l, h, dr)], dim=-1)
    if dv < dn + dr:
        v = F.pad(v, (0, dn + dr - dv))
    o = _sdpa(q_cat, k_cat, v, causal=True, scale=(dn + dr) ** -0.5)
    o = o[..., :dv].reshape(b, l, h * dv)
    return _out_proj(p["wo"], o, cut), c_kv, k_rope[:, :, 0]


def mla_train(p, x, cfg: ArchConfig, *, positions=None):
    return mla_prefill(p, x, cfg, positions=positions)[0]


def mla_init_cache(cfg: ArchConfig, batch: int, max_len: int, nl: int,
                   device=None):
    dev = resolve_device(device)
    return {"c_kv": torch.zeros((nl, batch, max_len, cfg.kv_lora_rank),
                                dtype=cfg.adtype, device=dev),
            "k_rope": torch.zeros((nl, batch, max_len, cfg.qk_rope_head_dim),
                                  dtype=cfg.adtype, device=dev)}


def mla_decode(p, x, c_kv_cache, k_rope_cache, pos, cfg: ArchConfig):
    """Absorbed-weight MLA decode: attention runs in the latent space.

    x (B,1,D); c_kv_cache (B,Lmax,kvr); k_rope_cache (B,Lmax,dr); ``pos``
    an int or a per-lane (B,) tensor (see :func:`gqa_decode`).  The caches
    are updated in place and returned."""
    b = x.shape[0]
    h, kvr = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    per_lane = torch.is_tensor(pos)
    if per_lane:
        ang = L.rope_freqs(dr, cfg.rope_theta, pos)[:, None, :]
    else:
        ang = L.rope_freqs(dr, cfg.rope_theta,
                           torch.full((1,), pos, device=x.device))
    q = L.linear(p["wq_b"], L.rmsnorm(p["q_norm"], L.linear(p["wq_a"], x)))
    q = q.reshape(b, 1, h, dn + dr)
    q_nope, q_rope = q[..., :dn], L.apply_rope(q[..., dn:], ang)
    kv = L.linear(p["wkv_a"], x)
    c_kv = L.rmsnorm(p["kv_norm"], kv[..., :kvr])                 # (B,1,kvr)
    k_rope = L.apply_rope(kv[..., None, kvr:], ang)[:, :, 0]      # (B,1,dr)
    if per_lane:
        lanes = torch.arange(b, device=x.device)
        c_kv_cache[lanes, pos] = c_kv[:, 0].to(c_kv_cache.dtype)
        k_rope_cache[lanes, pos] = k_rope[:, 0].to(k_rope_cache.dtype)
    else:
        c_kv_cache[:, pos] = c_kv[:, 0].to(c_kv_cache.dtype)
        k_rope_cache[:, pos] = k_rope[:, 0].to(k_rope_cache.dtype)
    # Absorb wkv_b's key half into the query: q_lat (B,1,H,kvr).
    wkv_b = p["wkv_b"]["w"].reshape(kvr, h, dn + dv).to(x.dtype)
    w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_k)
    ckv = c_kv_cache.to(x.dtype)
    logits = (torch.einsum("bqhr,bsr->bhqs", q_lat, ckv)
              + torch.einsum("bqhd,bsd->bhqs", q_rope,
                             k_rope_cache.to(x.dtype))) * (dn + dr) ** -0.5
    k_pos = torch.arange(c_kv_cache.shape[1], device=x.device)
    lim = pos[:, None, None, None] if per_lane else pos
    logits = logits.float().masked_fill(k_pos > lim, NEG_INF)
    pr = torch.softmax(logits, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhqs,bsr->bqhr", pr, ckv)
    o = torch.einsum("bqhr,rhd->bqhd", o_lat, w_v)
    out = L.linear(p["wo"], o.reshape(b, 1, h * dv))
    return out, c_kv_cache, k_rope_cache
