"""Block assembly of the dense, MoE, SSM, hybrid, VLM and audio families
(counterpart of ``repro.models.transformer``).

All layers of a stack share one stacked parameter tree (leading dim =
#layers), the JAX package's layout, so JAX parameters carry across
unchanged.  A Python loop over the layers takes the place of
``lax.scan``; each stacked leaf is unbound once, so the backward stacks
the layers' grads in one write.  When a gradient flows, each block is
rematerialized as the JAX package's ``jax.checkpoint`` does it
(``cfg.remat == "block"`` unless ``config.remat`` overrides it):
``torch.utils.checkpoint`` keeps only the block's input and runs the
block again in the backward.  ``constrain_batch`` stands at the block
boundaries where the JAX package calls it: inside a batch-sharded train
step every activation there is this rank's batch block, and one that is
not raises (``repro_torch.dist.constraints``); elsewhere it is the
identity.  Inside the train step on ``tp`` blocks, the GQA and MLA
attention, the MLPs and the experts of a block compute on the heads,
columns and experts the rank holds (``repro_torch.dist.tensor_parallel``).

Families:
  dense, vlm, audio : one stack of attention blocks, ``blocks`` (audio's
           bidirectional: ``cfg.attn_kind == "bidir"``)
  moe    : ``blocks_dense`` (the first ``first_dense_layers``, SwiGLU) and
           ``blocks_moe`` (routed experts, ``models/moe.py``)
  ssm    : one stack of Mamba2 blocks, ``blocks`` (``models/mamba2.py``)
  hybrid : ``super``, a stack of (``rec1``, ``rec2``, ``attn``)
           super-blocks (RG-LRU blocks, ``models/recurrent.py``, and
           local-window attention), then ``extra``, the remainder of
           ``n_layers`` after whole super-blocks as RG-LRU blocks
The dense and MoE families' attention is GQA or MLA (``cfg.use_mla``).
A hybrid super-block is one block: one checkpoint when a gradient flows,
one layer slice of ``super`` in the cache.  The audio encoder has no
cache (no decode), as in the JAX package.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import config
from repro_torch.dist.constraints import constrain_batch
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import recurrent as R
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _stacks(cfg: ArchConfig) -> list[tuple[str, int, str]]:
    """``(name, layers, kind)`` of each stack, in the order they run; the
    kind (``attn``, ``moe``, ``ssm``, ``rec`` or ``super``) names the
    block of :data:`_BLOCKS`."""
    if cfg.family in ("dense", "vlm", "audio", "ssm"):
        kind = "ssm" if cfg.family == "ssm" else "attn"
        return [("blocks", cfg.n_layers, kind)]
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        return ([("blocks_dense", nd, "attn")] if nd else []) + [
            ("blocks_moe", cfg.n_layers - nd, "moe")]
    if cfg.family == "hybrid":
        n_super = cfg.n_layers // len(cfg.layer_pattern)
        n_extra = cfg.n_layers - n_super * len(cfg.layer_pattern)
        return [("super", n_super, "super")] + (
            [("extra", n_extra, "rec")] if n_extra else [])
    raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def cache_keys(cfg: ArchConfig) -> tuple[str, str]:
    """The two leaves of an attention or SSM layer's cache: Mamba2's SSM
    state and conv inputs, MLA's latent and rope key, or GQA's keys and
    values.  (A hybrid super-block's cache nests ``rec1``/``rec2``, each
    ``h`` and ``conv``, and ``attn``'s ``k`` and ``v``.)"""
    if cfg.family == "ssm":
        return ("ssm", "conv")
    return ("c_kv", "k_rope") if cfg.use_mla else ("k", "v")


def _layers(stacked):
    """The per-layer slices of a stacked parameter (or cache) tree: views,
    one ``unbind`` per leaf."""
    per_leaf = [a.unbind(0) for a in tree_leaves(stacked)]
    return [tree_unflatten(stacked, [layers[i] for layers in per_leaf])
            for i in range(len(per_leaf[0]))]


def remat_policy(cfg: ArchConfig) -> str:
    """``config.remat`` overrides the per-arch policy (``none`` | ``block``),
    as in the JAX package."""
    return cfg.remat if config.remat is None else config.remat


# ---------------------------------------------------------------------------
# Per-kind block init and apply.  A block takes one layer's parameters
# (already sliced) and returns ``(x, aux, cached)``: the MoE aux terms
# (``{}`` elsewhere) and a tree of what the layer's cache holds, each leaf
# (B, n, ...) written to cache positions ``[0, n)``.
# ---------------------------------------------------------------------------

def init_attn_block(generator: torch.Generator, cfg: ArchConfig, nl: int,
                    use_moe: bool = False, device=None):
    attn = (A.init_mla if cfg.use_mla else A.init_gqa)(generator, cfg, nl,
                                                        device)
    p = {"ln1": L.init_rmsnorm(cfg.d_model, cfg.dtype, nl, device),
         "attn": attn,
         "ln2": L.init_rmsnorm(cfg.d_model, cfg.dtype, nl, device)}
    if use_moe:
        p["moe"] = MOE.init_moe(generator, cfg, nl, device)
    else:
        p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.dtype, nl,
                              device)
    return p


def attn_block(p, x, cfg: ArchConfig, capacity: int | None = None,
               window: int | None = None):
    """One attention layer: its cache holds the two tensors of
    :func:`cache_keys`.  ``capacity`` is the MoE expert capacity (default:
    the training capacity, which drops); ``window`` a local attention
    window (GQA only, as in the JAX package)."""
    x = constrain_batch(x)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.use_mla:
        o, *cached = A.mla_prefill(p["attn"], h, cfg)
    else:
        o, *cached = A.gqa_prefill(p["attn"], h, cfg, window=window)
    x = constrain_batch(x + o)
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        y, aux = MOE.moe_apply(p["moe"], h, cfg, capacity)
    else:
        y, aux = L.mlp(p["mlp"], h, cfg.d_ff), {}
    return constrain_batch(x + y), aux, dict(zip(cache_keys(cfg), cached))


def init_ssm_block(generator: torch.Generator, cfg: ArchConfig, nl: int,
                   device=None):
    return {"ln": L.init_rmsnorm(cfg.d_model, cfg.dtype, nl, device),
            "ssm": M2.init_mamba2(generator, cfg, nl, device)}


def ssm_block(p, x, cfg: ArchConfig, capacity: int | None = None):
    """One pre-norm Mamba2 layer: its cache holds the final SSM state and
    the last conv inputs.  ``capacity`` is unused (no experts)."""
    x = constrain_batch(x)
    h = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    y, *cached = M2.mamba2_block(p["ssm"], h, cfg, return_cache=True)
    return constrain_batch(x + y), {}, dict(zip(cache_keys(cfg), cached))


def init_rec_block(generator: torch.Generator, cfg: ArchConfig, nl: int,
                   device=None):
    return {"ln1": L.init_rmsnorm(cfg.d_model, cfg.dtype, nl, device),
            "rec": R.init_recurrent(generator, cfg, nl, device),
            "ln2": L.init_rmsnorm(cfg.d_model, cfg.dtype, nl, device),
            "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.dtype, nl,
                              device)}


def rec_block(p, x, cfg: ArchConfig, capacity: int | None = None):
    """One pre-norm RG-LRU layer with its SwiGLU MLP: its cache holds the
    final recurrent state ``h`` and the last conv inputs ``conv``."""
    x = constrain_batch(x)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, h_last, conv = R.recurrent_block(p["rec"], h, cfg, return_cache=True)
    x = constrain_batch(x + y)
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return (constrain_batch(x + L.mlp(p["mlp"], h, cfg.d_ff)), {},
            {"h": h_last, "conv": conv})


def init_super_block(generator: torch.Generator, cfg: ArchConfig, nl: int,
                     device=None):
    return {"rec1": init_rec_block(generator, cfg, nl, device),
            "rec2": init_rec_block(generator, cfg, nl, device),
            "attn": init_attn_block(generator, cfg, nl, False, device)}


def super_block(p, x, cfg: ArchConfig, capacity: int | None = None):
    """The hybrid family's (rec, rec, attn) super-block, its attention
    under ``cfg.local_window``."""
    x, _, c1 = rec_block(p["rec1"], x, cfg)
    x, _, c2 = rec_block(p["rec2"], x, cfg)
    x, _, ca = attn_block(p["attn"], x, cfg, window=cfg.local_window)
    return x, {}, {"rec1": c1, "rec2": c2, "attn": ca}


#: kind -> (init(generator, cfg, nl, device), block)
_BLOCKS = {
    "attn": (lambda g, cfg, nl, dev: init_attn_block(g, cfg, nl, False, dev),
             attn_block),
    "moe": (lambda g, cfg, nl, dev: init_attn_block(g, cfg, nl, True, dev),
            attn_block),
    "ssm": (init_ssm_block, ssm_block),
    "rec": (init_rec_block, rec_block),
    "super": (init_super_block, super_block),
}


def init_stacks(generator: torch.Generator, cfg: ArchConfig, device=None):
    return {name: _BLOCKS[kind][0](generator, cfg, nl, device)
            for name, nl, kind in _stacks(cfg)}


def _block_out(block, p, x, cfg: ArchConfig, capacity):
    return block(p, x, cfg, capacity)[:2]


def _write(layer_cache, cached) -> None:
    """Each leaf of ``cached`` (B, n, ...) into positions ``[0, n)`` of the
    layer's cache leaf (a whole state where ``n`` is its length)."""
    tree_map(lambda t, c: c[:, :t.shape[1]].copy_(t), cached, layer_cache)


def forward_stacks(params, x, cfg: ArchConfig, cache=None,
                   capacity: int | None = None):
    """x (B, L, D) -> (x, aux) through all blocks; aux holds the MoE terms
    summed over the layers (``{}`` for the other families).  With
    ``cache`` (from :func:`init_cache`), each layer's cached tensors are
    written into its positions ``[0, L)`` (an SSM or RG-LRU layer's state
    and conv inputs whole): the prefill of one causal pass.  Without it,
    and with a gradient flowing, each block (a hybrid super-block whole)
    is rematerialized under :func:`remat_policy` ``"block"``."""
    aux: dict = {}
    for name, _, kind in _stacks(cfg):
        block = _BLOCKS[kind][1]
        layers = _layers(params[name])
        remat = (cache is None and remat_policy(cfg) == "block"
                 and torch.is_grad_enabled()
                 and any(a.requires_grad
                         for a in [x, *tree_leaves(layers)]))
        caches = _layers(cache[name]) if cache is not None else None
        for i, p in enumerate(layers):
            if remat:
                # The block has no random op, so no RNG state is kept.
                x, a = checkpoint(_block_out, block, p, x, cfg, capacity,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a, cached = block(p, x, cfg, capacity)
                if caches is not None:
                    _write(caches[i], cached)
            for key, v in a.items():
                aux[key] = aux[key] + v if key in aux else v
    return x, aux


def _init_layer_cache(kind: str, cfg: ArchConfig, batch: int, max_len: int,
                      nl: int, device):
    if kind == "ssm":
        return M2.mamba2_init_state(cfg, batch, nl, device)
    if kind == "rec":
        return R.recurrent_init_state(cfg, batch, nl, device)
    if kind == "super":
        # The JAX package allocates the attention cache at max_len, window
        # or not.
        return {"rec1": R.recurrent_init_state(cfg, batch, nl, device),
                "rec2": R.recurrent_init_state(cfg, batch, nl, device),
                "attn": A.gqa_init_cache(cfg, batch, max_len, nl, device)}
    make = A.mla_init_cache if cfg.use_mla else A.gqa_init_cache
    return make(cfg, batch, max_len, nl, device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Per stack, GQA's ``k``/``v`` or MLA's ``c_kv``/``k_rope``, each laid
    out ``(n_layers, batch, max_len, ...)``; for the SSM family Mamba2's
    ``ssm`` (n_layers, batch, H, P, S) and ``conv`` (n_layers, batch,
    ssm_conv - 1, channels) state, whatever ``max_len``; for the hybrid
    family, per super-block ``rec1``/``rec2`` (each ``h`` (n, batch, W)
    float32 and ``conv`` (n, batch, rglru_conv - 1, W)) and ``attn``'s
    ``k``/``v`` at ``max_len``, and ``extra``'s ``h``/``conv``.  An
    encoder-only config (the audio family) has no cache: it raises, as the
    JAX package's ``init_cache`` does."""
    if cfg.is_encoder_only:
        raise ValueError(f"{cfg.name}: an encoder-only model has no decode "
                         f"cache")
    return {name: _init_layer_cache(kind, cfg, batch, max_len, nl, device)
            for name, nl, kind in _stacks(cfg)}


# ---------------------------------------------------------------------------
# Decode: one token through each layer, its cache slice updated in place
# ---------------------------------------------------------------------------

def _decode_attn(p, c, x, pos, cfg: ArchConfig, window=None):
    hn = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.use_mla:
        o, _, _ = A.mla_decode(p["attn"], hn, c["c_kv"], c["k_rope"], pos,
                               cfg)
    else:
        o, _, _ = A.gqa_decode(p["attn"], hn, c["k"], c["v"], pos, cfg,
                               window=window)
    x = x + o
    hn = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        y, _ = MOE.moe_apply(p["moe"], hn, cfg,
                             capacity=hn.shape[0] * hn.shape[1])
    else:
        y = L.mlp(p["mlp"], hn)
    return x + y


def _decode_ssm(p, c, x, pos, cfg: ArchConfig):
    hn = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    o, ssm, conv = M2.mamba2_decode(p["ssm"], hn, c["ssm"], c["conv"], cfg)
    c["ssm"].copy_(ssm)
    c["conv"].copy_(conv)
    return x + o


def _decode_rec(p, c, x, pos, cfg: ArchConfig):
    hn = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    o, h, conv = R.recurrent_decode(p["rec"], hn, c["h"], c["conv"], cfg)
    c["h"].copy_(h)
    c["conv"].copy_(conv)
    x = x + o
    hn = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], hn)


def _decode_super(p, c, x, pos, cfg: ArchConfig):
    x = _decode_rec(p["rec1"], c["rec1"], x, pos, cfg)
    x = _decode_rec(p["rec2"], c["rec2"], x, pos, cfg)
    return _decode_attn(p["attn"], c["attn"], x, pos, cfg,
                        window=cfg.local_window)


_DECODE = {"attn": _decode_attn, "moe": _decode_attn, "ssm": _decode_ssm,
           "rec": _decode_rec, "super": _decode_super}


def decode_stacks(params, cache, x, pos, cfg: ArchConfig):
    """x (B,1,D), ``pos`` an int or a per-lane (B,) tensor -> (x, cache);
    the cache is updated in place.  MoE layers run with capacity = the
    step's token count, so no token is dropped.  An SSM or RG-LRU layer
    reads no position: its state is the whole past."""
    for name, _, kind in _stacks(cfg):
        for p, c in zip(_layers(params[name]), _layers(cache[name])):
            x = _DECODE[kind](p, c, x, pos, cfg)
    return x, cache
