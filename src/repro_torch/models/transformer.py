"""Block assembly of the dense family (counterpart of
``repro.models.transformer``).

All layers share one stacked parameter tree (leading dim = #layers), the
JAX package's layout, so JAX parameters carry across unchanged.  A Python
loop over the layers takes the place of ``lax.scan``; each stacked leaf is
unbound once, so the backward stacks the layers' grads in one write.
When a gradient flows, each block is rematerialized as the JAX package's
``jax.checkpoint`` does it (``cfg.remat == "block"`` unless
``config.remat`` overrides it): ``torch.utils.checkpoint`` keeps only the
block's input and runs the block again in the backward.  The JAX package's
``constrain_batch`` (mesh sharding, ROADMAP A13) is dropped.  The other
families (MoE, hybrid, SSM, VLM, audio) come with ROADMAP A10 and raise.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import config
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.tree import tree_leaves, tree_unflatten


def _dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.use_mla or cfg.local_window:
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA family is ported; "
            f"{cfg.family} blocks, MLA and local windows come with ROADMAP "
            f"A10")


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


def init_attn_block(generator: torch.Generator, cfg: ArchConfig, nl: int,
                    device=None):
    return {"ln1": L.init_rmsnorm(cfg.d_model, cfg.dtype, nl, device),
            "attn": A.init_gqa(generator, cfg, nl, device),
            "ln2": L.init_rmsnorm(cfg.d_model, cfg.dtype, nl, device),
            "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.dtype, nl,
                              device)}


def attn_block(p, x, cfg: ArchConfig):
    """One layer (parameters already sliced): ``(x, (k, v))`` with the
    layer's rope'd keys and values.  (The JAX block returns an aux dict in
    their place, always empty for the dense family.)"""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    o, k, v = A.gqa_prefill(p["attn"], h, cfg)
    x = x + o
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], h), (k, v)


def init_stacks(generator: torch.Generator, cfg: ArchConfig, device=None):
    _dense(cfg)
    return {"blocks": init_attn_block(generator, cfg, cfg.n_layers, device)}


def _block_out(p, x, cfg: ArchConfig):
    return attn_block(p, x, cfg)[0]


def forward_stacks(params, x, cfg: ArchConfig, cache=None):
    """x (B, L, D) -> x through all blocks.  With ``cache`` (from
    :func:`init_cache`), each layer's keys and values are written into its
    positions ``[0, L)``: the prefill of one causal pass.  Without it, and
    with a gradient flowing, each block is rematerialized under
    :func:`remat_policy` ``"block"``."""
    _dense(cfg)
    layers = _layers(params["blocks"])
    remat = (cache is None and remat_policy(cfg) == "block"
             and torch.is_grad_enabled()
             and any(a.requires_grad for a in [x, *tree_leaves(layers)]))
    for i, p in enumerate(layers):
        if remat:
            # The block has no random op, so no RNG state is kept.
            x = checkpoint(_block_out, p, x, cfg, use_reentrant=False,
                           preserve_rng_state=False)
            continue
        x, (k, v) = attn_block(p, x, cfg)
        if cache is not None:
            cache["blocks"]["k"][i, :, :k.shape[1]] = k
            cache["blocks"]["v"][i, :, :v.shape[1]] = v
    return x


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    _dense(cfg)
    return {"blocks": A.gqa_init_cache(cfg, batch, max_len, cfg.n_layers,
                                       device)}


def decode_stacks(params, cache, x, pos, cfg: ArchConfig):
    """x (B,1,D), ``pos`` an int or a per-lane (B,) tensor -> (x, cache);
    the cache is updated in place."""
    _dense(cfg)
    for p, c in zip(_layers(params["blocks"]), _layers(cache["blocks"])):
        hn = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        o, _, _ = A.gqa_decode(p["attn"], hn, c["k"], c["v"], pos, cfg)
        x = x + o
        hn = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + L.mlp(p["mlp"], hn)
    return x, cache
