"""Block assembly of the dense, MoE and SSM families (counterpart of
``repro.models.transformer``).

All layers of a stack share one stacked parameter tree (leading dim =
#layers), the JAX package's layout, so JAX parameters carry across
unchanged.  A Python loop over the layers takes the place of
``lax.scan``; each stacked leaf is unbound once, so the backward stacks
the layers' grads in one write.  When a gradient flows, each block is
rematerialized as the JAX package's ``jax.checkpoint`` does it
(``cfg.remat == "block"`` unless ``config.remat`` overrides it):
``torch.utils.checkpoint`` keeps only the block's input and runs the
block again in the backward.  The JAX package's ``constrain_batch`` (mesh
sharding, ROADMAP A13) is dropped.

Families:
  dense : one stack of attention blocks, ``blocks``
  moe   : ``blocks_dense`` (the first ``first_dense_layers``, SwiGLU) and
          ``blocks_moe`` (routed experts, ``models/moe.py``)
  ssm   : one stack of Mamba2 blocks, ``blocks`` (``models/mamba2.py``)
The dense and MoE families' attention is GQA or MLA (``cfg.use_mla``).
The hybrid, VLM and audio families come with ROADMAP A10 and raise.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import config
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.tree import tree_leaves, tree_unflatten


def _stacks(cfg: ArchConfig) -> list[tuple[str, int, bool]]:
    """``(name, layers, use_moe)`` of each stack, in the order they run."""
    if cfg.family not in ("dense", "moe", "ssm") or cfg.local_window:
        raise NotImplementedError(
            f"{cfg.name}: only the dense, MoE and SSM families are ported; "
            f"{cfg.family} blocks and local windows come with ROADMAP A10")
    if cfg.family in ("dense", "ssm"):
        return [("blocks", cfg.n_layers, False)]
    nd = cfg.first_dense_layers
    return ([("blocks_dense", nd, False)] if nd else []) + [
        ("blocks_moe", cfg.n_layers - nd, True)]


def cache_keys(cfg: ArchConfig) -> tuple[str, str]:
    """The two leaves of a layer's cache, in the order a prefill returns
    them: Mamba2's SSM state and conv inputs, MLA's latent and rope key,
    or GQA's keys and values."""
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


def attn_block(p, x, cfg: ArchConfig, capacity: int | None = None):
    """One layer (parameters already sliced): ``(x, aux, cached)`` with the
    MoE aux terms (``{}`` for a SwiGLU block) and the two tensors the
    layer's cache holds (:func:`cache_keys`).  ``capacity`` is the MoE
    expert capacity (default: the training capacity, which drops)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    prefill = A.mla_prefill if cfg.use_mla else A.gqa_prefill
    o, *cached = prefill(p["attn"], h, cfg)
    x = x + o
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        y, aux = MOE.moe_apply(p["moe"], h, cfg, capacity)
    else:
        y, aux = L.mlp(p["mlp"], h), {}
    return x + y, aux, cached


def init_ssm_block(generator: torch.Generator, cfg: ArchConfig, nl: int,
                   device=None):
    return {"ln": L.init_rmsnorm(cfg.d_model, cfg.dtype, nl, device),
            "ssm": M2.init_mamba2(generator, cfg, nl, device)}


def ssm_block(p, x, cfg: ArchConfig, capacity: int | None = None):
    """One pre-norm Mamba2 layer (parameters already sliced): ``(x, {},
    cached)`` with the layer's final SSM state and last conv inputs
    (:func:`cache_keys`).  ``capacity`` is unused (no experts)."""
    h = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    y, *cached = M2.mamba2_block(p["ssm"], h, cfg, return_cache=True)
    return x + y, {}, cached


def init_stacks(generator: torch.Generator, cfg: ArchConfig, device=None):
    if cfg.family == "ssm":
        return {name: init_ssm_block(generator, cfg, nl, device)
                for name, nl, _ in _stacks(cfg)}
    return {name: init_attn_block(generator, cfg, nl, use_moe, device)
            for name, nl, use_moe in _stacks(cfg)}


def _block(cfg: ArchConfig):
    return ssm_block if cfg.family == "ssm" else attn_block


def _block_out(p, x, cfg: ArchConfig, capacity):
    return _block(cfg)(p, x, cfg, capacity)[:2]


def forward_stacks(params, x, cfg: ArchConfig, cache=None,
                   capacity: int | None = None):
    """x (B, L, D) -> (x, aux) through all blocks; aux holds the MoE terms
    summed over the layers (``{}`` for the dense and SSM families).  With
    ``cache`` (from :func:`init_cache`), each layer's cached tensors are
    written into its positions ``[0, L)`` (an SSM layer's state and conv
    inputs whole): the prefill of one causal pass.  Without it, and with a
    gradient flowing, each block is rematerialized under
    :func:`remat_policy` ``"block"``."""
    aux: dict = {}
    block = _block(cfg)
    for name, _, _ in _stacks(cfg):
        layers = _layers(params[name])
        remat = (cache is None and remat_policy(cfg) == "block"
                 and torch.is_grad_enabled()
                 and any(a.requires_grad
                         for a in [x, *tree_leaves(layers)]))
        for i, p in enumerate(layers):
            if remat:
                # The block has no random op, so no RNG state is kept.
                x, a = checkpoint(_block_out, p, x, cfg, capacity,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a, cached = block(p, x, cfg, capacity)
                if cache is not None:
                    for key, t in zip(cache_keys(cfg), cached):
                        cache[name][key][i, :, :t.shape[1]] = t
            for key, v in a.items():
                aux[key] = aux[key] + v if key in aux else v
    return x, aux


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Per stack, GQA's ``k``/``v`` or MLA's ``c_kv``/``k_rope``, each laid
    out ``(n_layers, batch, max_len, ...)``; for the SSM family Mamba2's
    ``ssm`` (n_layers, batch, H, P, S) and ``conv`` (n_layers, batch,
    ssm_conv - 1, channels) state, whatever ``max_len``."""
    if cfg.family == "ssm":
        return {name: M2.mamba2_init_state(cfg, batch, nl, device)
                for name, nl, _ in _stacks(cfg)}
    make = A.mla_init_cache if cfg.use_mla else A.gqa_init_cache
    return {name: make(cfg, batch, max_len, nl, device)
            for name, nl, _ in _stacks(cfg)}


def decode_stacks(params, cache, x, pos, cfg: ArchConfig):
    """x (B,1,D), ``pos`` an int or a per-lane (B,) tensor -> (x, cache);
    the cache is updated in place.  MoE layers run with capacity = the
    step's token count, so no token is dropped.  An SSM layer reads no
    position: its state is the whole past."""
    for name, _, _ in _stacks(cfg):
        for p, c in zip(_layers(params[name]), _layers(cache[name])):
            if cfg.family == "ssm":
                hn = L.rmsnorm(p["ln"], x, cfg.norm_eps)
                o, ssm, conv = M2.mamba2_decode(p["ssm"], hn, c["ssm"],
                                                c["conv"], cfg)
                c["ssm"].copy_(ssm)
                c["conv"].copy_(conv)
                x = x + o
                continue
            hn = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
            if cfg.use_mla:
                o, _, _ = A.mla_decode(p["attn"], hn, c["c_kv"], c["k_rope"],
                                       pos, cfg)
            else:
                o, _, _ = A.gqa_decode(p["attn"], hn, c["k"], c["v"], pos,
                                       cfg)
            x = x + o
            hn = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
            if "moe" in p:
                y, _ = MOE.moe_apply(p["moe"], hn, cfg,
                                     capacity=hn.shape[0] * hn.shape[1])
            else:
                y = L.mlp(p["mlp"], hn)
            x = x + y
    return x, cache
