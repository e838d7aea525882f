"""Top-level LM API used by the server and the tests (counterpart of
``repro.models.model``, the token path of the dense family):

    model = build_model(cfg)
    params = model.init(generator, device)
    logits, aux = model.forward(params, {"tokens": tokens})
    logits, cache = model.prefill(params, tokens, max_len)
    logits, cache = model.decode_step(params, cache, tokens, pos)

The parameter tree is key for key the JAX package's, so
``repro_torch.tree.params_from_numpy(jax_params)`` plugs straight in.  The
head is tied to the embedding (an untied head, frontends and multi-token
prediction come with ROADMAP A10).

``prefill`` is ONE causal pass over the prompt, whose attention runs the
flash-attention kernel on the card; the JAX package computes the same
result as a ``lax.scan`` of ``P`` decode steps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]
    forward: Callable[..., Any]
    init_cache: Callable[..., Any]
    decode_step: Callable[..., Any]
    prefill: Callable[..., Any]
    param_count: Callable[[Any], int]
    active_param_count: Callable[[Any], int]


def init_params(generator: torch.Generator, cfg: ArchConfig, device=None):
    if not cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: an untied LM head is not "
                                  f"ported yet (ROADMAP A10)")
    params = {
        "embed": L.init_embedding(generator, cfg.vocab, cfg.d_model,
                                  cfg.dtype, device),
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.dtype, device=device),
    }
    params.update(T.init_stacks(generator, cfg, device))
    return params


def _device(params) -> torch.device:
    return params["embed"]["w"].device


def forward(params, batch, cfg: ArchConfig):
    """``batch["tokens"]`` (B, L) -> (logits (B, L, V), aux {})."""
    x = L.embed(params["embed"], batch["tokens"]).to(cfg.adtype)
    x = T.forward_stacks(params, x, cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x), {}


def decode_step(params, cache, tokens, pos, cfg: ArchConfig):
    """tokens (B,) -> (logits (B, V), cache), the cache updated in place.

    ``pos`` is an int (one shared position clock) or a per-lane (B,)
    tensor (continuous batching: every cache lane sits at its own
    position)."""
    x = L.embed(params["embed"], tokens[:, None]).to(cfg.adtype)
    x, cache = T.decode_stacks(params, cache, x, pos, cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x)[:, 0], cache


def prefill(params, tokens, cfg: ArchConfig, max_len: int):
    """tokens (B, P) -> (logits of position P - 1 (B, V), cache).

    One causal pass over the prompt: each layer's rope'd keys and values
    go to cache positions ``[0, P)`` and the rest of the ``max_len`` cache
    stays zero -- what the JAX package's scan of ``P`` decode steps
    returns.  The head runs on the last position only."""
    b, plen = tokens.shape
    if not 1 <= plen <= max_len:
        raise ValueError(f"prefill: prompt of {plen} tokens for a cache of "
                         f"{max_len}")
    cache = T.init_cache(cfg, b, max_len, _device(params))
    x = L.embed(params["embed"], tokens).to(cfg.adtype)
    x = T.forward_stacks(params, x, cfg, cache)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return L.unembed(params["embed"], x)[:, 0], cache


def count_params(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def build_model(cfg: ArchConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda generator, device=None: init_params(generator, cfg,
                                                        device),
        forward=lambda params, batch: forward(params, batch, cfg),
        init_cache=lambda batch, max_len, device=None: T.init_cache(
            cfg, batch, max_len, device),
        decode_step=lambda params, cache, tok, pos: decode_step(
            params, cache, tok, pos, cfg),
        prefill=lambda params, tokens, max_len: prefill(
            params, tokens, cfg, max_len),
        param_count=count_params,
        # A token activates every parameter of the dense family (the MoE
        # share of the JAX package's count comes with ROADMAP A10).
        active_param_count=count_params,
    )
