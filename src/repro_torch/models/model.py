"""Top-level LM API used by the server, the trainer and the tests
(counterpart of ``repro.models.model``: the dense, MoE, SSM, hybrid, VLM
and audio families):

    model = build_model(cfg)
    params = model.init(generator, device)
    logits, aux = model.forward(params, batch)
    logits, cache = model.prefill(params, tokens, max_len)
    logits, cache = model.decode_step(params, cache, tokens, pos)

Batch conventions (the JAX package's, made by ``repro_torch.data``):
  LM            : {"tokens": (B, L), "targets": (B, L)}
  VLM           : + {"frontend": (B, F, d_frontend)}; the F projected image
                  embeddings take sequence positions [0, F), the tokens
                  the L text positions after them
  audio encoder : {"frontend": (B, L, d_frontend), "targets": (B, L)}

The parameter tree is key for key the JAX package's, so
``repro_torch.tree.params_from_numpy(jax_params)`` plugs straight in.  The
head is tied to the embedding or an untied ``lm_head``; ``forward``
returns the MoE aux terms and, for a config with ``mtp_depth``, the
multi-token-prediction logits.  The VLM and audio frontends are the JAX
package's stubs: one linear projection ``frontend_proj`` of precomputed
embeddings (the audio encoder keeps an ``embed`` table it never reads, so
the trees stay key for key).  ``prefill`` and ``decode_step`` take tokens
only (the VLM's text, as in the JAX package); the audio encoder has no
decode.

``prefill`` is ONE causal pass over the prompt, whose attention runs the
flash-attention kernel on the card (MoE layers at a capacity that drops
no token; a Mamba2 layer runs its chunked SSD, its depthwise conv on the
``tap_gemm`` kernel under ``pallas``, and caches its final state and last
conv inputs; a hybrid RG-LRU layer likewise runs its temporal conv on
``tap_gemm`` and caches its final recurrent state and last conv inputs,
and its local-window attention runs the kernel when the prompt fits the
window, the masked plain attention past it); the JAX package computes
the same result as a ``lax.scan`` of ``P`` decode steps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import tensor_parallel as TP
from repro_torch.dist.constraints import constrain_batch
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
    d = cfg.d_model
    params = {
        "embed": L.init_embedding(generator, cfg.vocab, d, cfg.dtype, device),
        "final_norm": L.init_rmsnorm(d, cfg.dtype, device=device),
    }
    params.update(T.init_stacks(generator, cfg, device))
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_linear(generator, d, cfg.vocab, cfg.dtype,
                                          device=device)
    if cfg.frontend:
        params["frontend_proj"] = L.init_linear(generator, cfg.d_frontend, d,
                                                cfg.dtype, device=device)
    if cfg.mtp_depth:
        params["mtp"] = {
            "proj": L.init_linear(generator, 2 * d, d, cfg.dtype,
                                  device=device),
            "block": T.init_attn_block(generator, cfg, cfg.mtp_depth,
                                       device=device),
            "norm_h": L.init_rmsnorm(d, cfg.dtype, device=device),
            "norm_e": L.init_rmsnorm(d, cfg.dtype, device=device),
        }
    return params


def _device(params) -> torch.device:
    return params["embed"]["w"].device


def _lm_head(params, cfg: ArchConfig, x):
    """The logits; where the head (``lm_head``, or the tied ``embed``)
    holds this rank's block of the vocabulary (the train step under
    ``tp``), this rank's logit columns, ``x`` entering the block."""
    w = params["embed" if cfg.tie_embeddings else "lm_head"]
    if TP.is_block(cfg.vocab, w["w"].shape[0 if cfg.tie_embeddings
                                           else -1]):
        x = TP.enter(x)
    if cfg.tie_embeddings:
        return L.unembed(w, x)
    return L.linear(w, x)


def _project(p, x, cfg: ArchConfig):
    """``x`` through ``frontend_proj`` or ``mtp.proj``.  Where ``p`` holds
    this rank's block of the ``d_model`` columns (the train step under
    ``tp``), ``x`` enters the block and the block's output is gathered
    over ``model`` into the replicated activations (``TP.join``: its
    grad is this rank's slice, with no sum)."""
    if not TP.is_block(cfg.d_model, p["w"].shape[-1]):
        return L.linear(p, x)
    return TP.join(L.linear(p, TP.enter(x)))


def _embed_inputs(params, batch, cfg: ArchConfig):
    """The input sequence (B, L, D): the audio encoder's projected frames;
    the VLM's projected image embeddings ahead of the token embeddings;
    else the token embeddings."""
    if cfg.family == "audio":
        return _project(params["frontend_proj"],
                        batch["frontend"].to(cfg.adtype), cfg)
    x = L.embed(params["embed"], batch["tokens"], cfg.vocab).to(cfg.adtype)
    if cfg.family == "vlm" and "frontend" in batch:
        img = _project(params["frontend_proj"],
                       batch["frontend"].to(cfg.adtype), cfg)
        x = torch.cat([img, x], dim=1)
    return x


def forward(params, batch, cfg: ArchConfig):
    """``batch`` (above) -> (logits (B, L, V), aux): ``moe_lb`` and
    ``moe_z`` summed over the MoE layers, and ``mtp_logits`` (B, L, V) for
    a config with ``mtp_depth``; ``{}`` for the other families.  The VLM's
    logits cover the text positions only: the image positions are dropped
    before the head.  In the train step on ``tp`` blocks whose plan keeps
    the vocabulary, the logits (and ``mtp_logits``) are this rank's
    columns (B, L, V / model), which ``losses.softmax_xent`` reads as
    such."""
    x = constrain_batch(_embed_inputs(params, batch, cfg))
    x, aux = T.forward_stacks(params, x, cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.family == "vlm" and "frontend" in batch:
        x = x[:, batch["frontend"].shape[1]:]
    logits = _lm_head(params, cfg, x)
    if cfg.mtp_depth and "tokens" in batch:
        aux = dict(aux, mtp_logits=_mtp_forward(params, batch, x, cfg))
    return logits, aux


def _mtp_forward(params, batch, h, cfg: ArchConfig):
    """DeepSeek-V3 multi-token prediction (depth 1, the JAX package's
    simplified structure): h'_t = W[norm(h_t); norm(E(t_{t+1}))] -> one
    block without MoE -> the shared head, predicting token t+2.  Under
    ``tp`` the projection runs on its ``d_model`` columns
    (:func:`_project`) and the block on its heads and MLP columns."""
    p = params["mtp"]
    nxt = torch.roll(batch["tokens"], -1, dims=1)
    e = L.embed(params["embed"], nxt, cfg.vocab).to(h.dtype)
    hcat = torch.cat([L.rmsnorm(p["norm_h"], h, cfg.norm_eps),
                      L.rmsnorm(p["norm_e"], e, cfg.norm_eps)], dim=-1)
    hm = _project(p["proj"], hcat, cfg)
    hm = T.attn_block(T._layers(p["block"])[0], hm, cfg)[0]
    return _lm_head(params, cfg, hm)


def decode_step(params, cache, tokens, pos, cfg: ArchConfig):
    """tokens (B,) -> (logits (B, V), cache), the cache updated in place.

    ``pos`` is an int (one shared position clock) or a per-lane (B,)
    tensor (continuous batching: every cache lane sits at its own
    position)."""
    x = constrain_batch(
        L.embed(params["embed"], tokens[:, None]).to(cfg.adtype))
    x, cache = T.decode_stacks(params, cache, x, pos, cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, cfg, x)[:, 0], cache


def prefill(params, tokens, cfg: ArchConfig, max_len: int):
    """tokens (B, P) -> (logits of position P - 1 (B, V), cache).

    One causal pass over the prompt: each layer's rope'd keys and values
    (MLA: normed latents and rope'd shared keys) go to cache positions
    ``[0, P)`` and the rest of the ``max_len`` cache stays zero -- what the
    JAX package's scan of ``P`` decode steps returns.  A Mamba2 layer
    caches its SSM state after position ``P - 1`` and its last ``ssm_conv
    - 1`` conv inputs (a ragged last SSD chunk is padded with steps that
    change nothing), the state that scan leaves.  The hybrid cache holds,
    per super-block, ``rec1``/``rec2`` (each the float32 recurrent state
    ``h`` after position ``P - 1`` and the last ``rglru_conv - 1``
    pre-conv inputs ``conv``, zero on the left of a shorter prompt) and
    ``attn``'s keys and values at ``[0, P)``, and the ``extra`` RG-LRU
    layers' ``h``/``conv``.  MoE layers run at capacity ``B * P``, which
    drops no token, as the scan's steps do.  The head runs on the last
    position only."""
    b, plen = tokens.shape
    if not 1 <= plen <= max_len:
        raise ValueError(f"prefill: prompt of {plen} tokens for a cache of "
                         f"{max_len}")
    cache = T.init_cache(cfg, b, max_len, _device(params))
    x = L.embed(params["embed"], tokens).to(cfg.adtype)
    x, _ = T.forward_stacks(params, x, cfg, cache, capacity=b * plen)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _lm_head(params, cfg, x)[:, 0], cache


def count_params(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def count_active_params(params, cfg: ArchConfig) -> int:
    """MoE: the routed experts' ``(..., E, ., .)`` weights count at
    ``top_k / E`` of their size (the JAX package's rule)."""
    if not cfg.n_experts:
        return count_params(params)
    total = 0

    def walk(tree, path):
        nonlocal total
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        if ("moe" in path and path[-2:] != ("router", "w")
                and any(k in ("wi", "wg", "wo") for k in path)
                and "shared" not in path and tree.dim() >= 3
                and tree.shape[-3] == cfg.n_experts):
            total += tree.numel() * cfg.moe_top_k // cfg.n_experts
        else:
            total += tree.numel()
    walk(params, ())
    return total


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
        active_param_count=lambda p: count_active_params(p, cfg),
    )
