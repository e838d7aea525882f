"""Mixture-of-Experts with GShard-style grouped capacity dispatch
(counterpart of ``repro.models.moe``).

Tokens are partitioned into groups of ~``MOE_GROUP_TOKENS``; each group
routes independently with capacity ``S * top_k * capacity_factor / E``
(a token past its expert's capacity is dropped), or with the ``capacity``
the caller gives: decode steps and the one-pass prefill pass the token
count, so that no token is dropped.  The router and its softmax run in
float32; each token's top-k gates are renormalised; the choice waves queue
one after another per expert.  The ``(G, S, E, C)`` combine tensor is
built wave by wave, each wave scattering its gates into it (no wave's
``(G, S, E, C)`` one-hot is made), and every expert runs its ``C`` slots
through dense ``torch.einsum``s, as the JAX package computes them (outside any
kernel); shared experts add a plain SwiGLU MLP.

Aux terms: the Switch-style load balance ``moe_lb`` and the router z-loss
``moe_z``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

MOE_GROUP_TOKENS = 512


def init_moe(generator: torch.Generator, cfg: ArchConfig, nl=None,
             device=None):
    """Router (float32, as in the JAX package), the experts' stacked
    ``(E, d, f)``/``(E, f, d)`` SwiGLU weights and the shared experts."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    shape = lambda *s: s if nl is None else (nl, *s)  # noqa: E731
    p = {
        "router": L.init_linear(generator, d, e, torch.float32, nl,
                                device=device),
        "wi": {"w": L._draw(generator, shape(e, d, f), d ** -0.5, cfg.dtype,
                            device)},
        "wg": {"w": L._draw(generator, shape(e, d, f), d ** -0.5, cfg.dtype,
                            device)},
        "wo": {"w": L._draw(generator, shape(e, f, d), f ** -0.5, cfg.dtype,
                            device)},
    }
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(generator, d,
                                 cfg.moe_d_ff * cfg.n_shared_experts,
                                 cfg.dtype, nl, device)
    return p


def _group(t: int) -> int:
    """Largest group count G dividing t with t/G <= MOE_GROUP_TOKENS."""
    g = max(1, t // MOE_GROUP_TOKENS)
    while t % g:
        g -= 1
    return g


def moe_apply(p, x, cfg: ArchConfig, capacity: int | None = None):
    """x (B, L, D) -> (out (B, L, D), aux {"moe_lb", "moe_z"})."""
    b, l, d = x.shape
    t = b * l
    e, k = cfg.n_experts, cfg.moe_top_k
    g = _group(t)
    s = t // g
    cap = capacity or max(1, int(s * k * cfg.capacity_factor / e))
    cap = min(cap, s)
    xg = x.reshape(g, s, d)

    logits = L.linear(p["router"], xg.float())                    # (G,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)            # (G,S,k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # Capacity bookkeeping: choice waves queue sequentially per expert.  A
    # token's k experts are distinct, so each (s, e) takes at most one
    # gate: scattering it (0 where the slot overflows) gives the JAX
    # package's sum of per-wave one-hots exactly.
    combine = torch.zeros((g, s, e, cap), dtype=torch.float32,
                          device=x.device)
    prior = torch.zeros((g, 1, e), dtype=torch.int64, device=x.device)
    for choice in range(k):
        oh = F.one_hot(gate_idx[..., choice], e)                   # (G,S,E)
        pos = torch.cumsum(oh, dim=1) - 1 + prior
        prior = prior + oh.sum(1, keepdim=True)
        keep = (pos < cap) & (oh > 0)
        gate = torch.where(keep, gate_vals[..., choice, None], 0.0)
        combine.scatter_add_(-1, pos.clamp(0, cap - 1)[..., None],
                             gate[..., None])
        del oh, pos, keep, gate
    dispatch = (combine > 0).to(x.dtype)                          # (G,S,E,C)
    combine = combine.to(x.dtype)

    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)             # (G,E,C,D)
    del dispatch
    hi = torch.einsum("gecd,edf->gecf", xe, p["wi"]["w"].to(x.dtype))
    hg = torch.einsum("gecd,edf->gecf", xe, p["wg"]["w"].to(x.dtype))
    del xe
    ye = torch.einsum("gecf,efd->gecd", F.silu(hg) * hi,
                      p["wo"]["w"].to(x.dtype))
    del hi, hg
    out = torch.einsum("gsec,gecd->gsd", combine, ye)

    if "shared" in p:
        out = out + L.mlp(p["shared"], xg)

    frac_tokens = F.one_hot(gate_idx[..., 0], e).float().mean((0, 1))
    mean_prob = probs.mean((0, 1))
    lb_loss = e * torch.sum(frac_tokens * mean_prob)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return out.reshape(b, l, d), {"moe_lb": lb_loss, "moe_z": z_loss}
