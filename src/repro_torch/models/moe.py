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

Inside a batch block of the train step (``repro_torch.dist.constraints
.current_block``: this rank holds rows ``[r B/n, (r + 1) B/n)`` of the
global batch, ``n`` the blocks of the split), the layer computes what
JAX's single-device step computes on the global batch:

  * the group count ``G``, the group size ``S`` and the capacity come from
    the global token count ``t = B L`` (:func:`_span`).  Rank ``r`` holds
    tokens ``[r t/n, (r + 1) t/n)`` of the row-major ``(B, L)`` order,
    which fall into one or more global groups (:func:`_layout`): whole
    groups, a piece of one group that spans every rank, or pieces of two;
  * a token's slot in its expert's queue depends on every earlier token of
    its group, so the routing choices (``gate_idx``, int, no grad) of the
    whole batch are gathered over the batch axes in the mesh's order; each
    rank queues its groups' choices wave by wave and keeps the slots of
    its own tokens only.  The groups are laid out with this rank's tokens
    at their places and zeros elsewhere, so the expert einsums run on the
    slots its tokens fill (a slot of another rank's token stays empty, and
    a token's output reads only its own slots);
  * the aux terms are this rank's SHARES (:func:`_aux_shares`): the top-1
    fractions ``frac`` of the whole batch (from the gathered choices),
    ``moe_lb`` as ``E sum_e frac_e (this rank's sum of probs_e) / t`` and
    ``moe_z`` as this rank's sum of ``lse^2`` over ``t``.  The step sums
    the loss, its metrics and the grads over the batch axes, so the shares
    add up to JAX's terms and their grads.

Inside the train step on ``tp`` blocks whose plan keeps the experts
(expert parallelism: E over ``model``), the router is whole and the
routing, capacity and queues are computed on every ``model`` rank as
above (the same inputs, so the same bits); each rank slices ``dispatch``
and ``combine`` to its E / model experts and runs the three expert
einsums on them only (the gates and tokens entering the block,
``repro_torch.dist.tensor_parallel.enter``), adds the shared experts'
partial output of its ``d_ff`` columns, and sums the output over
``model``.

Under remat the block runs again in the backward, and so does the gather:
every rank recomputes its blocks in the same order, and the recomputed
choices are the forward's (the same inputs through the same ops).
Outside a block ``n = 1`` and nothing is gathered.  :func:`recording`
lets a caller read each call's routing (the experts and the kept choices
of this rank's tokens, and the count of experts its einsums ran).

Aux terms: the Switch-style load balance ``moe_lb`` and the router z-loss
``moe_z``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import constraints
from repro_torch.dist import tensor_parallel as TP
from repro_torch.dist.sharding import P, from_local
from repro_torch.models import layers as L

MOE_GROUP_TOKENS = 512

#: the logs of the :func:`recording` blocks open, innermost last.
_LOGS: list[list] = []


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


def _span(t_loc: int) -> tuple[int, int]:
    """``(t, first)``: the batch's token count and the index of this
    rank's first token in its row-major order; ``(t_loc, 0)`` outside a
    batch block."""
    blk = constraints.current_block()
    if blk is None:
        return t_loc, 0
    n, r = blk.index()
    return t_loc * n, r * t_loc


def _layout(t: int, first: int, t_loc: int) -> tuple[int, int, int]:
    """``(s, base, g)``: the group size of ``t`` tokens, the first token of
    the first group that tokens ``[first, first + t_loc)`` touch, and the
    count of groups they touch."""
    s = t // _group(t)
    g0 = first // s
    return s, g0 * s, -(-(first + t_loc) // s) - g0


def _aux_shares(logits, probs, top1, t: int) -> dict:
    """This rank's shares of ``moe_lb`` and ``moe_z`` (module docstring):
    ``logits`` and ``probs`` (t_loc, E) of its tokens, ``top1`` (t,) the
    top-1 expert of every token of the batch."""
    e = probs.shape[-1]
    frac = F.one_hot(top1, e).float().sum(0) / t
    lb = e * torch.sum(frac * probs.sum(0) / t)
    z = torch.sum(torch.logsumexp(logits, dim=-1) ** 2) / t
    return {"moe_lb": lb, "moe_z": z}


@contextlib.contextmanager
def recording():
    """Each :func:`moe_apply` inside appends ``{"first", "experts",
    "kept", "experts_computed"}`` to the yielded list: the index of this
    rank's first token in the batch, its tokens' experts ``(t_loc, k)``
    and which of those choices found a slot (bool), both detached, and
    how many experts the einsums ran (E, or E / model on a block).  Under remat a block's
    layers log again in the backward, after every forward call."""
    log: list = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def moe_apply(p, x, cfg: ArchConfig, capacity: int | None = None):
    """x (B, L, D) -> (out (B, L, D), aux {"moe_lb", "moe_z"}); inside a
    batch block, ``x`` is this rank's rows and aux its shares (module
    docstring)."""
    b, l, d = x.shape
    t_loc = b * l
    e, k = cfg.n_experts, cfg.moe_top_k
    t, first = _span(t_loc)
    s, base, g = _layout(t, first, t_loc)
    cap = capacity or max(1, int(s * k * cfg.capacity_factor / e))
    cap = min(cap, s)
    xf = x.reshape(t_loc, d)
    e_have = p["wi"]["w"].shape[-3]
    cut = TP.is_block(e, e_have)

    logits = L.linear(p["router"], xf.float())                    # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)            # (T,k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    if cut:
        # The experts' compute starts here: the gates and the tokens
        # enter the block, so their grads (each rank's experts' share)
        # are summed over model before they reach the router.
        gate_vals, xe_in = TP.enter(gate_vals), TP.enter(xf)
    else:
        xe_in = xf
    # Every token's choices when the batch is cut, in the batch's order.
    blk = constraints.current_block()
    every = gate_idx if t == t_loc else from_local(
        gate_idx, P(blk.axes), blk.mesh)                          # (t,k)

    # This rank's tokens at their places in the groups they touch.
    lo = first - base

    def place(y):
        return F.pad(y, (0, 0, lo, g * s - lo - t_loc)).reshape(
            g, s, *y.shape[1:])
    xg = place(xe_in)                                             # (G,S,D)
    gates = place(gate_vals)                                      # (G,S,k)
    own = place(torch.ones((t_loc, 1), dtype=torch.bool, device=x.device))
    idx = every[base:base + g * s].reshape(g, s, k)

    # Capacity bookkeeping: choice waves queue sequentially per expert,
    # over every token of the group.  A token's k experts are distinct,
    # so each (s, e) takes at most one gate: scattering it (0 where the
    # slot overflows or the token is another rank's) gives the JAX
    # package's sum of per-wave one-hots exactly.
    combine = torch.zeros((g, s, e, cap), dtype=torch.float32,
                          device=x.device)
    prior = torch.zeros((g, 1, e), dtype=torch.int64, device=x.device)
    kept = []
    for choice in range(k):
        oh = F.one_hot(idx[..., choice], e)                        # (G,S,E)
        pos = torch.cumsum(oh, dim=1) - 1 + prior
        prior = prior + oh.sum(1, keepdim=True)
        keep = (pos < cap) & (oh > 0) & own
        gate = torch.where(keep, gates[..., choice, None], 0.0)
        combine.scatter_add_(-1, pos.clamp(0, cap - 1)[..., None],
                             gate[..., None])
        if _LOGS:
            kept.append(keep.any(-1).reshape(g * s)[lo:lo + t_loc])
        del oh, pos, keep, gate
    if cut:
        e0 = TP.first(e_have)                    # this rank's experts
        combine = combine[:, :, e0:e0 + e_have]
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
    if cut:
        # This rank's experts' partial sums, in float32 (rounded once,
        # after the sum over model, as the whole contraction is).
        combine, ye = combine.float(), ye.float()
    out = torch.einsum("gsec,gecd->gsd", combine, ye)
    out = out.reshape(g * s, d)[lo:lo + t_loc]

    if "shared" in p:
        f = cfg.moe_d_ff * cfg.n_shared_experts
        if cut and TP.is_block(f, p["shared"]["wi"]["w"].shape[-1]):
            # Its columns' partial output joins the experts' sum.
            out = out + L.swiglu(p["shared"], xe_in, partial=True)
        else:
            shared = L.mlp(p["shared"], xf, f)
            out = TP.leave(out).to(x.dtype) + shared if cut \
                else out + shared
            cut = False
    if cut:
        out = TP.leave(out).to(x.dtype)

    for log in _LOGS:
        log.append({"first": first, "experts": gate_idx.detach(),
                    "kept": torch.stack(kept, -1),
                    "experts_computed": e_have})
    return out.reshape(b, l, d), _aux_shares(logits, probs, every[:, 0], t)
