"""A plain float32 Mamba2 language model, its loss and AdamW.

The model of arXiv:2405.21060 as the program trains it: per layer a
pre-norm (RMSNorm), ``in_proj`` to ``[z, x, B, C, dt]``, a causal
depthwise conv over ``[x, B, C]`` then SiLU, ``dt = softplus(dt +
dt_bias)``, the SSD with ``A = -exp(A_log)`` (one group: ``B`` and ``C``
shared by every head), the skip ``D x``, a gated RMSNorm of ``y *
silu(z)`` and ``out_proj`` back into the residual stream; a final
RMSNorm and the tied embedding as the head.  The loss is the program's:
the token cross-entropy plus ``1e-4 logz^2``, the mean over every
position.  The SSD is the chunked form of the paper's minimal listing
(``ssd_minimal_discrete``) at its own chunk length; the CPU tests hold it
to a sequential scan.

Computed in blocks so that a whole step at the cell's size fits: each
layer is recomputed in the backward (``torch.utils.checkpoint``), the
loss in blocks of rows.  Everything is float32 with TF32 off; the
parameters are stored in the types the configuration gives them, as the
program stores them.  ``precision`` is the control: every matrix
product's operands, and every activation the program holds in its
activation type (the residual stream, the norms' and projections'
outputs, the conv's, the SSD's inputs and output, the gated product, the
logits), rounded to it, the activations' grads too on the way back
(``lib.precision``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.lib.precision import cast, ste
from portbench.reference.conv import no_tf32

Z_LOSS = 1e-4
CHUNK = 64
LOSS_ROWS = 4096


def _mm(a, b, precision):
    return ste(a, precision) @ ste(b, precision)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def causal_dwconv(x, w):
    """x (B, L, C), w (K, C): ``y[t] = sum_k w[k] x[t + k - K + 1]``."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    n = x.shape[1]
    return sum(w[j] * xp[:, j:j + n] for j in range(k))


def segsum(a):
    """a (..., T) -> (..., T, T): ``sum(a[j+1..i])`` for i >= j, -inf above
    the diagonal."""
    t = a.shape[-1]
    a = a[..., None].expand(*a.shape, t)
    low = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device), -1)
    s = torch.cumsum(a.masked_fill(~low, 0), dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device))
    return s.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, B, C, chunk: int = CHUNK):
    """x (b, l, h, p), dt (b, l, h), A (h,), B, C (b, l, n) -> y (b, l, h, p)
    of the recurrence ``s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t``, ``y_t =
    C_t s_t``, from a zero state."""
    b, l, h, p = x.shape
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"length {l} is not a multiple of the chunk {q}")
    c = l // q
    X = (x * dt[..., None]).reshape(b, c, q, h, p)
    a = (A[None, None, :] * dt).reshape(b, c, q, h).permute(0, 3, 1, 2)
    Bc = B.reshape(b, c, q, -1)
    Cc = C.reshape(b, c, q, -1)
    cum = torch.cumsum(a, dim=-1)                        # (b, h, c, q)
    L = torch.exp(segsum(a))                             # (b, h, c, q, q)
    cb = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", cb[:, None] * L, X)
    decay = torch.exp(cum[..., -1:] - cum)               # (b, h, c, q)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states,
                         torch.exp(cum))
    return (y_diag + y_off).reshape(b, l, h, p)


def _layer(x, ln, in_proj, conv_w, a_log, dt_bias, d_skip, norm, out_proj,
           *, sizes, eps, precision):
    di, ds, h = sizes["d_inner"], sizes["d_state"], sizes["heads"]
    b, l, _ = x.shape

    def q(t):
        return cast(t, precision)
    zxbcdt = q(_mm(q(rmsnorm(x, ln, eps)), in_proj, precision))
    z, xs, Bm, Cm, dt = torch.split(zxbcdt, [di, di, ds, ds, h], dim=-1)
    xbc = q(F.silu(q(causal_dwconv(torch.cat([xs, Bm, Cm], -1), conv_w))))
    xs, Bm, Cm = torch.split(xbc, [di, ds, ds], dim=-1)
    dt = F.softplus(dt + dt_bias)
    xh = xs.reshape(b, l, h, di // h)
    y = q(ssd(xh, dt, -torch.exp(a_log), Bm, Cm))
    y = q((y + xh * d_skip[:, None]).reshape(b, l, di))
    y = q(rmsnorm(q(y * F.silu(z)), norm, sizes["gated_norm_eps"]))
    return q(x + q(_mm(y, out_proj, precision)))


_LAYER_LEAVES = ("blocks/ln/scale", "blocks/ssm/in_proj/w",
                 "blocks/ssm/conv_w/w", "blocks/ssm/a_log/w",
                 "blocks/ssm/dt_bias/w", "blocks/ssm/d_skip/w",
                 "blocks/ssm/norm/scale", "blocks/ssm/out_proj/w")


def _rows_loss(x, final_norm, embed, targets, eps, precision):
    logits = cast(_mm(cast(rmsnorm(x, final_norm, eps), precision), embed.T,
                      precision), precision)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[:, None])[:, 0]
    return (logz - gold + Z_LOSS * logz * logz).sum()


def loss(p: dict, tokens, targets, sizes: dict, eps: float,
         precision: str | None = None):
    """The mean loss of a batch; ``p`` maps each path to a float32 leaf."""
    x = cast(p["embed/w"][tokens], precision)
    for i in range(sizes["layers"]):
        x = checkpoint(_layer, x, *(p[k][i] for k in _LAYER_LEAVES),
                       sizes=sizes, eps=eps, precision=precision,
                       use_reentrant=False)
    x = x.reshape(-1, x.shape[-1])
    t = targets.reshape(-1).long()
    total = 0.0
    for s in range(0, x.shape[0], LOSS_ROWS):
        total = total + checkpoint(
            _rows_loss, x[s:s + LOSS_ROWS], p["final_norm/scale"],
            p["embed/w"], t[s:s + LOSS_ROWS], eps, precision,
            use_reentrant=False)
    return total / x.shape[0]


def lr_at(step: int, opt: dict) -> float:
    """The warmup-cosine schedule (the program's default for this model) at
    1-based ``step``."""
    peak, warm, total = opt["peak_lr"], opt["warmup"], opt["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


class Trainer:
    """AdamW from ``params`` (``{path: leaf}`` in their stored types), a
    batch a :meth:`step`, the program's arithmetic: the grads clipped to
    the global norm ``clip_norm``, float32 moments, bias corrections,
    decoupled weight decay on every leaf, the new value stored in the
    leaf's type.  ``first`` holds each leaf's first gradient norm as the
    update took it (after the clip), ``first_raw`` the first gradient's
    global norm before the clip."""

    def __init__(self, params: dict, sizes: dict, eps: float, opt: dict,
                 precision: str | None = None):
        self.sizes, self.eps, self.opt = sizes, eps, opt
        self.precision = precision
        self.stored = {k: v.clone() for k, v in params.items()}
        self.m = {k: torch.zeros(v.shape, dtype=torch.float32,
                                 device=v.device) for k, v in params.items()}
        self.v = {k: torch.zeros_like(t) for k, t in self.m.items()}
        self.n = 0
        self.first = None
        self.first_raw = None

    def step(self, tokens, targets) -> float:
        opt = self.opt
        b1, b2 = opt["b1"], opt["b2"]
        self.n += 1
        with no_tf32():
            leaves = {k: t.detach().to(torch.float32, copy=True)
                      .requires_grad_(True) for k, t in self.stored.items()}
            lv = loss(leaves, tokens, targets, self.sizes, self.eps,
                      self.precision)
            names = sorted(leaves)
            grads = torch.autograd.grad(lv, [leaves[k] for k in names])
            value = float(lv.detach())
            del lv, leaves
            with torch.no_grad():
                gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = torch.clamp(opt["clip_norm"] / torch.clamp(
                    gnorm, min=1e-9), max=1.0)
                if self.first is None:
                    self.first_raw = float(gnorm)
                    self.first = {
                        k: float(torch.linalg.vector_norm(g) * scale)
                        for k, g in zip(names, grads)}
                lr = lr_at(self.n, opt)
                b1c, b2c = 1 - b1 ** self.n, 1 - b2 ** self.n
                for k, g in zip(names, grads):
                    g = g * scale
                    self.m[k] = b1 * self.m[k] + (1 - b1) * g
                    self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
                    p32 = self.stored[k].float()
                    delta = (self.m[k] / b1c) / (
                        torch.sqrt(self.v[k] / b2c) + opt["eps"]) \
                        + opt["weight_decay"] * p32
                    self.stored[k] = (p32 - lr * delta).to(
                        self.stored[k].dtype)
        return value


def train(params: dict, batches, sizes: dict, eps: float, opt: dict,
          precision: str | None = None) -> dict:
    """:class:`Trainer` over ``batches`` (``[(tokens, targets)]``): each
    step's loss, the first gradient's global norm before the clip, each
    leaf's first gradient norm as the update took it, and each leaf's
    change after the last step, as ``{path: float}``."""
    t = Trainer(params, sizes, eps, opt, precision)
    losses = [t.step(tokens, targets) for tokens, targets in batches]
    change = {k: float(torch.linalg.vector_norm(
        t.stored[k].float() - params[k].float())) for k in params}
    return {"losses": losses, "raw_grad_norm": t.first_raw,
            "grad_norms": t.first, "change_norms": change}
