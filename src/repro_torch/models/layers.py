"""Primitive layers: linear / norm / embedding / RoPE / SwiGLU / conv2d
(counterpart of ``repro.models.layers``).

``init_*`` builds a parameter dict (optionally with a stacked leading
layer dim ``L``, the layout the JAX package scans over), ``*_apply`` and
the plain names consume it.  Init draws from an explicit
``torch.Generator`` onto ``device`` (default: the card; see :func:`_draw`
for how the card draws).  ``rmsnorm`` and ``apply_rope``
compute in float32 and cast back to the input's type, as the JAX layers do.

Conv layers go through ``repro_torch.core.conv2d`` and
``conv2d_transpose``, so every pass runs the engines selected by the
per-pass ``policy``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import conv as C
from repro_torch.core.convspec import ConvSpec, ConvTransposeSpec
from repro_torch.device import resolve_device


def init_conv2d(generator: torch.Generator, c_in: int, c_out: int, k,
                dtype=torch.float32, groups: int = 1, device=None):
    """OIHW conv kernel with fan-in scaling; ``k`` is an int or (kh, kw),
    drawn from ``generator`` onto ``device`` (default: the card)."""
    kh, kw = (k, k) if isinstance(k, int) else k
    if c_in % groups or c_out % groups:
        raise ValueError(f"channels {c_in}->{c_out} not divisible by "
                         f"groups={groups}")
    return _init_kernel(generator, (c_out, c_in // groups, kh, kw),
                        (c_in // groups) * kh * kw, dtype, device)


def _loose(spec, spec_cls, **kw):
    """The spec, or one built from the loose geometry kwargs (not both)."""
    loose = {k: v for k, v in kw.items() if v is not None}
    if spec is None:
        return spec_cls.make(**loose)
    if loose:
        raise TypeError(f"geometry given both in spec= and as kwargs "
                        f"{sorted(loose)}; put it all in the spec")
    return spec


def _init_kernel(generator, shape, fan_in: int, dtype, device):
    """A fan-in scaled conv kernel."""
    return {"w": _draw(generator, shape, fan_in ** -0.5, dtype, device)}


def init_conv2d_transpose(generator: torch.Generator, c_in: int, c_out: int,
                          k, dtype=torch.float32, groups: int = 1,
                          device=None):
    """Transposed-conv kernel ``(C_in, C_out/g, kh, kw)`` (the mirror conv's
    OIHW weight with in/out roles swapped), fan-in scaled over the taps
    feeding one output pixel; drawn like :func:`init_conv2d`."""
    kh, kw = (k, k) if isinstance(k, int) else k
    if c_in % groups or c_out % groups:
        raise ValueError(f"channels {c_in}->{c_out} not divisible by "
                         f"groups={groups}")
    return _init_kernel(generator, (c_in, c_out // groups, kh, kw),
                        (c_in // groups) * kh * kw, dtype, device)


def conv2d_transpose_apply(p, x, *, spec: ConvTransposeSpec | None = None,
                           policy=None, stride=None, padding=None,
                           output_padding=None, dilation=None, groups=None):
    """x (B, C_in, H, W) -> (B, C_out, H_out, W_out) transposed conv through
    the selected engines (decoders, upsampling heads).  ``spec`` carries
    the full geometry; without it the loose kwargs build one."""
    spec = _loose(spec, ConvTransposeSpec, stride=stride, padding=padding,
                  output_padding=output_padding, dilation=dilation,
                  groups=groups)
    return C.conv2d_transpose(x, p["w"].to(x.dtype), spec, policy)


def conv2d_apply(p, x, *, spec: ConvSpec | None = None, policy=None,
                 stride=None, padding=None, dilation=None, groups=None):
    """x (B, C, H, W) -> (B, N, H_o, W_o) through the selected engines.

    ``spec`` carries the full geometry; without it the loose kwargs build
    one.  ``policy`` selects the engine per pass (EnginePolicy, policy
    string, engine name, or None for auto)."""
    spec = _loose(spec, ConvSpec, stride=stride, padding=padding,
                  dilation=dilation, groups=groups)
    return C.conv2d(x, p["w"].to(x.dtype), spec, policy)


# ---------------------------------------------------------------------------
# Linear / norm / embedding
# ---------------------------------------------------------------------------

def _stack(shape, L):
    return tuple(shape) if L is None else (L, *shape)


#: elements a CUDA draw makes at a time (1 GiB of float32).
DRAW_CHUNK = 1 << 28


def _draw(generator, shape, scale, dtype, device):
    """``scale`` x a standard normal of ``shape`` in ``dtype`` on ``device``.

    On the CPU, float32 draws from ``generator`` itself.  On the card, a
    CUDA generator seeded from one draw of ``generator`` fills the tensor,
    allocated in ``dtype``, ``DRAW_CHUNK`` float32 elements at a time: the
    28.4 B parameters of moonshot-v1-16b-a3b take 0.2 s on an H100, where
    one host generator would draw them one after another, and no float32
    copy of a whole leaf (34.7 GB for its experts) is ever made.  So the
    values follow from the seed on each device, but differ between the CPU
    and the card (the tests carry the JAX package's parameters across
    instead)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * scale).to(dtype)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = torch.empty(shape, dtype=dtype, device=dev)
    flat = out.view(-1)
    for start in range(0, flat.numel(), DRAW_CHUNK):
        n = min(DRAW_CHUNK, flat.numel() - start)
        flat[start:start + n] = torch.randn(n, generator=gen,
                                            device=dev) * scale
    return out


def init_linear(generator: torch.Generator, d_in: int, d_out: int, dtype,
                L=None, scale=None, device=None):
    scale = d_in ** -0.5 if scale is None else scale
    return {"w": _draw(generator, _stack((d_in, d_out), L), scale, dtype,
                       device)}


def linear(p, x):
    return x @ p["w"].to(x.dtype)


def init_rmsnorm(d: int, dtype, L=None, device=None):
    return {"scale": torch.ones(_stack((d,), L), dtype=dtype,
                                device=resolve_device(device))}


def rmsnorm(p, x, eps: float = 1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def init_embedding(generator: torch.Generator, vocab: int, d: int, dtype,
                   device=None):
    return {"w": _draw(generator, (vocab, d), 0.02, dtype, device)}


def embed(p, ids):
    return p["w"][ids]


def unembed(p, x):
    """Logits from the (tied) embedding matrix."""
    return x @ p["w"].to(x.dtype).T


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """positions (L,) -> (L, head_dim/2) angles, in float32."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=positions.device) / half))
    return positions.float()[:, None] * inv[None, :]


def apply_rope(x: torch.Tensor, angles: torch.Tensor):
    """x (..., L, H, D) with angles (..., L, D/2): rotate the two halves."""
    half = x.shape[-1] // 2
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, d: int, f: int, dtype, L=None,
             device=None):
    return {
        "wi": init_linear(generator, d, f, dtype, L, device=device),  # up
        "wg": init_linear(generator, d, f, dtype, L, device=device),  # gate
        "wo": init_linear(generator, f, d, dtype, L, scale=f ** -0.5,
                          device=device),
    }


def mlp(p, x):
    return linear(p["wo"], F.silu(linear(p["wg"], x)) * linear(p["wi"], x))
