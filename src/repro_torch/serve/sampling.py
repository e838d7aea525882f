"""Token sampling on the device for the serving engines (counterpart of
``repro.serve.sampling``): the host receives B token ids per step, never the
(B, V) logits.

Greedy (temperature 0) is ``argmax``, which takes the first maximum as
``jnp.argmax`` does.  Temperature sampling draws one batched categorical
per step from a ``torch.Generator`` on the logits' device seeded by
``seed`` (the JAX engines split a ``PRNGKey``; the two draw different
numbers from one seed).
"""

from __future__ import annotations

import torch


def make_sampler(temperature: float, seed: int = 0, device=None):
    """``logits (B, V) -> token ids (B,)`` (int64, on the logits' device)."""
    if temperature <= 0:
        return lambda logits: torch.argmax(logits, dim=-1)
    t = float(temperature)
    gen = torch.Generator(device=device).manual_seed(seed)

    def sample(logits):
        probs = torch.softmax(logits.float() / t, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
    return sample
