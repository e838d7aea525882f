"""Slotted KV-cache ops for continuous batching (counterpart of
``repro.serve.cache``).

Every cache leaf is laid out ``(n_layers, batch, ...)``: batch is always
dim 1 (``repro_torch.models.transformer.init_cache``), so a "lane" is one
index on dim 1 across every leaf.  Both ops write the batched cache in
place and return it (the JAX versions return new arrays).
"""

from __future__ import annotations

from repro_torch.tree import tree_map

BATCH_DIM = 1          # every cache leaf: (n_layers, batch, ...)


def lane_insert(cache, src, lane: int):
    """Write the batch-1 cache ``src`` (a freshly prefilled request) into
    slot ``lane`` of the batched ``cache``.

    Overwrites the lane's entire slice on every leaf -- positions beyond
    the prompt come from ``src``'s zero tail -- so a recycled lane needs no
    separate scrub."""
    def put(c, s):
        c.select(BATCH_DIM, lane).copy_(s.select(BATCH_DIM, 0))
        return c
    return tree_map(put, cache, src)


def lane_reset(cache, lane: int):
    """Zero slot ``lane``'s slice across every leaf."""
    def zero(c):
        c.select(BATCH_DIM, lane).zero_()
        return c
    return tree_map(zero, cache)
