"""Deterministic, restartable data pipeline (the port's copy of
``repro.data.pipeline``, numpy and hashlib only: for every (seed, step,
worker) its batches equal the JAX package's element for element).

Production posture without external deps:
  * a synthetic corpus backend (seeded, infinite) and a packed-binary file
    backend (memory-mapped token shards) behind one interface;
  * deterministic sharding: worker w of W reads only batch indices
    ``i * W + w`` -- restart-safe because the batch for global step s is a
    pure function of (seed, s), enabling exact skip-ahead after failure
    (no replayed or skipped samples);
  * per-family batch assembly matching the model's batch conventions.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterator, Optional

import numpy as np



@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    seq_len: int = 512
    global_batch: int = 8
    vocab: int = 256
    worker: int = 0
    n_workers: int = 1
    corpus_path: Optional[str] = None     # packed .npy token shard (optional)


def _rng_for_step(cfg: DataConfig, step: int) -> np.random.Generator:
    # Stable across restarts and independent per step.
    digest = hashlib.sha256(f"{cfg.seed}:{step}".encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:8], "little"))


class TokenSource:
    """Synthetic or file-backed token stream, step-addressable."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._tokens = None
        if cfg.corpus_path:
            self._tokens = np.load(cfg.corpus_path, mmap_mode="r")

    def batch_tokens(self, step: int, batch: int, seq: int) -> np.ndarray:
        cfg = self.cfg
        if self._tokens is None:
            # Learnable synthetic stream: x[t+1] = x[t] + pattern[t % P]
            # (pattern fixed by the corpus seed), with 10% noise tokens.
            # A model that learns the transition rule reaches low CE fast;
            # the noise floor keeps it non-degenerate.
            pat_rng = np.random.default_rng(cfg.seed)
            pattern = pat_rng.integers(1, 17, size=8)
            rng = _rng_for_step(cfg, step)
            base = rng.integers(0, cfg.vocab, (batch, 1))
            deltas = np.tile(pattern, (batch, (seq + 8) // 8 + 1))[:, :seq]
            toks = (base + np.concatenate(
                [np.zeros((batch, 1), np.int64),
                 np.cumsum(deltas, axis=1)], axis=1)) % cfg.vocab
            noise_mask = rng.random((batch, seq + 1)) < 0.10
            noise = rng.integers(0, cfg.vocab, (batch, seq + 1))
            toks = np.where(noise_mask, noise, toks)
            return toks.astype(np.int32)
        n = self._tokens.shape[0]
        rng = _rng_for_step(cfg, step)
        starts = rng.integers(0, n - seq - 1, (batch,))
        return np.stack([self._tokens[s:s + seq + 1] for s in starts]) \
            .astype(np.int32)


def make_batch(arch, dcfg: DataConfig, step: int) -> dict:
    """Assemble a host batch (numpy) for this worker's shard of the step.

    ``arch`` is read for ``family`` and ``vocab`` (and, for the vlm and
    audio branches, ``d_frontend`` and ``frontend_tokens``)."""
    assert dcfg.global_batch % dcfg.n_workers == 0
    local_b = dcfg.global_batch // dcfg.n_workers
    src = TokenSource(dataclasses.replace(dcfg, vocab=arch.vocab))
    rng = _rng_for_step(dcfg, step * 1000003 + dcfg.worker)

    if arch.family == "audio":
        frames = rng.standard_normal(
            (local_b, dcfg.seq_len, arch.d_frontend)).astype(np.float32)
        targets = rng.integers(0, arch.vocab,
                               (local_b, dcfg.seq_len)).astype(np.int32)
        return {"frontend": frames, "targets": targets}

    if arch.family == "vlm":
        f = arch.frontend_tokens
        text_len = dcfg.seq_len - f
        toks = src.batch_tokens(step, local_b, text_len)
        front = rng.standard_normal(
            (local_b, f, arch.d_frontend)).astype(np.float32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                "frontend": front}

    toks = src.batch_tokens(step, local_b, dcfg.seq_len)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def batches(arch, dcfg: DataConfig,
            start_step: int = 0) -> Iterator[dict]:
    """Infinite restartable iterator: resume by passing the restored step."""
    step = start_step
    while True:
        yield make_batch(arch, dcfg, step)
        step += 1
