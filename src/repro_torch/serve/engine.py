"""Batched serving engine: wave-batched decode over a shared KV cache
(counterpart of ``repro.serve.engine``).

The engine admits up to ``max_batch`` requests per wave.  Prompts in a wave
are left-padded to a common length, prefilled in lockstep through the
decode path (one position clock for the wave, plain dense attention), then
decoded greedily or sampled until every request finishes.  New waves are
admitted as the queue refills.  It is the lockstep baseline the continuous
engine (:mod:`repro_torch.serve.continuous`) is compared against.

``conv_policy`` pins the per-pass conv engines of the served model (a
Mamba2 layer's depthwise conv), as in the JAX engine.  The JAX engine's
observability spans, events and metrics are left out (ROADMAP A12).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.serve.request import Request
from repro_torch.serve.sampling import make_sampler

__all__ = ["Engine", "Request", "SUMMARY_COUNTERS", "merged_summary"]

#: the shared counter vocabulary of both engines' run_summary: every key is
#: present in every summary (0 when the engine has no such phase -- the
#: static engine never "inserts", the continuous engine has no "waves").
SUMMARY_COUNTERS = ("completed", "timed_out", "failed", "admitted",
                    "inserts", "waves", "decode_steps")


def merged_summary(engine_kind: str, counters: dict, stats: dict) -> dict:
    """One flat summary dict merging lifetime ``counters`` and phase
    ``stats`` (prefill_s/decode_s/tokens...), under the shared
    :data:`SUMMARY_COUNTERS` vocabulary."""
    out: dict = {"engine_kind": engine_kind}
    for key in SUMMARY_COUNTERS:
        out[key] = counters.get(key, 0)
    for key, val in counters.items():
        out.setdefault(key, val)
    for key, val in stats.items():
        out[key] = round(val, 6) if isinstance(val, float) else val
    return out


def with_conv_policy(cfg: ArchConfig, conv_policy) -> ArchConfig:
    """``cfg`` with its conv policy pinned to ``conv_policy`` (the
    deprecated ``conv_mode`` cleared, so the override wins); ``cfg`` itself
    when ``conv_policy`` is None."""
    if conv_policy is None:
        return cfg
    return dataclasses.replace(cfg, conv_policy=str(conv_policy),
                               conv_mode=None)


def params_device(params) -> torch.device:
    return params["embed"]["w"].device


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (the phase timers stop after it)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    engine_kind = "static"

    def __init__(self, cfg: ArchConfig, params, max_batch: int = 4,
                 max_len: int = 256, temperature: float = 0.0,
                 pad_id: int = 0, seed: int = 0, conv_policy=None,
                 clock=time.monotonic):
        """``params`` live on the device the engine serves on.
        ``conv_policy``: per-pass conv engine override for the model's
        convs (an EnginePolicy, a policy string or an engine name; None
        keeps ``cfg.conv_policy``).  ``clock``: zero-arg wall clock
        (seconds) for request deadlines."""
        if cfg.is_encoder_only:
            raise ValueError("encoder-only archs do not decode")
        cfg = with_conv_policy(cfg, conv_policy)
        self.cfg = cfg
        self.params = params
        self.device = params_device(params)
        self.max_batch = max_batch
        self.max_len = max_len
        self.temperature = temperature
        self.pad_id = pad_id
        self.queue: collections.deque[Request] = collections.deque()
        self.clock = clock
        self.counters = {"completed": 0, "timed_out": 0, "waves": 0,
                         "decode_steps": 0}
        #: wall-clock phase accounting: prefill/decode seconds, prompt
        #: tokens prefilled, generated tokens, and lane_steps = sum over
        #: decode steps of lanes still generating.
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0,
                      "prefill_tokens": 0, "tokens": 0, "lane_steps": 0}
        #: optional hook called after every decode step.
        self.on_step = None
        self._sample = make_sampler(temperature, seed, self.device)

    def submit(self, req: Request):
        req.t_submit = self.clock()
        self.queue.append(req)

    def _decode(self, cache, tokens, pos):
        return M.decode_step(self.params, cache, tokens, pos, self.cfg)

    def _finalize(self, req: Request, status: str | None = None) -> None:
        req.done = True
        if status is not None:
            req.status = status
        req.t_done = self.clock()
        key = req.status if req.status != "ok" else "completed"
        self.counters[key] = self.counters.get(key, 0) + 1

    def _expire(self, wave: list[Request]) -> None:
        """Finalize overdue requests: keep the tokens generated so far,
        mark ``status="timed_out"``."""
        now = self.clock()
        for r in wave:
            if (not r.done and r.deadline_s is not None
                    and now - r.t_submit > r.deadline_s):
                self._finalize(r, "timed_out")

    def run_summary(self) -> dict:
        return merged_summary(self.engine_kind, self.counters, self.stats)

    def _tick(self) -> None:
        if self.on_step is not None:
            self.on_step(self)

    def _run_wave(self, wave: list[Request]) -> None:
        self.counters["waves"] += 1
        b = self.max_batch
        plen = max(len(r.prompt) for r in wave)
        toks = np.full((b, plen), self.pad_id, np.int64)
        for i, r in enumerate(wave):
            toks[i, plen - len(r.prompt):] = r.prompt   # left-pad
        toks = torch.as_tensor(toks, device=self.device)
        cache = T.init_cache(self.cfg, b, self.max_len, self.device)
        # Lockstep prefill through the decode path.
        logits = None
        t0 = time.perf_counter()
        for t in range(plen):
            if all(r.done for r in wave):
                break
            logits, cache = self._decode(cache, toks[:, t], t)
            self._tick()
        sync(self.device)
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_tokens"] += sum(len(r.prompt) for r in wave)
        pos = plen
        max_new = max(r.max_new for r in wave)
        self._expire(wave)
        for _ in range(min(max_new, self.max_len - plen)):
            if logits is None or all(r.done for r in wave):
                break
            sampled = self._sample(logits).tolist()
            nxt = np.full(b, self.pad_id, np.int64)
            active = 0
            for i, r in enumerate(wave):
                if r.done:
                    continue
                active += 1
                tok = sampled[i]
                r.out.append(tok)
                nxt[i] = tok
                if len(r.out) >= r.max_new:
                    self._finalize(r)
            self.stats["tokens"] += active
            self.stats["lane_steps"] += active
            self._expire(wave)        # deadline checked after every token
            if all(r.done for r in wave):
                break
            t0 = time.perf_counter()
            logits, cache = self._decode(
                cache, torch.as_tensor(nxt, device=self.device), pos)
            sync(self.device)
            self.stats["decode_s"] += time.perf_counter() - t0
            self.counters["decode_steps"] += 1
            self._tick()
            pos += 1
        for r in wave:
            if not r.done:
                self._finalize(r)

    def _admit_wave(self) -> tuple[list[Request], list[Request]]:
        """Pop the next wave off the queue; requests whose deadline expired
        while queued are finalized here and never burn a decode step."""
        wave: list[Request] = []
        expired: list[Request] = []
        now = self.clock()
        while self.queue and len(wave) < self.max_batch:
            r = self.queue.popleft()
            if (r.deadline_s is not None
                    and now - r.t_submit > r.deadline_s):
                self._finalize(r, "timed_out")
                expired.append(r)
                continue
            wave.append(r)
        return wave, expired

    def run(self) -> list[Request]:
        """Drain the queue; returns finished requests."""
        finished: list[Request] = []
        while self.queue:
            wave, expired = self._admit_wave()
            finished.extend(expired)
            if wave:
                self._run_wave(wave)
                finished.extend(wave)
        return finished
