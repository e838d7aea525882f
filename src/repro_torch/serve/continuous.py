"""Continuous-batching engine: prefill -> insert-into-slot -> generate
(counterpart of ``repro.serve.continuous``).

The engine keeps a slotted KV cache with per-lane position clocks:

* ``submit`` enqueues; admission happens the moment a lane frees -- the
  request's prompt is prefilled in one causal pass onto a fresh batch-1
  cache (``repro_torch.models.model.prefill``: on the card its attention
  runs the flash-attention kernel, one launch per layer) and
  :func:`repro_torch.serve.cache.lane_insert` writes that cache into the
  freed slot while the other lanes keep their state.
* the decode step takes a per-lane ``(B,)`` position vector (rope angles,
  cache writes and masking per lane), so lanes at different depths share
  one step.

For the SSM family (Mamba2) the "cache" is each layer's SSM state and its
last conv inputs: the prefill's one pass runs the depthwise conv on the
``tap_gemm`` kernel under ``conv_policy="pallas"`` (one launch a layer),
and decode steps read no position.  ``conv_policy`` pins the model's conv
engines, as in the JAX engine.

The JAX engine's observability spans and its ``serve.prefill`` /
``serve.decode`` fault sites, with the ``except Exception`` that finalizes
a crashing prefill as ``status="failed"``, are left out (ROADMAP A12): a
failed kernel build or launch raises out of :meth:`run`.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.serve import cache as C
from repro_torch.serve.engine import (merged_summary, params_device, sync,
                                      with_conv_policy)
from repro_torch.serve.request import Request
from repro_torch.serve.sampling import make_sampler

__all__ = ["ContinuousEngine", "Request"]


class ContinuousEngine:
    engine_kind = "continuous"

    def __init__(self, cfg: ArchConfig, params, max_batch: int = 4,
                 max_len: int = 256, temperature: float = 0.0,
                 pad_id: int = 0, seed: int = 0, conv_policy=None,
                 clock=time.monotonic):
        """Same surface as the static :class:`repro_torch.serve.engine.Engine`
        (``conv_policy`` pins the model's per-pass conv engines)."""
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
        # Slotted state: lane i of the batched cache belongs to lanes[i];
        # lane_pos is the per-lane position clock (the next cache slot the
        # lane writes), next_tok the last sampled token to feed.
        self.cache = T.init_cache(cfg, max_batch, max_len, self.device)
        self.lanes: list[Request | None] = [None] * max_batch
        self.lane_pos = np.zeros(max_batch, np.int64)
        self.next_tok = np.full(max_batch, pad_id, np.int64)
        self.counters = {"completed": 0, "timed_out": 0, "failed": 0,
                         "admitted": 0, "inserts": 0, "decode_steps": 0}
        #: phase accounting (the same keys as the static engine's).
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0,
                      "prefill_tokens": 0, "tokens": 0, "lane_steps": 0}
        #: optional hook called after every decode step.
        self.on_step = None
        self._sample = make_sampler(temperature, seed, self.device)

    # -- submission / finalization ------------------------------------------

    def submit(self, req: Request):
        req.t_submit = self.clock()
        self.queue.append(req)

    def _finalize(self, req: Request, status: str | None = None) -> None:
        req.done = True
        if status is not None:
            req.status = status
        req.t_done = self.clock()
        key = req.status if req.status != "ok" else "completed"
        self.counters[key] = self.counters.get(key, 0) + 1

    def run_summary(self) -> dict:
        return merged_summary(self.engine_kind, self.counters, self.stats)

    def free_lanes(self) -> list[int]:
        return [i for i, r in enumerate(self.lanes) if r is None]

    def active_lanes(self) -> list[int]:
        return [i for i, r in enumerate(self.lanes) if r is not None]

    # -- admission: prefill -> insert-into-slot -----------------------------

    def _admit(self, finished: list[Request]) -> None:
        """Fill every free lane from the queue head.  Deadline-expired
        queue entries are finalized at admission time (no decode step is
        ever spent on them)."""
        for lane in self.free_lanes():
            while self.queue:
                req = self.queue.popleft()
                if (req.deadline_s is not None
                        and self.clock() - req.t_submit > req.deadline_s):
                    self._finalize(req, "timed_out")
                    finished.append(req)
                    continue
                t0 = time.perf_counter()
                logits, src = M.prefill(
                    self.params,
                    torch.as_tensor([req.prompt], device=self.device),
                    self.cfg, self.max_len)
                sync(self.device)
                self.stats["prefill_s"] += time.perf_counter() - t0
                self.counters["admitted"] += 1
                self.stats["prefill_tokens"] += len(req.prompt)
                tok = self._sample(logits).tolist()[0]
                req.out.append(tok)
                self.stats["tokens"] += 1
                if len(req.out) >= req.max_new:
                    # Single-token request: done straight out of prefill;
                    # the lane stays free for the next queue entry.
                    self._finalize(req)
                    finished.append(req)
                    continue
                # The insert is part of the admission cost (prefill_s).
                t0 = time.perf_counter()
                C.lane_insert(self.cache, src, lane)
                sync(self.device)
                self.stats["prefill_s"] += time.perf_counter() - t0
                self.counters["inserts"] += 1
                self.lanes[lane] = req
                self.lane_pos[lane] = len(req.prompt)
                self.next_tok[lane] = tok
                break

    # -- generate: one decode step over every occupied lane -----------------

    def _release(self, lane: int, finished: list[Request],
                 status: str | None = None) -> None:
        self._finalize(self.lanes[lane], status)
        finished.append(self.lanes[lane])
        self.lanes[lane] = None
        # A free lane still rides every decode step until an insert
        # overwrites it; keep its write position inside the cache.
        self.lane_pos[lane] = 0

    def step(self, finished: list[Request]) -> bool:
        """One decode step across all occupied lanes (per-lane position
        vector); samples on the device, advances each lane's clock,
        finalizes lanes that completed or timed out.  Returns False when
        no lane is occupied."""
        active = self.active_lanes()
        if not active:
            return False
        self.counters["decode_steps"] += 1
        t0 = time.perf_counter()
        logits, self.cache = M.decode_step(
            self.params, self.cache,
            torch.as_tensor(self.next_tok, device=self.device),
            torch.as_tensor(self.lane_pos, device=self.device), self.cfg)
        sync(self.device)
        self.stats["decode_s"] += time.perf_counter() - t0
        sampled = self._sample(logits).tolist()
        self.stats["lane_steps"] += len(active)
        now = self.clock()
        for i in active:
            r = self.lanes[i]
            tok = sampled[i]
            r.out.append(tok)
            self.stats["tokens"] += 1
            self.next_tok[i] = tok
            self.lane_pos[i] += 1
            if len(r.out) >= r.max_new or self.lane_pos[i] >= self.max_len:
                self._release(i, finished)
            elif (r.deadline_s is not None
                    and now - r.t_submit > r.deadline_s):
                self._release(i, finished, "timed_out")
        if self.on_step is not None:
            self.on_step(self)
        return True

    def run(self) -> list[Request]:
        """Drain queue and lanes; returns finished requests.  Admission
        runs before every decode step, so a request is inserted the moment
        a lane frees -- never at a wave boundary."""
        finished: list[Request] = []
        while self.queue or self.active_lanes():
            self._admit(finished)
            self.step(finished)
        return finished
