#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Phases, one JSON object per line on stdout (``--out`` also writes them to
PATH):

  1. device     -- the card's name and power limit (``nvidia-smi``), library
                   versions; TF32 is switched off for every library call.
  2. build      -- ``nvcc`` builds the three CUDA sources of
                   ``src/repro_torch/csrc`` (in parallel); the registers,
                   spills and shared memory of each entry of the
                   redesigned kernels (the three tap GEMMs, the four
                   ``matmul`` tiles, the bf16 flash attention at head dims
                   64, 128 and 192); the blocks
                   an SM holds of each input-grad, weight-grad and
                   ``matmul`` instance (the occupancy calculator) against
                   the number their split plans assume.
  3. kernels    -- for each of the paper's Table II layers (batch 2, float32),
                   the three convs of the CNN's training run (batch 32), the
                   autoencoder's two encoder convs and the mirror convs of
                   its two decoder layers (batch 16), and each tap-GEMM
                   kernel: the kernel against its plain PyTorch version on
                   the same operands (largest error relative to the largest
                   plain value, tolerance ``REL_TOL``), then the device time
                   per call of the kernel, the plain version and the library
                   call for the same pass (a CUDA graph of 10 back-to-back
                   calls replayed between CUDA events, median of 10), the
                   host time per kernel call, and the least time the card
                   could take (``bound_us``); the forward's split count,
                   the input grad's variant, split count and partial bytes
                   (``phased_plan``, ``phased_work``) and the device time of
                   its operands (``operands_ms``: ``input_grad_operands``,
                   the same CUDA-graph replay), the weight grad's variant and
                   split count (``wgrad_plan``); all three are bit-equal run
                   to run.
  4. matmul     -- the same for the ``matmul`` kernel at every lowered GEMM
                   of the ``traditional`` and ``bp_im2col`` engines at the
                   Table II and CNN shapes, at every GEMM the autoencoder
                   runs under ``traditional`` (the decoder's stride-1 GEMM
                   over the zero-inserted input among them), and one
                   bfloat16 case, each with its variant and split count
                   (``matmul_plan``) and bit-equal run to run.  Its plain
                   version and its library call are one and the same:
                   ``torch.matmul`` with TF32 off.
  5. layers     -- each Table II layer through ``conv2d(x, w, spec, p)`` and
                   ``.backward()`` for p in (pallas, traditional, bp_im2col),
                   against ``policy="lax"``; each kernel launches exactly
                   once per pass; two split-K weight grads are bit-equal;
                   the card memory the cached bp_im2col gather maps hold
                   after it, before they are released.
  6. transposed -- the autoencoder's two decoder layers and the mirror of
                   Table II layer 2 through ``conv2d_transpose`` under
                   pallas and traditional, against the ``lax``
                   materialization, for y, dx and dw; the pallas forward is
                   one ``tap_gemm_phased`` launch, the traditional one
                   ``matmul``.
  7. train      -- ``python -m repro_torch.train.cnn_bp --policy pallas`` at
                   its defaults (200 steps, batch 32) must reach eval
                   accuracy > 0.9 with all three tap kernels launched; its
                   first 20 losses agree with ``lax`` and with
                   ``traditional`` (``matmul`` launched) from the same
                   initialization; a shorter run under ``auto``.
                   ``python -m repro_torch.train.autoencoder_bp --policy
                   pallas`` at its defaults (200 steps, batch 16) must reach
                   MSE < 0.05; 20 steps under traditional match pallas.
  8. autotune   -- the measured autotuner, over fresh temporary plan caches:
                   at each shape of the kernels phase, every candidate plan
                   of each tap kernel (``ops.plan_candidates``) against the
                   plain version (``REL_TOL``) with its device time, and
                   the tuner's winner (``autotune="measure"``) beside the
                   analytic plan; then the CNN CLI under ``--policy pallas
                   --autotune measure`` and ``--autotune cached``: the
                   cached run is all hits, ``torch.equal`` losses, eval
                   accuracy > 0.9 and the ``off`` run's launches.
  9. flash      -- the ``flash_attention`` kernel against its plain version
                   (``max |kernel - plain| / max |plain|``, tolerance
                   ``FLASH_TOL`` in float32, ``BF16_TOL`` in bf16) at the
                   serving shapes, SmolLM-360M's 15 query and 5 KV heads of
                   64 over causal P in {512, 1,024, 2,048} in bf16 and
                   float32, a ragged P (1,000), a full (non-causal) case,
                   256 queries against 1,024 keys, and 15 KV heads;
                   moonshot-v1-16b-a3b's prefill (16 heads of 128, P
                   1,024, bf16) and DeepSeek-V3 MLA's (128 heads of 192,
                   causal P 1,024 and 256 queries against 1,024 keys, bf16
                   and float32); two runs are bit-equal; kernel, plain and
                   ``F.scaled_dot_product_attention`` device times (timed
                   only: the port never calls it), host time, bound.
 10. serve      -- SmolLM-360M at full width, initialised from a seed: the
                   port's prefill (one causal pass, the kernel in every
                   layer) against a lockstep scan of ``decode_step`` (plain
                   dense attention) on one 1,024-token prompt, logits and
                   every layer's cache, in bf16 (``SERVE_BF16_TOL``) and,
                   at ``SERVE_F32_LAYERS`` layers, float32
                   (``SERVE_F32_TOL``); the host wall time and the
                   device time (``torch.profiler``) of one bf16 prefill and
                   one decode step of 4 lanes; then
                   ``python -m repro_torch.launch.serve --full`` for both
                   engines (8 requests of 1,024 tokens, 32 new, batch 4):
                   every request ``ok`` with 32 tokens, the continuous engine
                   launches the kernel 32 x admitted times and the static
                   engine none; prefill s per request, decode ms per step,
                   tokens/s, p50 latency; in float32 (``SERVE_F32_LAYERS``
                   layers) both engines' greedy tokens agree on the same 8
                   requests (static in one wave of 8, continuous on 4
                   lanes; where one differs, the first differing step's
                   top-2 logit margin must be under ``MARGIN_TOL``).
 11. serve_moe  -- the MoE family: moonshot-v1-16b-a3b at full width (48
                   layers, 28.4 B parameters, bf16, drawn on the card from
                   seed 0, with its init seconds): prefill vs the decode
                   scan on a ``MOE_PROMPT``-token prompt (largest error
                   within ``MOE_BF16_TOL``, the layers up to the first
                   MoE layer's cache within ``SERVE_BF16_TOL``; the median
                   per-position error reported; 48 launches in the
                   prefill, none in the scan); the device time of one
                   1,024-token prefill and one decode step of 4 lanes;
                   ``launch.serve --full --arch moonshot-v1-16b-a3b`` under
                   ``continuous`` (8 requests of 1,024 tokens, 32 new,
                   batch 4: 48 launches a request) and ``static`` (8 of 128
                   tokens, 8 new: none), tokens/s, p50 and peak memory; in
                   float32 at ``MOE_F32_LAYERS`` layers, prefill vs scan
                   (``SERVE_F32_TOL``) and the engines' greedy tokens (as
                   in serve).  DeepSeek-V3 at its published widths,
                   ``DEEPSEEK_LAYERS`` layers (3 dense + 1 MoE; MTP built,
                   not served): the prefill, whose attention runs the
                   kernel at head dim 192, vs the absorbed decode scan
                   (``MLA_BF16_TOL``; 4 launches, none in the scan), and
                   the continuous engine on 4 requests of 512 tokens, 16
                   new (4 launches a request).
 12. lm_train   -- ``python -m repro_torch.launch.train --arch smollm-360m``
                   at the published widths (bf16, seed 0, batch 8, seq 512,
                   ``--lr`` 3e-4, the guard on): (a) 30 steps with
                   checkpoints every 15; (b) the same stopped after 15 and
                   resumed to 30 from its checkpoint; (c) (a)'s first 5
                   steps with ``--accum 2``; (d) 5 steps of
                   ``make_train_step(..., compress_grads=True)`` on the
                   pipeline's batches.  Every loss finite and no step
                   dropped by the guard; (a)'s last 5 losses below its
                   first; within ``LM_TRAIN_TOL`` of (a): every loss of (b)
                   and (c)'s first two losses (its first gradient norm
                   within ``LM_GNORM_TOL``); (d)
                   falls; no kernel launched.  Median step time, tokens/s,
                   peak memory, and one profiled step's device-busy share
                   (last: the profiler slows later kernels).
 13. summary    -- every kernel's launches on each path, each path run with
                   the counts set to 0 just before it and read just after.

Then a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase raises, so the script exits non-zero and prints no result;
it also does so without a CUDA device or without the package beside it.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

#: kernel vs plain version: max |kernel - plain| / max |plain| (float32,
#: contractions of up to 24,642 terms summed in another order).
REL_TOL = 1e-4
#: conv2d under "pallas" vs under "lax" on the card, same measure.
LAYER_TOL = 1e-4
#: first 20 training losses, pallas vs lax (and traditional) from one
#: initialization; 20 autoencoder MSEs, traditional vs pallas (float32 sums
#: in other orders, carried through 20 SGD or AdamW steps).
LOSS_TOL = 1e-4
#: matmul with a bfloat16 output: both sides round a float32 sum to bf16
#: (a step of 2^-8 relative) after summing in other orders.  bf16
#: flash_attention also rounds each probability to bf16 (2^-9 relative)
#: before its P V product.
BF16_TOL = 1e-2
#: flash_attention vs its plain version in float32: online softmax against a
#: full-row softmax, sums in another order.
FLASH_TOL = 1e-5
#: the full-width model's one-pass prefill vs its lockstep decode scan, as
#: max |a - b| / max |b| over the last logits and over each layer's K and V.
#: bf16: every activation is rounded to bf16 (2^-8 relative) at other places
#: on the two paths (kernel attention in float32 vs bf16 scores and
#: probabilities in the dense path), compounding over 32 layers.
SERVE_BF16_TOL = 5e-2
#: float32: sums in other orders only.
SERVE_F32_TOL = 1e-4
#: moonshot-v1-16b-a3b's bf16 prefill vs its decode scan, the same measure
#: over 48 layers.  Beside the bf16 roundings above, a near-tie in a
#: token's top-6 router choice flips between the two paths under them: the
#: token takes another expert in one path, its K and V in every later
#: layer differ by a share of the layer's largest value, and attention
#: carries that to the other tokens.  On the H100 the caches that no flip
#: can reach (the dense layer's and the first MoE layer's, which precede
#: its experts) read 0.0099, the next layer 0.095, the worst 0.23, and half
#: the positions pass 5e-2 by layer 48.  So the largest error is held to
#: this, those first layers to ``SERVE_BF16_TOL``; float32
#: (``MOE_F32_LAYERS`` layers, 3 of them MoE) holds ``SERVE_F32_TOL``.
MOE_BF16_TOL = 0.5
#: DeepSeek-V3's bf16 prefill (flash at head dim 192, v padded) vs its
#: absorbed decode scan (attention in the latent space): the same
#: computation with the bf16 roundings at other places (0.019 on the H100).
#: Its one MoE layer is the last, after its cache, so no routing flip
#: reaches the cache.  A prefill that caches the un-normed latent reads
#: 0.088, one that skips rope on ``k_rope`` 1.9 (PERF.md, §6).
MLA_BF16_TOL = 5e-2
#: the float32 serve checks run a quarter of the published depth (every
#: width kept): float32 GEMMs and 1,024 lockstep scan steps took ~100 s at
#: 32 layers and ~51 s at 16, and the script keeps its time with the
#: lm_train and serve_moe phases added (532 s in all with 16, on an H100).
SERVE_F32_LAYERS = 8
#: float32 greedy tokens of the two engines: where they differ, the logits
#: at the first differing step must be a near-tie (top-2 margin below this).
MARGIN_TOL = 1e-3
#: LM training at full width in bf16, relative difference of two losses of
#: one step: (b)'s against (a)'s, (c)'s first two against (a)'s.  A restore
#: is bit-exact and the steps are deterministic, so (b) reads 0 on the
#: H100; (c) sums bf16 microbatch grads in float32, and its second loss
#: (after one update) reads 2.0e-5.  A resume that restores fresh weights,
#: zeroed moments or a zeroed step count reads 9.9e-3, 5.5e-3 and 2.9e-3
#: at its worst step; keeping only the first microbatch reads 1.5e-3 on
#: the second loss (PERF.md, §6).
LM_TRAIN_TOL = 1e-4
#: (c)'s first gradient norm against (a)'s: the bf16 microbatch grads read
#: 2.2e-4; keeping only the first microbatch reads 0.43, leaving out the
#: division 1.0 (where the losses cannot tell: AdamW is scale-free).
LM_GNORM_TOL = 1e-3
#: H100 SXM float32 peak outside the tensor cores and memory rate (data sheet).
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

#: kernel -> (the TPU kernel it replaces, its source in the repo)
KERNELS = {
    "tap_gemm": ("src/repro/kernels/tap_gemm.py:173",
                 "src/repro_torch/csrc/tap_gemm.cu"),
    "tap_gemm_phased": ("src/repro/kernels/tap_gemm.py:226",
                        "src/repro_torch/csrc/tap_gemm.cu"),
    "tap_wgrad": ("src/repro/kernels/tap_gemm.py:285",
                  "src/repro_torch/csrc/tap_gemm.cu"),
    "matmul": ("src/repro/kernels/matmul.py:33",
               "src/repro_torch/csrc/matmul.cu"),
    "flash_attention": ("src/repro/kernels/flash_attention.py:70",
                        "src/repro_torch/csrc/flash_attention.cu"),
}
TAP_KERNELS = ("tap_gemm", "tap_gemm_phased", "tap_wgrad")


class Smoke:
    """Phase lines on stdout (and ``out``), each with ``t_s``: the seconds
    since the script began."""

    def __init__(self, out: pathlib.Path | None):
        self.out = open(out, "w") if out else None
        self.t0 = time.perf_counter()

    def emit(self, phase: str, **fields) -> None:
        line = json.dumps({"phase": phase, **fields,
                           "t_s": time.perf_counter() - self.t0})
        print(line, flush=True)
        if self.out:
            self.out.write(line + "\n")
            self.out.flush()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(torch, fn, batches: int = 10, calls: int = 10,
            warm: int = 3) -> float:
    """Device time per call: ``calls`` back-to-back calls, captured in one
    CUDA graph after ``warm`` calls, replayed ``batches`` times between two
    CUDA events; the median replay over ``calls``
    (``repro_torch.kernels.timing.time_ms``, the measured autotuner's
    timer).  A replay runs the device work without the host's cost of each
    call, so a small kernel reads its own time, not its launch cost.
    Operands stay warm in L2 (the same tensors every call).  ``torch`` is
    not read: the parameters are those ``scripts/ab_kernel_times.py``
    passes to every checkout's helper."""
    from repro_torch.kernels import timing
    return timing.time_ms(fn, batches, calls, warm)


def host_ms(torch, fn, calls: int = 100) -> float:
    """Host time per call of ``fn`` called back to back without waiting for
    the device: Python, the wrapper's checks and the launch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def rel_err(torch, got, want) -> tuple[float, float]:
    check(got.shape == want.shape, f"shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff / max(scale, 1e-30), diff


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, nbytes_: float,
          peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes_ / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


#: kernel -> pieces of the mangled names of the entries of its redesigned
#: kernels (the three tap GEMMs, the four ``matmul`` tiles, the bf16
#: tensor-core flash attention: head dims 64, 128 and 192, each with and
#: without 16-byte rows), whose registers, spills and shared memory the
#: build phase reports, and how many entries each has.
REDESIGNED = {"tap_gemm": (("3fwd6kernel",), 4),
              "tap_gemm_phased": (("6phased6kernel",), 12),
              "tap_wgrad": (("5wgrad6kernel",), 8),
              "matmul": (("4gemm6kernel", "4tall6kernel", "6mirror6kernel"),
                         22),
              "flash_attention": (("flash_bf16_kernel",), 6)}


def flash_bf16_smem(dm: int) -> int:
    """Dynamic shared memory of ``flash_bf16_kernel<DM>``: Q plus two stages
    of K and V, 64 rows each, of DM + 8 bf16 (csrc/flash_attention.cu)."""
    return (64 + 4 * 64) * (dm + 8) * 2


def kernel_resources(log_dir: pathlib.Path) -> list[dict]:
    """Registers, spill bytes and shared memory of every entry of the
    ``REDESIGNED`` kernels, from the ``-Xptxas -v`` build logs."""
    out, cur = [], None
    for log in sorted(log_dir.glob("*.log")):
        for ln in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                name = m.group(1)
                kernel = next((k for k, (marks, _) in REDESIGNED.items()
                               if any(mark in name for mark in marks)), None)
                cur = {"kernel": kernel, "entry": name} if kernel else None
                if cur:
                    dm = re.search(r"ILi(\d+)E", name)
                    cur["dynamic_smem_bytes"] = (
                        flash_bf16_smem(int(dm.group(1)))
                        if kernel == "flash_attention" else 0)
                    out.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                cur["spill_store_bytes"], cur["spill_load_bytes"] = map(
                    int, m.groups())
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                smem = re.search(r"(\d+) bytes smem", ln)
                cur["registers"] = int(m.group(1))
                cur["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def plan_occupancy(tg, mm) -> list[dict]:
    """Blocks an SM holds of every input-grad, weight-grad and ``matmul``
    instance, from the card's occupancy calculator, beside the ``per_sm``
    the plans assume for its variant."""
    rows = []
    for variant, tile in tg.PHASED_TILES.items():
        for vec_a in (False, True):
            for vec_b in (False, True):
                rows.append({"kernel": "tap_gemm_phased", "variant": variant,
                             "in": "float32", "vec_a": vec_a, "vec_b": vec_b,
                             "plan_per_sm": tile.per_sm,
                             "blocks_per_sm": tg.phased_blocks_per_sm(
                                 variant, vec_a, vec_b)})
    for variant, tile in tg.WGRAD_TILES.items():
        for vec_a in (False, True):
            for vec_b in (False, True):
                rows.append({"kernel": "tap_wgrad", "variant": variant,
                             "in": "float32", "vec_a": vec_a, "vec_b": vec_b,
                             "plan_per_sm": tile.per_sm,
                             "blocks_per_sm": tg.wgrad_blocks_per_sm(
                                 variant, vec_a, vec_b)})
    for variant, tile in mm.VARIANTS.items():
        for in_bf16, vec_a, vec_b in ((False, False, False),
                                      (False, False, True),
                                      (False, True, False),
                                      (False, True, True),
                                      (True, False, False)):
            rows.append({"kernel": "matmul", "variant": variant,
                         "in": "bfloat16" if in_bf16 else "float32",
                         "vec_a": vec_a, "vec_b": vec_b,
                         "plan_per_sm": tile.per_sm,
                         "blocks_per_sm": mm.blocks_per_sm(
                             variant, in_bf16, vec_a, vec_b)})
    return rows


def check_occupancy(rows: list[dict]) -> None:
    """Each plan's ``per_sm`` is the least the card holds of the variant's
    float32 instances."""
    for kernel, variant in {(r["kernel"], r["variant"]) for r in rows}:
        mine = [r for r in rows if (r["kernel"], r["variant"], r["in"])
                == (kernel, variant, "float32")]
        check(min(r["blocks_per_sm"] for r in mine)
              == mine[0]["plan_per_sm"],
              f"{kernel} {variant}: the plan assumes "
              f"{mine[0]['plan_per_sm']} blocks per SM, the card holds "
              f"{[r['blocks_per_sm'] for r in mine]}")


def phase_kernels(smoke, torch, F, nn_grad, ops, tg, ref, shapes, dev):
    """Each kernel at each shape against its plain version.  ``shapes``
    holds ``(label, per-group ConvDims, groups, summed)``; the rows with
    ``summed`` make up the totals of the final ``kernels`` line."""
    agg = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
               "bytes": 0.0, "max_abs_err": 0.0} for k in TAP_KERNELS}
    for i, (layer, d, g, summed) in enumerate(shapes):
        gen = torch.Generator().manual_seed(i)
        x = torch.randn(d.B, d.C * g, d.H_i, d.W_i, generator=gen).to(dev)
        w = torch.randn(d.N * g, d.C, d.K_h, d.K_w, generator=gen).to(dev)
        dy = torch.randn(d.B, d.N * g, d.H_o, d.W_o, generator=gen).to(dev)
        stride, pad = (d.s_h, d.s_w), (d.P_h, d.P_w)
        macs = g * d.N * d.C          # per output pixel and tap

        src, wt, taps = ops.forward_operands(x, w, d, g)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        fwd = (lambda: tg.tap_gemm(src, wt, taps, d.H_o, d.W_o),
               lambda: ref.tap_gemm_ref(src, wt, taps, d.H_o, d.W_o),
               lambda: F.conv2d(x, w, stride=stride, padding=pad, groups=g),
               2.0 * d.B * d.H_o * d.W_o * macs * len(taps),
               nbytes(src, wt), {"splits": tg.forward_splits(
                   d.B * d.H_o * d.W_o, d.N, len(taps), d.C, sms, g)})
        gsrc, ws, pp = ops.input_grad_operands(dy, w, d, g)
        counts = [len(t) for t in pp.phase_taps]
        n_taps = sum(counts)
        m_q = d.B * pp.n_qh * pp.n_qw
        dvariant, dsplits = tg.phased_plan(g, counts, d.N, d.C, m_q, sms)
        slots = tg.phased_work(counts, d.N, dsplits,
                               tg.PHASED_TILES[dvariant].step)[2]
        dgrad = (lambda: tg.tap_gemm_phased(gsrc, ws, pp.phase_taps, pp.n_qh,
                                            pp.n_qw),
                 lambda: ref.tap_gemm_phased_ref(gsrc, ws, pp.phase_taps,
                                                 pp.n_qh, pp.n_qw),
                 lambda: nn_grad.conv2d_input(x.shape, w, dy, stride=stride,
                                              padding=pad, groups=g),
                 2.0 * d.B * pp.n_qh * pp.n_qw * macs * n_taps,
                 # only the weight rows the taps read: the stacks of
                 # phases without taps are zeros the kernel never loads
                 nbytes(gsrc) + 4 * n_taps * macs,
                 {"active_phases": sum(1 for c in counts if c),
                  "variant": dvariant, "splits": dsplits,
                  "partial_mbytes": 4 * slots * g * m_q * d.C / 1e6,
                  "operands_ms": time_ms(torch, lambda:
                                         ops.input_grad_operands(dy, w, d,
                                                                 g))})
        wsrc, dyn, wtaps = ops.weight_grad_operands(x, dy, d, g)
        variant, splits = tg.wgrad_plan(g, len(wtaps), d.C, d.N,
                                        d.B * d.H_o * d.W_o, sms)
        wgrad = (lambda: tg.tap_wgrad(wsrc, dyn, wtaps, d.H_o, d.W_o),
                 lambda: ref.tap_wgrad_ref(wsrc, dyn, wtaps, d.H_o, d.W_o),
                 lambda: nn_grad.conv2d_weight(x, w.shape, dy, stride=stride,
                                               padding=pad, groups=g),
                 2.0 * d.B * d.H_o * d.W_o * macs * len(wtaps),
                 nbytes(wsrc, dyn), {"variant": variant, "splits": splits})

        for name, (kern, plain, lib, flops, in_bytes, extra) in zip(
                TAP_KERNELS, (fwd, dgrad, wgrad)):
            before = tg.launch_counts()[name]
            got = kern()
            launches = tg.launch_counts()[name] - before
            want = plain()
            torch.cuda.synchronize()
            err, abs_err = rel_err(torch, got, want)
            check(bool(torch.equal(got, kern())),
                  f"{name} differs run to run at {layer}")
            by = in_bytes + nbytes(got)
            b_s, b_by = bound(flops, by)
            rec = {"kernel": name, "layer": layer, "groups": g,
                   "max_rel_err": err, "max_abs_err": abs_err,
                   "tol": REL_TOL, "launches_per_call": launches,
                   "kernel_ms": time_ms(torch, kern),
                   "kernel_host_ms": host_ms(torch, kern),
                   "plain_ms": time_ms(torch, plain),
                   "library_ms": time_ms(torch, lib),
                   "bound_us": b_s * 1e6, "bound_by": b_by,
                   "gflop": flops / 1e9, "mbytes": by / 1e6, **extra}
            rec["roofline_share"] = rec["bound_us"] / 1e3 / rec["kernel_ms"]
            smoke.emit("kernels", **rec)
            check(launches == 1, f"{name}: {launches} launches for one call")
            check(err <= REL_TOL, f"{name} at {layer}: relative error {err} "
                                  f"> {REL_TOL}")
            if not summed:
                continue
            a = agg[name]
            for k in ("ms", "plain_ms", "library_ms"):
                a[k] += rec["kernel_ms" if k == "ms" else k]
            a["flops"] += flops
            a["bytes"] += by
            a["max_abs_err"] = max(a["max_abs_err"], abs_err)
    return agg


def cnn_shapes(ConvDims):
    """The three convs of ``repro_torch.train.cnn_bp`` at its defaults
    (batch 32, 16x16 input): the shapes its training run gives the
    kernels.  Per-group dims; the depthwise layer has 16 groups of 1."""
    return [("cnn.c1 16/3/16/3/2/1", ConvDims(B=32, C=3, H_i=16, W_i=16,
                                              N=16, K_h=3, K_w=3, S=2,
                                              P_h=1, P_w=1), 1, False),
            ("cnn.dw 8/16/16/3/1/1 g16", ConvDims(B=32, C=1, H_i=8, W_i=8,
                                                  N=1, K_h=3, K_w=3, S=1,
                                                  P_h=1, P_w=1), 16, False),
            ("cnn.c2 8/16/32/3/2/1", ConvDims(B=32, C=16, H_i=8, W_i=8,
                                              N=32, K_h=3, K_w=3, S=2,
                                              P_h=1, P_w=1), 1, False)]


def ae_shapes(ConvDims, conv, ConvTransposeSpec):
    """The autoencoder's convs at the example's defaults (batch 16, 16x16
    images): its two encoder convs, and the mirror regular conv of each
    decoder layer (``conv.transpose_dims``), whose passes its
    ``conv2d_transpose`` runs role-swapped.  Rows as in ``cnn_shapes``,
    plus the names of the ``gemm_shapes`` the layer runs under
    ``traditional`` and, for a decoder layer, its ``(x shape, w shape,
    spec)``.  The first encoder conv takes the images, so it runs no
    input grad."""
    enc = [("ae.enc0 16/3/16/3/2/1 b16", ConvDims(B=16, C=3, H_i=16, W_i=16,
                                                  N=16, K_h=3, K_w=3, S=2,
                                                  P_h=1, P_w=1), 1, False,
            ("forward", "weight_grad"), None),
           ("ae.enc1 8/16/32/3/2/1 b16", ConvDims(B=16, C=16, H_i=8, W_i=8,
                                                  N=32, K_h=3, K_w=3, S=2,
                                                  P_h=1, P_w=1), 1, False,
            ("forward", "input_grad traditional", "weight_grad"), None)]
    # dX of a decoder layer is its mirror conv's forward, dW the mirror's
    # weight grad with input and output swapped.
    dec = [(f"{label} mirror", conv.transpose_dims(xs, ws, spec), 1, False,
            ("forward", "weight_grad"), (xs, ws, spec))
           for label, xs, ws, spec in transposed_cases(ConvTransposeSpec)[:2]]
    return enc + dec


def gemm_shapes(d, g: int) -> dict[str, tuple[int, int, int, int]]:
    """The lowered GEMMs ``(G, M, K, N)`` of one conv under the
    ``traditional`` and ``bp_im2col`` engines (per-group dims ``d``)."""
    kk = d.K_h * d.K_w
    return {"forward": (g, d.B * d.H_o * d.W_o, d.C * kk, d.N),
            "input_grad traditional": (g, d.B * d.H_i * d.W_i, d.N * kk, d.C),
            "input_grad bp_im2col": (g, d.C, d.N * kk, d.B * d.H_i * d.W_i),
            "weight_grad": (g, d.C * kk, d.B * d.H_o2 * d.W_o2, d.N)}


def matmul_cases(torch, conv, shapes, ae):
    """``(label, gemm, (G, M, K, N), dtype, summed)`` for ``phase_matmul``:
    every GEMM of both baseline engines at ``shapes`` (Table II and the
    CNN), the GEMMs the autoencoder runs under ``traditional`` at ``ae``
    (an encoder conv: forward, input grad, weight grad; a decoder layer:
    the stride-1 GEMM over its zero-inserted input, then its dX and dW),
    and one bfloat16 case."""
    f32 = torch.float32
    cases = [(layer, gemm, shape, f32, summed)
             for layer, d, g, summed in shapes
             for gemm, shape in gemm_shapes(d, g).items()]
    for layer, d, g, _, names, dec in ae:
        if dec is not None:
            cases.append((layer, "transposed forward, materialized",
                          gemm_shapes(conv.materialized_dims(*dec), g)
                          ["forward"], f32, False))
        cases += [(layer, name, gemm_shapes(d, g)[name], f32, False)
                  for name in names]
    layer, d, g, _ = shapes[1]
    cases.append((layer, "forward bf16", gemm_shapes(d, g)["forward"],
                  torch.bfloat16, False))
    return cases


def phase_matmul(smoke, torch, mm, kref, tg, cases, dev):
    """``matmul`` against its plain version at each of ``cases``
    (``matmul_cases``), with the variant and split count of its plan, and
    bit-equal run to run.  Cases with ``summed`` add their traditional
    GEMMs (forward, input grad, weight grad) to the totals of the final
    ``kernels`` line.  ``tg`` is not read: the parameters are those
    ``scripts/ab_kernel_times.py`` passes to every checkout's phase."""
    agg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
           "bytes": 0.0, "max_abs_err": 0.0}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, (layer, gemm, (g, m, k, n), dtype, summed) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(i)
        a = torch.randn(g, m, k, device=dev, generator=gen).to(dtype)
        b = torch.randn(g, k, n, device=dev, generator=gen).to(dtype)
        kern = lambda: mm.matmul(a, b)                       # noqa: E731
        plain = lambda: kref.matmul_ref(a, b)                # noqa: E731
        lib = lambda: torch.matmul(a, b)                     # noqa: E731
        before = mm.LAUNCHES["matmul"]
        got = kern()
        launches = mm.LAUNCHES["matmul"] - before
        want = plain()
        torch.cuda.synchronize()
        err, abs_err = rel_err(torch, got, want)
        variant, splits = mm.matmul_plan(g, m, k, n, sms)
        check(bool(torch.equal(got, kern())),
              f"matmul differs run to run at {layer} {gemm}")
        flops = 2.0 * g * m * k * n
        by = nbytes(a, b, got)
        b_s, b_by = bound(flops, by, PEAK_BF16_FLOPS
                          if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
        tol = BF16_TOL if dtype == torch.bfloat16 else REL_TOL
        rec = {"kernel": "matmul", "layer": layer, "gemm": gemm,
               "gmkn": [g, m, k, n], "dtype": str(dtype).split(".")[-1],
               "max_rel_err": err, "max_abs_err": abs_err, "tol": tol,
               "launches_per_call": launches, "variant": variant,
               "splits": splits,
               "kernel_ms": time_ms(torch, kern),
               "kernel_host_ms": host_ms(torch, kern),
               "plain_ms": time_ms(torch, plain),
               "library_ms": time_ms(torch, lib),
               "bound_us": b_s * 1e6, "bound_by": b_by,
               "gflop": flops / 1e9, "mbytes": by / 1e6}
        rec["roofline_share"] = rec["bound_us"] / 1e3 / rec["kernel_ms"]
        smoke.emit("matmul", **rec)
        check(launches == 1, f"matmul: {launches} launches for one call")
        check(err <= tol, f"matmul at {layer} {gemm}: relative error {err} "
                          f"> {tol}")
        if summed and gemm != "input_grad bp_im2col":
            for key in ("plain_ms", "library_ms"):
                agg[key] += rec[key]
            agg["ms"] += rec["kernel_ms"]
            agg["flops"] += flops
            agg["bytes"] += by
            agg["max_abs_err"] = max(agg["max_abs_err"], abs_err)
    return agg


#: launches of one conv2d forward + backward under each policy
LAYER_LAUNCHES = {
    "pallas": {"tap_gemm": 1, "tap_gemm_phased": 1, "tap_wgrad": 1,
               "matmul": 0, "flash_attention": 0},
    "traditional": {"tap_gemm": 0, "tap_gemm_phased": 0, "tap_wgrad": 0,
                    "matmul": 3, "flash_attention": 0},
    "bp_im2col": {"tap_gemm": 0, "tap_gemm_phased": 0, "tap_wgrad": 0,
                  "matmul": 3, "flash_attention": 0},
    "lax": {"tap_gemm": 0, "tap_gemm_phased": 0, "tap_wgrad": 0,
            "matmul": 0, "flash_attention": 0},
}


def phase_layers(smoke, torch, conv, kernels, ConvSpec, table2, dev):
    """Each Table II layer through the normal entry point under each
    kernel-backed policy, vs lax; the traditional run is repeated and must
    be bit-equal (its split-K sums are in a fixed order)."""
    for i, (layer, d) in enumerate(table2):
        gen = torch.Generator().manual_seed(100 + i)
        x0 = torch.randn(d.B, d.C, d.H_i, d.W_i, generator=gen).to(dev)
        w0 = torch.randn(d.N, d.C, d.K_h, d.K_w, generator=gen).to(dev)
        dy = torch.randn(d.B, d.N, d.H_o, d.W_o, generator=gen).to(dev)
        spec = ConvSpec.make(stride=d.s_h, padding=d.P_h)
        outs = {}
        for policy in ("pallas", "traditional", "bp_im2col", "lax",
                       "traditional again"):
            x = x0.clone().requires_grad_(True)
            w = w0.clone().requires_grad_(True)
            conv.reset_dispatch_events()
            kernels.reset_launch_counts()
            y = conv.conv2d(x, w, spec, policy.split()[0])
            y.backward(dy)
            torch.cuda.synchronize()
            outs[policy] = (y.detach(), x.grad, w.grad,
                            kernels.launch_counts(), conv.dispatch_events())
        for policy in ("pallas", "traditional", "bp_im2col"):
            errs = [rel_err(torch, a, b)[0]
                    for a, b in zip(outs[policy][:3], outs["lax"][:3])]
            counts, events = outs[policy][3], outs[policy][4]
            smoke.emit("layers", layer=layer, policy=policy,
                       rel_err_y=errs[0], rel_err_dx=errs[1],
                       rel_err_dw=errs[2], tol=LAYER_TOL, launches=counts,
                       dispatch=events)
            check(counts == LAYER_LAUNCHES[policy],
                  f"{layer} {policy}: launches {counts}")
            check(max(errs) <= LAYER_TOL, f"{layer}: {policy} vs lax {errs}")
        check(outs["lax"][3] == LAYER_LAUNCHES["lax"],
              "lax policy launched a kernel")
        check(all(bool(torch.equal(a, b)) for a, b in zip(
            outs["traditional"][:3], outs["traditional again"][:3])),
              f"{layer}: traditional differs run to run")


def transposed_cases(ConvTransposeSpec):
    """The autoencoder's two decoder layers at the example's defaults
    (batch 16, 16x16 images) and the mirror of Table II layer 2."""
    spec = ConvTransposeSpec.make(stride=2, padding=1, output_padding=1)
    return [("ae.dec0 32->16 4->8 b16", (16, 32, 4, 4), (32, 16, 3, 3), spec),
            ("ae.dec1 16->3 8->16 b16", (16, 16, 8, 8), (16, 3, 3, 3), spec),
            ("mirror L2 64->64 56->112 b2", (2, 64, 56, 56), (64, 64, 3, 3),
             spec)]


def phase_transposed(smoke, torch, conv, kernels, ConvTransposeSpec, dev):
    """``conv2d_transpose`` under pallas and traditional against the lax
    materialization (autograd through it gives dx and dw)."""
    for i, (label, xs, ws, spec) in enumerate(
            transposed_cases(ConvTransposeSpec)):
        gen = torch.Generator().manual_seed(200 + i)
        x0 = torch.randn(*xs, generator=gen).to(dev)
        w0 = torch.randn(*ws, generator=gen).to(dev)
        out_shape = conv.conv_transpose_output_shape(xs, ws, spec)
        dy = torch.randn(*out_shape, generator=gen).to(dev)
        outs = {}
        for policy in ("oracle", "pallas", "traditional"):
            x = x0.clone().requires_grad_(True)
            w = w0.clone().requires_grad_(True)
            conv.reset_dispatch_events()
            kernels.reset_launch_counts()
            y = (conv.conv2d_transpose_materialized(x, w, spec, "lax")
                 if policy == "oracle"
                 else conv.conv2d_transpose(x, w, spec, policy))
            fwd = kernels.launch_counts()
            y.backward(dy)
            torch.cuda.synchronize()
            outs[policy] = (y.detach(), x.grad, w.grad, fwd,
                            kernels.launch_counts(), conv.dispatch_events())
        for policy, fwd_kernel in (("pallas", "tap_gemm_phased"),
                                   ("traditional", "matmul")):
            errs = [rel_err(torch, a, b)[0]
                    for a, b in zip(outs[policy][:3], outs["oracle"][:3])]
            fwd, total, events = outs[policy][3:]
            smoke.emit("transposed", layer=label, policy=policy,
                       rel_err_y=errs[0], rel_err_dx=errs[1],
                       rel_err_dw=errs[2], tol=LAYER_TOL,
                       forward_launches=fwd, launches=total,
                       dispatch=events)
            check(fwd == {k: int(k == fwd_kernel) for k in KERNELS},
                  f"{label} {policy}: forward launches {fwd}")
            check(max(errs) <= LAYER_TOL,
                  f"{label}: {policy} vs the lax materialization {errs}")


def phase_train(smoke, torch, conv, kernels, cnn_bp, autoencoder_bp, dev):
    """The trainers' CLIs at their defaults under pallas, then lax,
    traditional and auto.  Returns each path's kernel launches, every path
    run with the counts set to 0 just before it and read just after."""
    paths = {}

    def run(path, fn):
        conv.reset_dispatch_events()
        kernels.reset_launch_counts()
        res = fn()
        paths[path] = kernels.launch_counts()
        return res, paths[path], conv.dispatch_events()

    res, counts, events = run("cnn_bp pallas", lambda: cnn_bp.main(
        ["--policy", "pallas", "--device", str(dev)]))      # accuracy floor
    smoke.emit("train", model="cnn", policy="pallas",
               steps=len(res["losses"]), eval_acc=res["eval_acc"],
               seconds=res["seconds"], first_loss=res["losses"][0],
               last_loss=res["losses"][-1], launches=counts, dispatch=events)
    check(res["eval_acc"] > 0.9, f"eval accuracy {res['eval_acc']} <= 0.9")
    check(all(counts[k] > 0 for k in TAP_KERNELS),
          f"a tap kernel was never launched on the main path: {counts}")
    check(set(events) == {"forward:pallas", "input_grad:pallas",
                          "weight_grad:pallas"}, f"dispatch {events}")

    lax = cnn_bp.train("lax", steps=20, device=dev)
    diff = max(abs(a - b) for a, b in zip(res["losses"][:20], lax["losses"]))
    smoke.emit("train", model="cnn", policy="lax", steps=20,
               max_loss_diff_vs_pallas=diff, tol=LOSS_TOL,
               seconds=lax["seconds"])
    check(diff <= LOSS_TOL, f"pallas vs lax losses differ by {diff}")

    trad, counts, events = run("cnn_bp traditional", lambda: cnn_bp.train(
        "traditional", steps=20, device=dev))
    diff = max(abs(a - b) for a, b in zip(trad["losses"], lax["losses"]))
    smoke.emit("train", model="cnn", policy="traditional", steps=20,
               max_loss_diff_vs_lax=diff, tol=LOSS_TOL,
               seconds=trad["seconds"], launches=counts, dispatch=events)
    check(diff <= LOSS_TOL, f"traditional vs lax losses differ by {diff}")
    check(counts["matmul"] > 0 and not any(counts[k] for k in TAP_KERNELS),
          f"traditional should run matmul only: {counts}")

    conv.reset_dispatch_events()
    auto = cnn_bp.train("auto", steps=50, device=dev)
    events = conv.dispatch_events()
    smoke.emit("train", model="cnn", policy="auto", steps=50,
               eval_acc=auto["eval_acc"], last_loss=auto["losses"][-1],
               seconds=auto["seconds"], dispatch=events)
    check(all(map(lambda v: v == v and abs(v) < 1e3, auto["losses"])),
          "auto run produced non-finite losses")
    check(events.get("forward:pallas", 0) > 0
          and events.get("forward:bp_phase", 0) > 0,
          f"auto should run strided convs on pallas, the depthwise stride-1 "
          f"conv on bp_phase: {events}")

    ae, counts, events = run("autoencoder_bp pallas", lambda:
                             autoencoder_bp.main(["--policy", "pallas",
                                                  "--device", str(dev)]))
    smoke.emit("train", model="autoencoder", policy="pallas",
               steps=len(ae["mses"]), seconds=ae["seconds"],
               first_mse=ae["mses"][0], final_mse=ae["mses"][-1],
               mse_floor=0.05, launches=counts, dispatch=events)
    check(ae["mses"][-1] < 0.05, f"autoencoder MSE {ae['mses'][-1]}")
    check(all(counts[k] > 0 for k in TAP_KERNELS) and counts["matmul"] == 0,
          f"autoencoder under pallas: launches {counts}")
    check(events.get("forward_T:pallas", 0) > 0, f"dispatch {events}")

    short = autoencoder_bp.train("pallas", steps=20, device=dev)
    trad, counts, events = run("autoencoder_bp traditional", lambda:
                               autoencoder_bp.train("traditional", steps=20,
                                                    device=dev))
    diff = max(abs(a - b) for a, b in zip(trad["mses"], short["mses"]))
    smoke.emit("train", model="autoencoder", policy="traditional", steps=20,
               max_mse_diff_vs_pallas=diff, tol=LOSS_TOL,
               seconds=trad["seconds"], pallas_seconds=short["seconds"],
               launches=counts, dispatch=events)
    check(diff <= LOSS_TOL, f"traditional vs pallas MSEs differ by {diff}")
    check(counts["matmul"] > 0 and not any(counts[k] for k in TAP_KERNELS),
          f"autoencoder under traditional: launches {counts}")
    return paths


def phase_autotune(smoke, torch, ops, tg, ref, autotune, config, kernels,
                   cnn_bp, shapes, off_counts, dev):
    """The measured autotuner (``kernels/autotune.py``), each step over a
    fresh temporary plan cache, never the default one (a cache an earlier
    run left would change the plans).  At each of ``shapes``
    (``phase_kernels``' rows) and each role: every candidate plan against
    the plain version (``REL_TOL``, bit-equal run to run) with its device
    time, and the tuner's winner (``autotune="measure"``: the top
    ``config.autotune_top_k`` timed by CUDA-graph replay) beside the
    analytic plan.  Then the CNN CLI under ``--policy pallas --autotune
    measure`` and again under ``--autotune cached`` over the same cache:
    the cached run is served only hits, its per-step losses are
    ``torch.equal`` to the measure run's, its eval accuracy is > 0.9 and
    its launches are ``off_counts`` (the ``off`` run's).  Returns both
    runs' launches; config is back to ``autotune="off"`` after."""
    import shutil
    import tempfile
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_plans_"))
    paths = {}
    try:
        config.update(autotune="measure", plan_cache_dir=str(tmp / "shapes"))
        ops.reset_plan_events()
        for i, (layer, d, g, _) in enumerate(shapes):
            gen = torch.Generator().manual_seed(400 + i)
            x = torch.randn(d.B, d.C * g, d.H_i, d.W_i, generator=gen).to(dev)
            w = torch.randn(d.N * g, d.C, d.K_h, d.K_w, generator=gen).to(dev)
            dy = torch.randn(d.B, d.N * g, d.H_o, d.W_o,
                             generator=gen).to(dev)
            src, wt, taps = ops.forward_operands(x, w, d, g)
            gsrc, ws, pp = ops.input_grad_operands(dy, w, d, g)
            wsrc, dyn, wtaps = ops.weight_grad_operands(x, dy, d, g)
            calls = {
                "forward": (
                    lambda p: tg.tap_gemm(src, wt, taps, d.H_o, d.W_o, p),
                    lambda: ref.tap_gemm_ref(src, wt, taps, d.H_o, d.W_o)),
                "input_grad": (
                    lambda p: tg.tap_gemm_phased(gsrc, ws, pp.phase_taps,
                                                 pp.n_qh, pp.n_qw, p),
                    lambda: ref.tap_gemm_phased_ref(gsrc, ws, pp.phase_taps,
                                                    pp.n_qh, pp.n_qw)),
                "weight_grad": (
                    lambda p: tg.tap_wgrad(wsrc, dyn, wtaps, d.H_o, d.W_o,
                                           p),
                    lambda: ref.tap_wgrad_ref(wsrc, dyn, wtaps, d.H_o,
                                              d.W_o))}
            for role, (kern, plain) in calls.items():
                want = plain()
                tuned = ops.pass_plan(role, d, g, dev)
                rows = []
                for plan in ops.plan_candidates(role, d, g, k=100,
                                                device=dev):
                    got = kern(plan)
                    torch.cuda.synchronize()
                    err, _ = rel_err(torch, got, want)
                    check(err <= REL_TOL, f"{role} at {layer} under "
                                          f"{plan.key}: relative error {err}")
                    check(bool(torch.equal(got, kern(plan))),
                          f"{role} at {layer} under {plan.key} differs run "
                          "to run")
                    rows.append({"variant": plan.variant,
                                 "splits": plan.splits, "max_rel_err": err,
                                 "ms": time_ms(torch, lambda: kern(plan))})
                mine = next(r for r in rows
                            if (r["variant"], r["splits"]) == tuned.key)
                smoke.emit("autotune", layer=layer, role=role, groups=g,
                           analytic=rows[0],
                           tuned={**mine, "measured_us": tuned.measured_us,
                                  "candidates_timed": tuned.candidates_timed,
                                  "cache": tuned.cache},
                           analytic_over_tuned=rows[0]["ms"] / mine["ms"],
                           candidates=rows, tol=REL_TOL)
                check(tuned.autotuned and tuned.cache == "miss"
                      and tuned.candidates_timed == min(
                          len(rows), config.autotune_top_k),
                      f"{role} at {layer}: tuner gave {tuned}")
        events = ops.plan_events()
        check(set(events) == {f"{r}_autotune_miss" for r in ops.PLAN_ROLES},
              f"tuner events at the shapes: {events}")

        argv = ["--policy", "pallas", "--device", str(dev),
                "--plan-cache-dir", str(tmp / "train")]
        runs = {}
        for mode in ("measure", "cached"):
            kernels.reset_launch_counts()
            ops.reset_plan_events()
            res = cnn_bp.main(argv + ["--autotune", mode])
            counts = paths[f"cnn_bp pallas autotune {mode}"] = \
                kernels.launch_counts()
            events = ops.plan_events()
            plans = sorted(
                [k.split("|")[1], k.split("|")[-2], p.variant, p.splits,
                 p.measured_us, p.cache]
                for k, p in autotune._MEMO.items())
            runs[mode] = res, events, plans
            smoke.emit("autotune", model="cnn", policy="pallas",
                       autotune=mode, steps=len(res["losses"]),
                       eval_acc=res["eval_acc"], seconds=res["seconds"],
                       first_step_seconds=res["first_step_seconds"],
                       last_loss=res["losses"][-1], launches=counts,
                       plan_events=events, plans=plans)
            check(res["eval_acc"] > 0.9,
                  f"autotune {mode}: eval accuracy {res['eval_acc']}")
        (meas, ev_m, plans_m), (cached, ev_c, plans_c) = \
            runs["measure"], runs["cached"]
        check(set(ev_m) == {f"{r}_autotune_miss" for r in ops.PLAN_ROLES},
              f"measure run: {ev_m}")
        check(set(ev_c) == {f"{r}_autotune_hit" for r in ops.PLAN_ROLES}
              and sum(ev_c.values()) == sum(ev_m.values()),
              f"cached run: {ev_c} (measure run: {ev_m})")
        check([p[:4] for p in plans_c] == [p[:4] for p in plans_m],
              "the cached run's plans differ from the measure run's")
        check(bool(torch.equal(torch.tensor(cached["losses"]),
                               torch.tensor(meas["losses"]))),
              "cached run's losses differ from the measure run's")
        check(paths["cnn_bp pallas autotune cached"] == off_counts,
              f"cached run launched {paths['cnn_bp pallas autotune cached']}"
              f", the off run {off_counts}")
    finally:
        config.update(autotune="off", plan_cache_dir=None)
        ops.reset_plan_events()
        shutil.rmtree(tmp, ignore_errors=True)
    return paths


#: (label, B, H, Hk, Lq, Lk, causal, dtype name, D); the first is the shape
#: a 1,024-token prefill gives the kernel on the SmolLM serving path; the
#: moonshot-v1-16b-a3b prefill's (16 heads of 128) and DeepSeek-V3 MLA's
#: (128 heads of 192: qk_nope 128 + qk_rope 64) follow the SmolLM cases.
FLASH_CASES = (
    [("serve P1024 bf16", 1, 15, 5, 1024, 1024, True, "bfloat16", 64)]
    + [(f"serve P{p} {dt[0]}{dt[-2:]}", 1, 15, 5, p, p, True, dt, 64)
       for dt in ("bfloat16", "float32") for p in (512, 1024, 2048)
       if (p, dt) != (1024, "bfloat16")]
    + [("ragged P1000 bf16", 1, 15, 5, 1000, 1000, True, "bfloat16", 64),
       ("full P1024 bf16", 1, 15, 5, 1024, 1024, False, "bfloat16", 64),
       ("q256 k1024 bf16", 1, 15, 5, 256, 1024, True, "bfloat16", 64),
       ("Hk=H P1024 bf16", 1, 15, 15, 1024, 1024, True, "bfloat16", 64),
       ("moonshot P1024 bf16", 1, 16, 16, 1024, 1024, True, "bfloat16", 128)]
    + [(f"mla {shape} {dt[0]}{dt[-2:]}", 1, 128, 128, lq, 1024, True, dt, 192)
       for shape, lq in (("P1024", 1024), ("q256 k1024", 256))
       for dt in ("bfloat16", "float32")])


def attention_pairs(lq: int, lk: int, causal: bool) -> int:
    """(query, key) pairs the masks keep: row i sees keys j <= lk - lq + i
    under ``causal``."""
    if not causal:
        return lq * lk
    return sum(min(lk, lk - lq + i + 1) for i in range(lq))


def phase_flash(smoke, torch, F, fa, kref, dev):
    """``flash_attention`` against its plain version at ``FLASH_CASES``.
    Returns the first case's record (the serving shape), which makes up
    the kernel's row of the final ``kernels`` line."""
    first = None
    for i, (label, b, h, hk, lq, lk, causal, dt, d) in enumerate(
            FLASH_CASES):
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(300 + i)
        q = torch.randn(b, h, lq, d, device=dev, generator=gen).to(dtype)
        k = torch.randn(b, hk, lk, d, device=dev, generator=gen).to(dtype)
        v = torch.randn(b, hk, lk, d, device=dev, generator=gen).to(dtype)
        kern = lambda: fa.flash_attention(q, k, v, causal=causal)  # noqa: E731
        plain = lambda: kref.flash_attention_ref(  # noqa: E731
            q, k, v, causal=causal)
        # SDPA's is_causal aligns the mask top-left; with fewer queries
        # than keys the kernel's bottom-right mask goes in explicitly.
        mask = (torch.ones(lq, lk, dtype=torch.bool, device=dev).tril(lk - lq)
                if causal and lq != lk else None)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=hk != h)
        before = fa.LAUNCHES["flash_attention"]
        got = kern()
        launches = fa.LAUNCHES["flash_attention"] - before
        want = plain()
        torch.cuda.synchronize()
        err, abs_err = rel_err(torch, got, want)
        lib_err, _ = rel_err(torch, lib(), want)
        check(bool(torch.equal(got, kern())),
              f"flash_attention differs run to run at {label}")
        flops = 4.0 * b * h * d * attention_pairs(lq, lk, causal)
        by = nbytes(q, k, v, got)
        b_s, b_by = bound(flops, by, PEAK_BF16_FLOPS
                          if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
        tol = BF16_TOL if dtype == torch.bfloat16 else FLASH_TOL
        rec = {"kernel": "flash_attention", "case": label,
               "q": [b, h, lq, d], "kv": [b, hk, lk, d], "causal": causal,
               "dtype": dt, "max_rel_err": err, "max_abs_err": abs_err,
               "tol": tol, "library_rel_err": lib_err,
               "launches_per_call": launches,
               "kernel_ms": time_ms(torch, kern),
               "kernel_host_ms": host_ms(torch, kern),
               "plain_ms": time_ms(torch, plain),
               "library_ms": time_ms(torch, lib),
               "bound_us": b_s * 1e6, "bound_by": b_by,
               "gflop": flops / 1e9, "mbytes": by / 1e6}
        rec["roofline_share"] = rec["bound_us"] / 1e3 / rec["kernel_ms"]
        smoke.emit("flash", **rec)
        check(launches == 1, f"flash_attention: {launches} launches")
        check(err <= tol, f"flash_attention at {label}: relative error "
                          f"{err} > {tol}")
        if first is None:
            first = {"ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
                     "library_ms": rec["library_ms"], "flops": flops,
                     "bytes": by, "max_abs_err": abs_err,
                     "peak": PEAK_BF16_FLOPS}
    return first


SERVE_ARGV = ["--full", "--requests", "8", "--prompt-len", "1024",
              "--max-new", "32", "--max-batch", "4"]


def prefill_vs_scan(torch, M, T, cfg, params, prompt, dev):
    """The one-pass prefill against a lockstep scan of decode steps on one
    prompt: relative errors of the last logits and, per layer (stack by
    stack), of its cache (K and V, or MLA's ``c_kv`` and ``k_rope``); the
    median and the share over ``SERVE_BF16_TOL`` of the per-position errors
    (each position's largest difference over the layer's largest value,
    the worse of its two leaves); the kernel launches of each side, and
    the prefill's and the scan's wall times."""
    from repro_torch import kernels
    toks = torch.as_tensor([prompt], device=dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = M.prefill(params, toks, cfg, len(prompt) + 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre_launches = kernels.launch_counts()["flash_attention"]
    kernels.reset_launch_counts()
    scan = T.init_cache(cfg, 1, len(prompt) + 1, dev)
    t0 = time.perf_counter()
    for t in range(len(prompt)):
        want, scan = M.decode_step(params, scan, toks[:, t], t, cfg)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    scan_launches = kernels.launch_counts()["flash_attention"]
    kv, rows = [], []
    for name in cache:
        for i in range(len(next(iter(cache[name].values())))):
            kv.append(max(rel_err(torch, c[i], scan[name][key][i])[0]
                          for key, c in cache[name].items()))
            rows.append(torch.stack([
                (c[i, :, :len(prompt)].float()
                 - scan[name][key][i, :, :len(prompt)].float()).abs()
                .flatten(2).amax((0, 2))
                / scan[name][key][i].float().abs().max().clamp(min=1e-30)
                for key, c in cache[name].items()]).amax(0))
    rows = torch.stack(rows)
    return {"rel_err_logits": rel_err(torch, logits, want)[0],
            "rel_err_kv_max": max(kv), "rel_err_kv_by_layer": kv,
            "rel_err_kv_position_median": rows.median().item(),
            "kv_positions_over_tol_share": (rows > SERVE_BF16_TOL).float()
            .mean().item(),
            "prefill_launches": pre_launches, "scan_launches": scan_launches,
            "prefill_seconds": prefill_s, "scan_seconds": scan_s}


def margin_at(torch, M, cfg, params, req, step, dev) -> float:
    """Top-2 logit margin of the next-token logits after ``req.prompt`` and
    the first ``step`` generated tokens (a prefill: MoE layers drop no
    token there, as in the engines)."""
    toks = torch.as_tensor([req.prompt + req.out[:step]], device=dev)
    logits, _ = M.prefill(params, toks, cfg, toks.shape[1])
    top = torch.topk(logits[0].float(), 2).values
    return (top[0] - top[1]).item()


def engines_agree(torch, serve, M, cfg, params, prompt_len, max_new, dev):
    """8 requests through both engines (static in one wave of 8, continuous
    on 4 lanes): how many got identical greedy tokens, and for each that
    did not, the first differing step's top-2 logit margin."""
    import numpy as np
    runs = {}
    for engine, cls in serve.ENGINES.items():
        eng = cls(cfg, params, max_batch=8 if engine == "static" else 4,
                  max_len=prompt_len + max_new + 2)
        rng = np.random.RandomState(0)
        for rid in range(8):
            eng.submit(serve.Request(
                rid=rid, prompt=rng.randint(0, cfg.vocab,
                                            prompt_len).tolist(),
                max_new=max_new))
        runs[engine] = sorted(eng.run(), key=lambda r: r.rid)
    diffs = []
    for a, b in zip(runs["static"], runs["continuous"]):
        if a.out != b.out:
            step = next(i for i, (x, y) in enumerate(zip(a.out, b.out))
                        if x != y)
            diffs.append({"rid": a.rid, "step": step, "margin": margin_at(
                torch, M, cfg, params, a, step, dev)})
    return {"identical": sum(a.out == b.out for a, b in
                             zip(runs["static"], runs["continuous"])),
            "requests": len(runs["static"]), "differing": diffs,
            "margin_tol": MARGIN_TOL}


def device_time(torch, fn, reps: int = 3) -> dict:
    """Host wall time of ``fn`` (median of ``reps`` runs, each ended by a
    synchronize) against the device time its kernels take, from one run
    under ``torch.profiler`` (kernels summed by name; the busy share is
    device time over the unprofiled wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Device-side events only (kernels, copies): a CPU op's self device
    # time repeats the time of the kernels it launched.
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    wall_ms = statistics.median(walls) * 1e3
    busy_ms = sum(e.device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.device_time_total)[:6]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "device_events": sum(e.count for e in dev),
            "top_kernels_ms": {e.key[:80]: e.device_time_total / 1e3
                               for e in top}}


def phase_serve(smoke, torch, kernels, serve, M, T, dev):
    """SmolLM-360M at full width: prefill vs the decode scan in bf16 and
    float32, the launcher for both engines, and the float32 engines'
    greedy tokens.  Returns each engine's kernel launches."""
    import dataclasses
    full = serve.get_config("smollm-360m")
    cfg32 = dataclasses.replace(full, param_dtype="float32",
                                act_dtype="float32",
                                n_layers=SERVE_F32_LAYERS)
    prompt = prompt_for(full, 1024)
    for cfg, tol in ((full, SERVE_BF16_TOL), (cfg32, SERVE_F32_TOL)):
        params, info = init_timed(torch, serve, M, cfg, dev)
        prefill_check(smoke, "serve", torch, M, T, cfg, params, prompt, dev,
                      tol, check="prefill vs decode scan", **info)
        if cfg is full:
            # Where a request's time goes: one prefill of the prompt, and
            # one decode step of a full batch of 4 lanes past it.
            toks = torch.as_tensor([prompt], device=dev)
            cache = T.init_cache(cfg, 4, len(prompt) + 34, dev)
            nxt = toks[0, :4].clone()
            pos = torch.full((4,), len(prompt), device=dev)
            smoke.emit("serve", check="device time", dtype=cfg.param_dtype,
                       prefill=device_time(torch, lambda: M.prefill(
                           params, toks, cfg, len(prompt) + 34)),
                       decode_step_batch4=device_time(
                           torch, lambda: M.decode_step(params, cache, nxt,
                                                        pos, cfg)))
        del params
        free_card(torch)

    paths = serve_engines(smoke, "serve", torch, kernels, serve, full,
                          {e: SERVE_ARGV for e in ("static", "continuous")},
                          dev)
    # The static engine serves the 8 requests in one wave of 8 (one
    # lockstep prefill, not two); the continuous one recycles 4 lanes.
    params = serve.init_params(cfg32, 0, dev)
    rec = engines_agree(torch, serve, M, cfg32, params, 1024, 32, dev)
    smoke.emit("serve", check="float32 greedy tokens, static vs continuous",
               **rec)
    check(all(d["margin"] < MARGIN_TOL for d in rec["differing"]),
          f"float32 engines disagree beyond a near-tie: {rec['differing']}")
    return paths


def serve_engines(smoke, phase, torch, kernels, serve, cfg, argvs,
                  dev) -> dict:
    """``launch.serve.main(argv + ["--engine", engine])`` for each engine
    of ``argvs`` (8 requests each): every request ``ok`` with
    ``--max-new`` tokens; the continuous engine admits all 8 and launches
    the kernel once a layer per request, the static engine (lockstep
    prefill through the decode path) never; tokens/s, p50 latency, peak
    memory.  Returns each engine's launches as ``"{phase} {engine}"``."""
    paths = {}
    for engine, argv in argvs.items():
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        res = serve.main(argv + ["--engine", engine])
        counts = paths[f"{phase} {engine}"] = kernels.launch_counts()
        s, reqs = res["summary"], res["requests"]
        max_new = int(argv[argv.index("--max-new") + 1])
        smoke.emit(phase, engine=engine, config=cfg.name,
                   dtype=cfg.param_dtype, requests=len(reqs),
                   prompt_len=int(argv[argv.index("--prompt-len") + 1]),
                   status=sorted({r.status for r in reqs}),
                   tokens=[len(r.out) for r in reqs],
                   admitted=s["admitted"], waves=s["waves"],
                   decode_steps=s["decode_steps"],
                   prefill_s_per_request=s["prefill_s"] / len(reqs),
                   decode_ms_per_step=1e3 * s["decode_s"]
                   / max(s["decode_steps"], 1),
                   tok_s=res["tok_s"], p50_latency_s=res["p50_latency_s"],
                   seconds=res["seconds"],
                   max_memory_allocated_bytes=torch.cuda.max_memory_allocated(
                       dev), launches=counts, summary=s)
        check(len(reqs) == 8 and all(r.status == "ok"
                                     and len(r.out) == max_new
                                     for r in reqs),
              f"{cfg.name} {engine}: "
              f"{[(r.status, len(r.out)) for r in reqs]}")
        want = cfg.n_layers * s["admitted"] if engine == "continuous" else 0
        check(counts["flash_attention"] == want
              and (engine == "static" or s["admitted"] == 8),
              f"{cfg.name} {engine}: {counts['flash_attention']} flash "
              f"launches, {s['admitted']} admitted")
        del res
        free_card(torch)
    return paths

#: moonshot-v1-16b-a3b at full width through the launcher: the continuous
#: engine on 1,024-token prompts, the static engine (whose lockstep prefill
#: is 128 decode steps a wave) on 128-token prompts.
SERVE_MOE_ARGV = {
    "continuous": ["--full", "--arch", "moonshot-v1-16b-a3b", "--requests",
                   "8", "--prompt-len", "1024", "--max-new", "32",
                   "--max-batch", "4"],
    "static": ["--full", "--arch", "moonshot-v1-16b-a3b", "--requests", "8",
               "--prompt-len", "128", "--max-new", "8", "--max-batch", "4"]}
#: prompt of the MoE prefill-vs-scan checks (the scan reads every expert
#: of every layer at each of its steps).
MOE_PROMPT = 512
#: the float32 moonshot checks run 4 of its 48 layers (the dense first
#: layer and 3 MoE layers), every width kept.
MOE_F32_LAYERS = 4
#: DeepSeek-V3 at its published widths: 4 of its 61 layers (the 3 dense
#: ones and the first MoE layer), 15.8 B parameters, 31.6 GB in bf16.
DEEPSEEK_LAYERS = 4


def free_card(torch) -> None:
    """Return what the last model held to the card (between models)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def init_timed(torch, serve, M, cfg, dev) -> tuple[dict, dict]:
    """The model's parameters from seed 0, with their count (total and
    active), bytes and the seconds the draw took."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = serve.init_params(cfg, 0, dev)
    torch.cuda.synchronize()
    from repro_torch.tree import tree_leaves
    return params, {"init_s": time.perf_counter() - t0,
                    "n_params": M.count_params(params),
                    "n_active_params": M.count_active_params(params, cfg),
                    "param_bytes": nbytes(*tree_leaves(params))}


def prefill_check(smoke, phase, torch, M, T, cfg, params, prompt, dev, tol,
                  flip_free_tol=None, **fields) -> dict:
    """``prefill_vs_scan`` on the card, emitted with ``fields``: one kernel
    launch a layer in the prefill, none in the scan; the largest errors
    within ``tol`` and, where given, those of the layers no routing flip
    reaches (up to the first MoE layer) within ``flip_free_tol``."""
    rec = prefill_vs_scan(torch, M, T, cfg, params, prompt, dev)
    flip_free = rec["rel_err_kv_by_layer"][:cfg.first_dense_layers + 1]
    rec.update(config=cfg.name, dtype=cfg.param_dtype, layers=cfg.n_layers,
               prompt_len=len(prompt), tol=tol, flip_free_tol=flip_free_tol,
               rel_err_kv_flip_free_max=max(flip_free), **fields)
    smoke.emit(phase, **rec)
    check(rec["prefill_launches"] == cfg.n_layers
          and rec["scan_launches"] == 0,
          f"{cfg.name}: prefill launched {rec['prefill_launches']}, the "
          f"scan {rec['scan_launches']}")
    check(max(rec["rel_err_logits"], rec["rel_err_kv_max"]) <= tol
          and (flip_free_tol is None or max(flip_free) <= flip_free_tol),
          f"{cfg.name} {cfg.param_dtype} prefill vs decode scan: logits "
          f"{rec['rel_err_logits']}, cache {rec['rel_err_kv_max']}, layers "
          f"before routing {max(flip_free)}")
    return rec


def prompt_for(cfg, n: int, seed: int = 0) -> list[int]:
    import numpy as np
    return np.random.RandomState(seed).randint(0, cfg.vocab, n).tolist()


def serve_moonshot(smoke, torch, kernels, serve, M, T, dev) -> dict:
    """moonshot-v1-16b-a3b at full width in bf16: prefill vs the decode
    scan, device times of a prefill and a decode step, and both engines
    through the launcher.  Returns the engines' kernel launches."""
    full = serve.get_config("moonshot-v1-16b-a3b")
    params, info = init_timed(torch, serve, M, full, dev)
    prefill_check(smoke, "serve_moe", torch, M, T, full, params,
                  prompt_for(full, MOE_PROMPT), dev, MOE_BF16_TOL,
                  SERVE_BF16_TOL, check="prefill vs decode scan",
                  memory_allocated_bytes=torch.cuda.memory_allocated(dev),
                  **info)
    # One 1,024-token prefill, and one decode step of 4 lanes past it.
    toks = torch.as_tensor([prompt_for(full, 1024, seed=1)], device=dev)
    cache = T.init_cache(full, 4, 1024 + 34, dev)
    nxt = toks[0, :4].clone()
    pos = torch.full((4,), 1024, device=dev)
    smoke.emit("serve_moe", check="device time", config=full.name,
               dtype=full.param_dtype,
               prefill_1024=device_time(torch, lambda: M.prefill(
                   params, toks, full, 1024 + 34)),
               decode_step_batch4=device_time(
                   torch, lambda: M.decode_step(params, cache, nxt, pos,
                                                full)))
    del params, cache
    free_card(torch)

    return serve_engines(smoke, "serve_moe", torch, kernels, serve, full,
                         SERVE_MOE_ARGV, dev)


def serve_moonshot_f32(smoke, torch, serve, M, T, dev) -> None:
    """moonshot-v1-16b-a3b in float32 at ``MOE_F32_LAYERS`` layers, every
    width kept: prefill vs the decode scan, and the engines' greedy
    tokens."""
    import dataclasses
    cfg = dataclasses.replace(serve.get_config("moonshot-v1-16b-a3b"),
                              param_dtype="float32", act_dtype="float32",
                              n_layers=MOE_F32_LAYERS)
    params, info = init_timed(torch, serve, M, cfg, dev)
    prefill_check(smoke, "serve_moe", torch, M, T, cfg, params,
                  prompt_for(cfg, MOE_PROMPT), dev, SERVE_F32_TOL,
                  check="prefill vs decode scan", **info)
    rec = engines_agree(torch, serve, M, cfg, params, MOE_PROMPT, 16, dev)
    smoke.emit("serve_moe", check="float32 greedy tokens, static vs "
               "continuous", config=cfg.name, layers=cfg.n_layers, **rec)
    check(all(d["margin"] < MARGIN_TOL for d in rec["differing"]),
          f"float32 moonshot engines disagree beyond a near-tie: "
          f"{rec['differing']}")
    del params
    free_card(torch)


def serve_deepseek(smoke, torch, kernels, serve, M, T, dev) -> dict:
    """DeepSeek-V3 at its published widths, ``DEEPSEEK_LAYERS`` layers, in
    bf16: the prefill (the kernel at head dim 192) vs the absorbed decode
    scan, and the continuous engine.  Returns the engine's launches."""
    import dataclasses
    cfg = dataclasses.replace(serve.get_config("deepseek-v3-671b"),
                              n_layers=DEEPSEEK_LAYERS)
    params, info = init_timed(torch, serve, M, cfg, dev)
    prefill_check(smoke, "serve_moe", torch, M, T, cfg, params,
                  prompt_for(cfg, MOE_PROMPT), dev, MLA_BF16_TOL,
                  check="MLA prefill vs absorbed decode scan", **info)
    kernels.reset_launch_counts()
    eng = serve.ENGINES["continuous"](cfg, params, max_batch=4,
                                      max_len=MOE_PROMPT + 16 + 2)
    for rid in range(4):
        eng.submit(serve.Request(rid=rid, prompt=prompt_for(
            cfg, MOE_PROMPT, seed=10 + rid), max_new=16))
    t0 = time.perf_counter()
    reqs = eng.run()
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    s = eng.run_summary()
    smoke.emit("serve_moe", engine="continuous", config=cfg.name,
               layers=cfg.n_layers, dtype=cfg.param_dtype,
               requests=len(reqs), prompt_len=MOE_PROMPT,
               status=sorted({r.status for r in reqs}),
               tokens=[len(r.out) for r in reqs], admitted=s["admitted"],
               decode_steps=s["decode_steps"],
               prefill_s_per_request=s["prefill_s"] / len(reqs),
               decode_ms_per_step=1e3 * s["decode_s"]
               / max(s["decode_steps"], 1),
               tok_s=sum(len(r.out) for r in reqs) / secs, seconds=secs,
               launches=counts)
    check(len(reqs) == 4 and all(r.status == "ok" and len(r.out) == 16
                                 for r in reqs),
          f"DeepSeek continuous: {[(r.status, len(r.out)) for r in reqs]}")
    check(counts["flash_attention"] == cfg.n_layers * 4,
          f"DeepSeek continuous: {counts['flash_attention']} flash launches")
    del params, eng
    free_card(torch)
    return {"serve_mla continuous": counts}


def phase_serve_moe(smoke, torch, kernels, serve, M, T, dev) -> dict:
    """The MoE family on the card: moonshot-v1-16b-a3b at full width in
    bf16 and, at ``MOE_F32_LAYERS`` layers, in float32; DeepSeek-V3's MLA
    at its published widths, ``DEEPSEEK_LAYERS`` layers.  Returns each
    serving path's kernel launches."""
    paths = serve_moonshot(smoke, torch, kernels, serve, M, T, dev)
    serve_moonshot_f32(smoke, torch, serve, M, T, dev)
    paths.update(serve_deepseek(smoke, torch, kernels, serve, M, T, dev))
    return paths


#: the launcher's own --lr: 3e-3 (what examples/train_lm.py passes at the
#: smoke config) drives the full-width model's loss up within 30 steps of
#: a one-step warmup on the H100 (PERF.md, §6).
LM_TRAIN_ARGV = ["--arch", "smollm-360m", "--batch", "8", "--seq", "512",
                 "--lr", "3e-4", "--log-every", "5"]


def phase_lm_train(smoke, torch, kernels, train, smi, dev):
    """SmolLM-360M trained at full width through the port's launcher: runs
    (a)-(d), their checks, and one profiled step.  Returns the path's
    kernel launches (counts set to 0 just before (a), read after (d))."""
    import shutil
    import tempfile

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    t_phase = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="lm_train_"))
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    hist = {}

    def run(name, extra):
        hist[name] = []
        return train.main(LM_TRAIN_ARGV + extra, history=hist[name])

    try:
        full = ["--steps", "30", "--ckpt-every", "15"]
        a = run("a", full + ["--ckpt-dir", str(tmp / "a")])
        shutil.rmtree(tmp / "a")
        b = run("b", full + ["--ckpt-dir", str(tmp / "b"),
                             "--stop-after", "15"])
        b += run("b resumed", full + ["--ckpt-dir", str(tmp / "b")])
        shutil.rmtree(tmp / "b")
        # (a)'s schedule, so that each of (c)'s steps is one of (a)'s.
        c = run("c", ["--steps", "30", "--stop-after", "5", "--accum", "2"])
        cfg = train.get_config("smollm-360m")
        params = M.init_params(torch.Generator().manual_seed(0), cfg, dev)
        opt = adamw.init_state(params)
        lr = float(LM_TRAIN_ARGV[LM_TRAIN_ARGV.index("--lr") + 1])
        step_fn = TS.make_train_step(cfg, adamw.AdamWConfig(peak_lr=lr),
                                     total_steps=30, warmup=1,
                                     compress_grads=True)
        dcfg = DataConfig(seed=0, seq_len=512, global_batch=8,
                          vocab=cfg.vocab)
        d = []
        for step in range(5):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in make_batch(cfg, dcfg, step).items()}
            params, opt, metrics = step_fn(params, opt, batch, step)
            d.append(float(metrics["loss"]))
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = [h["seconds"] for h in hist["a"]]
    step_s = statistics.median(secs)
    rel = lambda x, y: abs(x - y) / abs(y)     # noqa: E731
    resume_err = max(rel(x, y) for x, y in zip(b, a))
    # The forward, the summed microbatch gradients, and one update.
    accum_err = {"loss_0": rel(c[0], a[0]),
                 "grad_norm_0": rel(hist["c"][0]["grad_norm"],
                                    hist["a"][0]["grad_norm"]),
                 "loss_1": rel(c[1], a[1])}
    smoke.emit("lm_train", nvidia_smi=smi, config="smollm-360m",
               dtype=cfg.param_dtype, batch=8, seq=512, lr=lr,
               n_params=M.count_params(params),
               median_step_s=step_s, first_step_s=secs[0],
               tokens_per_s=8 * 512 / step_s,
               max_memory_allocated_bytes=peak,
               losses={"a": a, "b": b, "c": c, "d": d},
               grad_norms={k: [h["grad_norm"] for h in v]
                           for k, v in hist.items()},
               first_loss=a[0], last_loss=a[-1],
               guard_bad={k: sum(h["guard_bad"] for h in v)
                          for k, v in hist.items()},
               resume_max_rel_err=resume_err, accum_rel_err=accum_err,
               tol=LM_TRAIN_TOL, grad_norm_tol=LM_GNORM_TOL,
               launches=launches,
               seconds=time.perf_counter() - t_phase)
    every = a + b + c + d
    check(all(math.isfinite(x) for x in every), f"non-finite loss: {every}")
    check(not any(h["guard_bad"] for v in hist.values() for h in v),
          "the guard dropped a step")
    check(len(a) == len(b) == 30 and len(c) == len(d) == 5,
          f"steps run: {len(a)}, {len(b)}, {len(c)}, {len(d)}")
    check(statistics.mean(a[-5:]) < a[0],
          f"(a) did not learn: first {a[0]}, last five {a[-5:]}")
    check(resume_err <= LM_TRAIN_TOL,
          f"resumed run differs from the uninterrupted one by {resume_err}")
    check(max(accum_err["loss_0"], accum_err["loss_1"]) <= LM_TRAIN_TOL
          and accum_err["grad_norm_0"] <= LM_GNORM_TOL,
          f"accum 2 differs from accum 1: {accum_err}")
    check(d[-1] < d[0], f"compressed run did not fall: {d}")
    check(not any(launches.values()),
          f"a kernel launched while training: {launches}")

    # One guarded step as the launcher runs it, under the profiler, last.
    step_fn = TS.make_train_step(cfg, adamw.AdamWConfig(peak_lr=lr),
                                 total_steps=30, warmup=1,
                                 guard=TS.GuardConfig())
    opt = adamw.init_state(params)
    prof = device_time(torch, lambda: step_fn(params, opt, batch, 0))
    smoke.emit("lm_train", check="one profiled step", nvidia_smi=smi,
               **prof)
    return {"lm_train": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the phase lines to this file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    from torch.nn import grad as nn_grad

    from repro_torch import kernels
    from repro_torch.configs import paper_cnn
    from repro_torch.core import bpim2col, conv
    from repro_torch.core.config import config
    from repro_torch.core.convspec import ConvSpec, ConvTransposeSpec
    from repro_torch.core.im2col_ref import ConvDims
    from repro_torch.kernels import autotune, build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import tap_gemm as tg
    from repro_torch.launch import serve, train
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.train import autoencoder_bp, cnn_bp

    smoke = Smoke(args.out)
    config.update(autotune="off", plan_cache_dir=None)   # analytic plans
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    smoke.emit("device", nvidia_smi=smi, kind=kind,
               count=torch.cuda.device_count(), torch=torch.__version__,
               cuda=torch.version.cuda,
               cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
               matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    t0 = time.perf_counter()
    libs = build.build()
    ptxas = [ln.strip() for log in build.build_dir().glob("*.log")
             for ln in log.read_text().splitlines()
             if re.search(r"registers|spill|Compiling entry", ln)]
    smoke.emit("build", seconds=time.perf_counter() - t0,
               libraries={k: str(v) for k, v in libs.items()}, ptxas=ptxas)
    resources = kernel_resources(build.build_dir())
    smoke.emit("build", redesigned_kernels=resources)
    check(sorted(r["kernel"] for r in resources)
          == sorted(k for k, (_, n) in REDESIGNED.items() for _ in range(n))
          and all("registers" in r for r in resources),
          f"build logs lack the redesigned kernels' entries: {resources}")
    occupancy = plan_occupancy(tg, mm)
    smoke.emit("build", occupancy=occupancy)
    check_occupancy(occupancy)

    table2 = [("/".join(map(str, layer)), paper_cnn.dims(layer))
              for layer in paper_cnn.TABLE2_LAYERS]
    dev = torch.device("cuda")
    shapes = ([(label, d, 1, True) for label, d in table2]
              + cnn_shapes(ConvDims))
    ae = ae_shapes(ConvDims, conv, ConvTransposeSpec)
    agg = phase_kernels(smoke, torch, F, nn_grad, ops, tg, ref,
                        shapes + [row[:4] for row in ae], dev)
    agg["matmul"] = phase_matmul(smoke, torch, mm, ref, tg,
                                 matmul_cases(torch, conv, shapes, ae), dev)
    phase_layers(smoke, torch, conv, kernels, ConvSpec, table2, dev)
    held = torch.cuda.memory_allocated(dev)
    bpim2col.clear_gather_maps()
    smoke.emit("gather_maps", bytes_held_after_layers=held
               - torch.cuda.memory_allocated(dev))
    phase_transposed(smoke, torch, conv, kernels, ConvTransposeSpec, dev)
    paths = phase_train(smoke, torch, conv, kernels, cnn_bp, autoencoder_bp,
                        dev)
    paths.update(phase_autotune(
        smoke, torch, ops, tg, ref, autotune, config, kernels, cnn_bp,
        shapes + [row[:4] for row in ae], paths["cnn_bp pallas"], dev))
    agg["flash_attention"] = phase_flash(smoke, torch, F, fa, ref, dev)
    paths.update(phase_serve(smoke, torch, kernels, serve, M, T, dev))
    free_card(torch)
    paths.update(phase_serve_moe(smoke, torch, kernels, serve, M, T, dev))
    paths.update(phase_lm_train(smoke, torch, kernels, train, smi, dev))
    smoke.emit("summary", launches_by_path=paths)

    main_path = {k: "cnn_bp pallas" for k in TAP_KERNELS}
    main_path["matmul"] = "cnn_bp traditional"
    main_path["flash_attention"] = "serve continuous"
    shapes = {"matmul": "sum over the 15 traditional GEMMs (forward, input "
                        "grad, weight grad) of the 5 Table II layers, batch "
                        "2, float32",
              "flash_attention": "one prefill's attention: causal (1, 15, "
                                 "1024, 64) queries against (1, 5, 1024, 64) "
                                 "keys and values, bf16"}
    out = []
    for name, (replaces, source) in KERNELS.items():
        a = agg[name]
        b_s, b_by = bound(a["flops"], a["bytes"],
                          a.get("peak", PEAK_F32_FLOPS))
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": paths[main_path[name]][name],
            "max_abs_err": a["max_abs_err"], "ms": a["ms"],
            "plain_ms": a["plain_ms"], "bound_ms": b_s * 1e3,
            "bound_by": b_by, "library_ms": a["library_ms"],
            "launches_path": main_path[name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "shapes": shapes.get(name, "sum over the 5 Table II layers, "
                                       "batch 2, float32")})
    print(smi)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
