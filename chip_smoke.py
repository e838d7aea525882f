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
                   redesigned kernels (the three tap GEMMs, float32 and
                   bf16 operands, the depthwise variant of each at 16 and
                   49 taps,
                   the four ``matmul`` tiles, the bf16
                   flash attention at head dims 64, 128, 192 and 256); the
                   blocks an SM holds of each input-grad, weight-grad,
                   depthwise and ``matmul`` instance (the occupancy
                   calculator) against
                   the number their split plans assume (float32; bf16
                   reported).
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
                   could take (``bound_us``); each call's plan (the
                   analytic plan it launched with: variant and split
                   count, held to the variant it launched; the depthwise
                   variant ``dw`` for every pass at one channel a group,
                   its float32 input grad held to ``DW_F32_TOL``), the
                   input grad's partial bytes (``phased_work``; none on
                   ``dw``) and the device time of its operands
                   (``operands_ms``: ``input_grad_operands``, the same
                   CUDA-graph replay); all three are bit-equal run to
                   run.
  4. kernels_bf16 -- the same for the tap kernels' bf16-operand instances
                   at Mamba2-370M's depthwise causal conv (2,304 groups of
                   one channel, 4 taps; its training shape, 8 x 512, and a
                   1,024-token prefill) and Table II layer 4 cast to bf16:
                   the forward and the input grad return bf16 (held to
                   ``BF16_TOL``), the weight grad float32 (``REL_TOL``);
                   library = cuDNN's grouped conv (causal pad ahead), with
                   each call's plan and grid z (all three passes of the
                   conv on ``dw``); the same at recurrentgemma-9b's
                   temporal conv (4,096 groups, 4 taps; 4 x 512, its
                   training shape, and a 1,024-token prefill); then
                   ``depthwise_causal_conv1d`` forward + backward at 8 x
                   512 under ``pallas`` and ``lax``: device time by kernel
                   (the lowering's copies beside the kernels).
  5. matmul     -- the same for the ``matmul`` kernel at every lowered GEMM
                   of the ``traditional`` and ``bp_im2col`` engines at the
                   Table II and CNN shapes, at every GEMM the autoencoder
                   runs under ``traditional`` (the decoder's stride-1 GEMM
                   over the zero-inserted input among them), and one
                   bfloat16 case, each with its variant and split count
                   (``matmul_plan``) and bit-equal run to run.  Its plain
                   version and its library call are one and the same:
                   ``torch.matmul`` with TF32 off.
  6. layers     -- each Table II layer through ``conv2d(x, w, spec, p)`` and
                   ``.backward()`` for p in (pallas, traditional, bp_im2col),
                   against ``policy="lax"``; each kernel launches exactly
                   once per pass; two split-K weight grads are bit-equal;
                   the card memory the cached bp_im2col gather maps hold
                   after it, before they are released.
  7. transposed -- the autoencoder's two decoder layers and the mirror of
                   Table II layer 2 through ``conv2d_transpose`` under
                   pallas and traditional, against the ``lax``
                   materialization, for y, dx and dw; the pallas forward is
                   one ``tap_gemm_phased`` launch, the traditional one
                   ``matmul``.
  8. train      -- ``python -m repro_torch.train.cnn_bp --policy pallas`` at
                   its defaults (200 steps, batch 32) must reach eval
                   accuracy > 0.9 with all three tap kernels launched (its
                   depthwise layer's three passes on the ``dw`` variant);
                   its
                   first 20 losses agree with ``lax`` and with
                   ``traditional`` (``matmul`` launched) from the same
                   initialization; a shorter run under ``auto``.
                   ``python -m repro_torch.train.autoencoder_bp --policy
                   pallas`` at its defaults (200 steps, batch 16) must reach
                   MSE < 0.05; 20 steps under traditional match pallas.
  9. autotune   -- the measured autotuner, over fresh temporary plan caches:
                   at each shape of the kernels phase, every candidate plan
                   of each tap kernel (``ops.plan_candidates``) against the
                   plain version (``REL_TOL``) with its device time, and
                   the tuner's winner (``autotune="measure"``) beside the
                   analytic plan; then the CNN CLI under ``--policy pallas
                   --autotune measure`` and ``--autotune cached``: the
                   cached run is all hits, ``torch.equal`` losses, eval
                   accuracy > 0.9 and the ``off`` run's launches.
 10. flash      -- the ``flash_attention`` kernel against its plain version
                   (``max |kernel - plain| / max |plain|``, tolerance
                   ``FLASH_TOL`` in float32, ``BF16_TOL`` in bf16) at the
                   serving shapes, SmolLM-360M's 15 query and 5 KV heads of
                   64 over causal P in {512, 1,024, 2,048} in bf16 and
                   float32, a ragged P (1,000), a full (non-causal) case,
                   256 queries against 1,024 keys, and 15 KV heads;
                   moonshot-v1-16b-a3b's prefill (16 heads of 128, P
                   1,024, bf16) and DeepSeek-V3 MLA's (128 heads of 192,
                   causal P 1,024 and 256 queries against 1,024 keys, bf16
                   and float32) and recurrentgemma-9b's (16 heads of 256
                   against one KV head, causal P 1,024 in bf16 and float32,
                   a ragged P 1,000 and 256 queries against 1,024 keys in
                   bf16) and hubert-xlarge's encoder (4 x 16 heads of
                   80, full attention over 1,000 frames, bf16 and
                   float32); two runs are bit-equal; kernel, plain and
                   ``F.scaled_dot_product_attention`` device times (timed
                   only: the port never calls it), host time, bound.
 11. serve      -- SmolLM-360M at full width, initialised from a seed: the
                   port's prefill (one causal pass, the kernel in every
                   layer) against a lockstep scan of ``decode_step`` (plain
                   dense attention) on one 1,024-token prompt, logits and
                   every layer's cache, in bf16 at ``SERVE_BF16_LAYERS``
                   layers (``SERVE_BF16_TOL``) and, at ``SERVE_F32_LAYERS``
                   layers, float32 (``SERVE_F32_TOL``); the host wall time
                   and the device time (``torch.profiler``) of one bf16
                   prefill and one decode step of 4 lanes, all 32 layers;
                   then ``python -m repro_torch.launch.serve --full`` for
                   both engines (``SERVE_ARGV``: continuous, 8 requests of
                   1,024 tokens, 32 new, batch 4; static, 8 of 128 tokens,
                   8 new): every request ``ok`` with its tokens, the
                   continuous engine launches the kernel 32 x admitted
                   times and the static engine none; prefill s per
                   request, decode ms per step,
                   tokens/s, p50 latency; in float32 (``SERVE_F32_LAYERS``
                   layers) both engines' greedy tokens agree on the same 8
                   requests (static in one wave of 8, continuous on 4
                   lanes; where one differs, the first differing step's
                   top-2 logit margin must be under ``MARGIN_TOL``).
 12. serve_moe  -- the MoE family: moonshot-v1-16b-a3b at full width (48
                   layers, 28.4 B parameters, bf16, drawn on the card from
                   seed 0, with its init seconds): prefill vs the decode
                   scan on a ``MOE_PROMPT``-token prompt at its first
                   ``MOE_SCAN_LAYERS`` layers (largest error within
                   ``MOE_BF16_TOL``, the layers up to the first MoE
                   layer's cache within ``SERVE_BF16_TOL``; the median
                   per-position error reported; one launch a layer in the
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
 13. serve_ssm  -- Mamba2-370M at full width (48 layers, 368,227,840
                   parameters, bf16, drawn on the card from seed 0) under
                   ``conv_policy="pallas"``: the one-pass prefill (chunked
                   SSD with a ragged last chunk, the conv on ``tap_gemm``:
                   48 bf16 launches of ``dw``) vs the decode scan (none) on
                   a ``MAMBA2_PROMPT``-token prompt, logits and each layer's
                   SSM state and conv inputs (largest error within
                   ``SSM_BF16_TOL``, the first ``SSM_EARLY_LAYERS`` within
                   ``SERVE_BF16_TOL``); the device time of a 1,024-token
                   prefill and a 4-lane decode step (no launch); float32 at
                   ``SSM_F32_LAYERS`` layers: prefill vs scan
                   (``SERVE_F32_TOL``) and greedy tokens under ``pallas``
                   and ``auto``; ``launch.serve --full --arch mamba2-370m``
                   under ``--conv-policy pallas`` and ``auto``, both engines
                   (continuous: 8 requests of 1,024 tokens, 32 new, batch
                   4, 48 ``tap_gemm`` launches a request under ``pallas``;
                   static: 8 of 128 tokens, 8 new, none), tokens/s, p50,
                   peak memory.
 14. serve_hybrid -- recurrentgemma-9b at its published widths (38 layers,
                   10,444,664,832 parameters, bf16, drawn on the card from
                   seed 0) under ``conv_policy="pallas"``: at
                   ``HYBRID_SCAN_LAYERS`` layers the one-pass prefill vs
                   the decode scan on each of ``HYBRID_PROMPTS`` (1,000
                   tokens inside the 2,048-token window: the flash kernel
                   at head dim 256; 2,100 past it: the blockwise path with
                   the window mask), logits and every cache leaf within
                   ``HYBRID_BF16_TOL``, ``tap_gemm`` (``dw``) once an
                   RG-LRU layer; the 38-layer model's init, one
                   1,024-token prefill's launches (26 ``tap_gemm``, 12
                   flash) and device time, a 4-lane decode step's (no
                   launch); ``launch.serve --full --arch recurrentgemma-9b
                   --conv-policy pallas`` on both engines (continuous: 8
                   requests of 1,024 tokens, 32 new, batch 4, 26 + 12
                   launches a request; static: 8 of 128 tokens, 8 new,
                   none); float32 at ``HYBRID_F32_LAYERS`` layers: prefill
                   vs scan on 2,100 tokens (``SERVE_F32_TOL``), greedy
                   tokens of the two engines and of ``pallas`` against
                   ``auto`` (the margin rule of serve).
 15. serve_dense -- granite-3-8b, minicpm-2b and phi4-mini-3.8b at full
                   width (bf16, drawn on the card from seed 0, with their
                   init seconds; the parameter count held to the JAX
                   package's): prefill vs the decode scan on a
                   ``DENSE_PROMPT``-token prompt at ``DENSE_SCAN_LAYERS``
                   layers, bf16 (``SERVE_BF16_TOL``) and float32
                   (``SERVE_F32_TOL``); the device time of a 1,024-token
                   prefill and a 4-lane decode step at full depth;
                   ``launch.serve --full --arch <name>`` continuous, 4
                   requests of 1,024 tokens, 16 new, batch 4 (flash at D 64
                   or 128, n_layers x admitted launches), tokens/s, peak
                   memory.
 16. serve_vlm  -- internvl2-76b at its published widths cut to
                   ``VLM_LAYERS`` layers (bf16): a no-grad ``forward`` on
                   256 image embeddings and 768 text tokens (8 flash
                   launches at D 128, logits over the text only) against
                   the same forward in grad mode (dense attention, no
                   launch) within ``SERVE_BF16_TOL``; the continuous
                   engine on 4 text requests of 1,024 tokens, 16 new
                   (``VLM_LAYERS`` launches a request); prefill vs scan at
                   ``DENSE_SCAN_LAYERS`` layers on text.
 17. encode_audio -- hubert-xlarge at full width (48 layers, bf16): a
                   no-grad forward on 4 x 1,000 frames (flash non-causal
                   at D 80, 48 launches) against the grad-mode forward
                   (dense) within ``SERVE_BF16_TOL``, device time and peak
                   memory; the same in float32 at ``DENSE_SCAN_LAYERS``
                   layers within ``SERVE_F32_TOL``.
 18. lm_train   -- ``python -m repro_torch.launch.train --arch smollm-360m``
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
 19. lm_train_ssm -- ``python -m repro_torch.launch.train --arch
                   mamba2-370m --conv-policy pallas`` at the published
                   widths (bf16, seed 0, batch 8, seq 512, guard on, 6
                   steps): each layer's conv on the three tap kernels'
                   bf16 instances (``tap_gemm`` twice a layer a step, with
                   remat; the other two once; all three on ``dw``), no
                   step dropped; the first
                   loss and grad norm against the same run under ``auto``
                   (``LM_SSM_BF16_TOL``, ``LM_SSM_GNORM_TOL``; no launch);
                   float32 at ``SSM_F32_LAYERS`` layers, 5 steps of
                   ``pallas`` against ``lax`` (``LOSS_TOL``); median step
                   time, tokens/s, peak memory.
 20. lm_train_hybrid -- recurrentgemma-9b's ``make_train_step`` at its
                   published widths and ``LM_TRAIN_HYBRID_LAYERS`` layers
                   (bf16, seed 0, batch 4 x 512, guard on): 6 steps under
                   ``pallas`` (per step, 8 ``tap_gemm``, 4
                   ``tap_gemm_phased`` and 4 ``tap_wgrad`` launches, all
                   bf16 on ``dw`` at 4,096 groups), the first loss and grad
                   norm against one step under ``auto``; float32 at
                   ``HYBRID_F32_LAYERS`` layers, 5 steps of ``pallas``
                   against ``lax`` (``LOSS_TOL``); median step time,
                   tokens/s, peak memory.
 21. lm_train_audio -- ``python -m repro_torch.launch.train --arch
                   hubert-xlarge`` at full width (bf16, batch 8, seq 512,
                   6 steps, guard on; no launch: training runs dense
                   attention): finite losses, seconds a step, frames/s,
                   peak memory; float32 at ``DENSE_SCAN_LAYERS`` layers,
                   the first 3 losses of ``make_train_step`` on the card
                   against the same run on this machine's CPU from the same
                   parameters (``LOSS_TOL``).
 22. chaos      -- (run after autotune) the chaos drill
                   (``repro_torch.train.chaos``, ``pallas``, 14 steps at
                   batch 32, trace and metrics on): every assertion of the
                   drill; each tap kernel launched ``n_pallas[pass] x 13``
                   times (step 3's faulted and steps 4-5's quarantined
                   passes launch nothing); the 14 losses against the same
                   loop under ``bp_phase`` with the same NaN at step 5
                   (``LOSS_TOL``), every failure's survivor ``bp_phase``;
                   ``scripts/validate_trace.py --require-span conv:`` on its
                   trace and metrics; the bus consistent with the legacy
                   counters.
 23. chaos_serve -- (after serve) SmolLM-360M at full width, bf16, on the
                   continuous engine: 8 requests of 256 tokens, 16 new, 4
                   lanes, unarmed and then with ``serve.decode:raise@step3``
                   (telemetry on): the 4 lanes of decode step 3 end
                   ``failed`` with the unarmed run's first 3 tokens, the
                   other 4 ``ok`` with its tokens (``token_diffs``' near-tie
                   rule); flash launched 32 x 8 times; ``run_summary()
                   ["failed"] == 4``; a ``serve_tick`` line a decode step.
 24. lm_train_obs -- (after lm_train) the launcher at lm_train's settings
                   for 6 steps with ``--fault-spec grad.values:nan@step2
                   --trace --metrics``: only step 2 dropped by the guard;
                   steps 0-1's losses within ``LM_TRAIN_TOL`` of lm_train's;
                   the trace valid with a ``train:step`` span a step; a
                   ``train_step`` line a step; seconds a step beside
                   lm_train's; no kernel launched.
 25. summary    -- every kernel's launches on each path, each path run with
                   the counts set to 0 just before it and read just after.

On the card the conv dispatch degrades only on an injected fault, and
the continuous engine fails a request only on one: a kernel that fails
to build or launch raises out of its phase and fails the run.  Every
request of every serving phase but chaos_serve's armed run must end
``ok``.

Then a ``{"kernels": [...]}`` line (the five kernels; the tap kernels'
bf16 instances at Mamba2's and at recurrentgemma-9b's training shapes;
flash attention at recurrentgemma-9b's head dim 256 and, full, at
hubert-xlarge's head dim 80), and last
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
#: the depthwise input grad (``dw``) in float32, same measure: fmaf rounds
#: each tap's product and sum once where the plain version rounds twice,
#: over at most 49 taps.
DW_F32_TOL = 1e-6
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
#: Mamba2-370M's bf16 prefill (chunked SSD, the conv on ``tap_gemm``) vs
#: its decode scan (the O(1) recurrence in bf16, the conv as a 4-tap sum),
#: as max |a - b| / max |b| over the last logits and each layer's SSM state
#: and conv inputs: the same computation with bf16 roundings at other
#: places, compounding layer after layer.  On the H100 layer 0 reads 0.008
#: (its conv inputs 0.0: no rounding precedes them), the first
#: ``SSM_EARLY_LAYERS`` at most 0.018, the worst layer 0.167 and the
#: logits 0.095.  So the largest error is held to this, the first layers
#: to ``SERVE_BF16_TOL``; float32 (``SSM_F32_LAYERS`` layers) holds
#: ``SERVE_F32_TOL``.  A prefill whose ragged last chunk decays the state
#: (its mask skipped) reads 1.0 on the SSM state, one whose conv state
#: drops its last input 1.7 on the conv inputs (PERF.md, §6).
SSM_BF16_TOL = 0.3
SSM_EARLY_LAYERS = 4
#: Mamba2-370M's first training loss and first gradient norm under
#: ``pallas`` (the tap kernels' bf16 instances: float32 sums rounded once
#: to bf16) vs ``auto`` (the library's bf16 grouped conv), relative.  On
#: the H100 the losses are equal and the norms 6.3e-5 apart; a forward
#: kernel that reads its taps reversed reads 4.8e-4 on the loss and
#: 8.7e-3 on the norm (PERF.md, §6).
LM_SSM_BF16_TOL = 1e-4
LM_SSM_GNORM_TOL = 1e-3
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
#: kernels (the three tap GEMMs, float32 and bf16 instances, the
#: depthwise forward, input grad and weight grad at 16 and 49 taps,
#: the four ``matmul`` tiles, the bf16
#: tensor-core flash attention: head dims 64, 128, 192 and 256, each with
#: and without 16-byte rows), whose registers, spills and shared memory
#: the build phase reports, and how many entries each has.
REDESIGNED = {"tap_gemm": (("3fwd6kernel", "2dw10fwd_kernel"), 12),
              "tap_gemm_phased": (("6phased6kernel", "2dw13phased_kernel"),
                                  28),
              "tap_wgrad": (("5wgrad6kernel", "2dw12wgrad_kernel"), 20),
              "matmul": (("4gemm6kernel", "4tall6kernel", "6mirror6kernel"),
                         22),
              "flash_attention": (("flash_bf16_kernel",), 8)}


def flash_bf16_smem(dm: int) -> int:
    """Dynamic shared memory of ``flash_bf16_kernel<DM>``: Q plus two stages
    of K and V, 64 rows each, of DM + 8 bf16 (csrc/flash_attention.cu);
    168,960 bytes at DM 256, one block an SM."""
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
    """Blocks an SM holds of every input-grad, weight-grad, depthwise and
    ``matmul`` instance, from the card's occupancy calculator, beside the
    ``per_sm`` the plans assume for its variant."""
    rows = []
    for bf16 in (False, True):
        for kernel, role, tiles in (("tap_gemm", "forward", tg.FORWARD_TILES),
                                    ("tap_gemm_phased", "input_grad",
                                     tg.PHASED_TILES),
                                    ("tap_wgrad", "weight_grad",
                                     tg.WGRAD_TILES)):
            for wide in (False, True):
                rows.append({
                    "kernel": kernel, "variant": tg.DW,
                    "in": "bfloat16" if bf16 else "float32",
                    "wide_taps": wide, "plan_per_sm": tiles[tg.DW].per_sm,
                    "blocks_per_sm": tg.dw_blocks_per_sm(role, wide, bf16)})
        for variant, tile in tg.PHASED_TILES.items():
            if variant == tg.DW:
                continue
            for vec_a in (False, True):
                for vec_b in (False, True):
                    rows.append({
                        "kernel": "tap_gemm_phased", "variant": variant,
                        "in": "bfloat16" if bf16 else "float32",
                        "vec_a": vec_a, "vec_b": vec_b,
                        "plan_per_sm": tile.per_sm,
                        "blocks_per_sm": tg.phased_blocks_per_sm(
                            variant, vec_a, vec_b, bf16)})
        for variant, tile in tg.WGRAD_TILES.items():
            if variant == tg.DW:
                continue
            for vec_a in (False, True):
                for vec_b in (False, True):
                    rows.append({
                        "kernel": "tap_wgrad", "variant": variant,
                        "in": "bfloat16" if bf16 else "float32",
                        "vec_a": vec_a, "vec_b": vec_b,
                        "plan_per_sm": tile.per_sm,
                        "blocks_per_sm": tg.wgrad_blocks_per_sm(
                            variant, vec_a, vec_b, bf16)})
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
    float32 instances (the bf16 ones, with half the shared memory, are
    reported)."""
    for kernel, variant in {(r["kernel"], r["variant"]) for r in rows}:
        mine = [r for r in rows if (r["kernel"], r["variant"], r["in"])
                == (kernel, variant, "float32")]
        check(min(r["blocks_per_sm"] for r in mine)
              == mine[0]["plan_per_sm"],
              f"{kernel} {variant}: the plan assumes "
              f"{mine[0]['plan_per_sm']} blocks per SM, the card holds "
              f"{[r['blocks_per_sm'] for r in mine]}")


def phase_kernels(smoke, torch, F, nn_grad, ops, tg, ref, shapes, dev,
                  dtype=None, phase: str = "kernels"):
    """Each kernel at each shape against its plain version, on operands of
    ``dtype`` (default float32; bf16 runs the bf16 instances, whose
    forward and input grad are held to ``BF16_TOL``: their outputs are
    rounded to bf16).  ``shapes`` holds ``(label, per-group ConvDims,
    groups, summed)``; the rows with ``summed`` make up the totals of the
    final ``kernels`` line."""
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    agg = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
               "bytes": 0.0, "max_abs_err": 0.0, "peak": peak}
           for k in TAP_KERNELS}
    for i, (layer, d, g, summed) in enumerate(shapes):
        gen = torch.Generator().manual_seed(i)
        x = torch.randn(d.B, d.C * g, d.H_i, d.W_i, generator=gen).to(dev,
                                                                      dtype)
        w = torch.randn(d.N * g, d.C, d.K_h, d.K_w, generator=gen).to(dev,
                                                                      dtype)
        dy = torch.randn(d.B, d.N * g, d.H_o, d.W_o, generator=gen).to(
            dev, dtype)
        stride, pad = (d.s_h, d.s_w), (d.P_h, d.P_w)
        xl = x                        # the library's input
        if (d.p_h_hi, d.p_w_hi) != pad:
            # asymmetric (Mamba2's causal) padding: padded ahead, as the
            # library takes only symmetric pads
            xl, pad = F.pad(x, (d.P_w, d.p_w_hi, d.P_h, d.p_h_hi)), (0, 0)
        macs = g * d.N * d.C          # per output pixel and tap

        # The plans the calls below launch with (the wrappers' analytic
        # plans: config.autotune is off here).
        plans = {role: ops.pass_plan(role, d, g, dev, dtype)
                 for role in ops.PLAN_ROLES}

        def grid_z(plan):                 # groups x splits, or 1 for dw
            return 1 if plan.variant == tg.DW else plan.splits * g

        src, wt, taps = ops.forward_operands(x, w, d, g)
        fwd = (lambda: tg.tap_gemm(src, wt, taps, d.H_o, d.W_o),
               lambda: ref.tap_gemm_ref(src, wt, taps, d.H_o, d.W_o),
               lambda: F.conv2d(xl, w, stride=stride, padding=pad, groups=g),
               2.0 * d.B * d.H_o * d.W_o * macs * len(taps),
               nbytes(src, wt), {"variant": plans["forward"].variant,
                                 "splits": plans["forward"].splits,
                                 "grid_z": grid_z(plans["forward"])})
        gsrc, ws, pp = ops.input_grad_operands(dy, w, d, g)
        counts = [len(t) for t in pp.phase_taps]
        n_taps = sum(counts)
        m_q = d.B * pp.n_qh * pp.n_qw
        dvariant, dsplits = plans["input_grad"].key
        if dvariant == tg.DW:         # threads on the grid's x, no partials
            dgrid_z, slots = 1, 0
        else:
            work, _, slots = tg.phased_work(counts, d.N, dsplits,
                                            tg.PHASED_TILES[dvariant].step)
            dgrid_z = len(work) * g
        dgrad = (lambda: tg.tap_gemm_phased(gsrc, ws, pp.phase_taps, pp.n_qh,
                                            pp.n_qw),
                 lambda: ref.tap_gemm_phased_ref(gsrc, ws, pp.phase_taps,
                                                 pp.n_qh, pp.n_qw),
                 lambda: nn_grad.conv2d_input(xl.shape, w, dy, stride=stride,
                                              padding=pad, groups=g),
                 2.0 * d.B * pp.n_qh * pp.n_qw * macs * n_taps,
                 # only the weight rows the taps read: the stacks of
                 # phases without taps are zeros the kernel never loads
                 nbytes(gsrc) + ws.element_size() * n_taps * macs,
                 {"active_phases": sum(1 for c in counts if c),
                  "variant": dvariant, "splits": dsplits,
                  "grid_z": dgrid_z,
                  "partial_mbytes": 4 * slots * g * m_q * d.C / 1e6,
                  "operands_ms": time_ms(torch, lambda:
                                         ops.input_grad_operands(dy, w, d,
                                                                 g))})
        wsrc, dyn, wtaps = ops.weight_grad_operands(x, dy, d, g)
        wplan = plans["weight_grad"]
        wgrad = (lambda: tg.tap_wgrad(wsrc, dyn, wtaps, d.H_o, d.W_o),
                 lambda: ref.tap_wgrad_ref(wsrc, dyn, wtaps, d.H_o, d.W_o),
                 lambda: nn_grad.conv2d_weight(xl, w.shape, dy, stride=stride,
                                               padding=pad, groups=g),
                 2.0 * d.B * d.H_o * d.W_o * macs * len(wtaps),
                 nbytes(wsrc, dyn), {"variant": wplan.variant,
                                     "splits": wplan.splits,
                                     "grid_z": grid_z(wplan)})

        for name, role, (kern, plain, lib, flops, in_bytes, extra) in zip(
                TAP_KERNELS, ("forward", "input_grad", "weight_grad"),
                (fwd, dgrad, wgrad)):
            tg.reset_launch_counts()
            got = kern()
            launches = tg.launch_counts()[name]
            variants = tg.variant_launch_counts()
            want = plain()
            torch.cuda.synchronize()
            err, abs_err = rel_err(torch, got, want)
            check(bool(torch.equal(got, kern())),
                  f"{name} differs run to run at {layer}")
            by = in_bytes + nbytes(got)
            b_s, b_by = bound(flops, by, peak)
            tol = (BF16_TOL if bf16 and name != "tap_wgrad" else
                   DW_F32_TOL if role == "input_grad"
                   and plans[role].variant == tg.DW else REL_TOL)
            rec = {"kernel": name, "layer": layer, "groups": g,
                   "dtype": str(dtype).split(".")[-1],
                   "out_dtype": str(got.dtype).split(".")[-1],
                   "max_rel_err": err, "max_abs_err": abs_err,
                   "tol": tol, "launches_per_call": launches,
                   "kernel_ms": time_ms(torch, kern),
                   "kernel_host_ms": host_ms(torch, kern),
                   "plain_ms": time_ms(torch, plain),
                   "library_ms": time_ms(torch, lib),
                   "bound_us": b_s * 1e6, "bound_by": b_by,
                   "gflop": flops / 1e9, "mbytes": by / 1e6, **extra}
            rec["roofline_share"] = rec["bound_us"] / 1e3 / rec["kernel_ms"]
            smoke.emit(phase, **rec)
            check(launches == 1, f"{name}: {launches} launches for one call")
            check(variants == {f"{name}:{plans[role].variant}": 1},
                  f"{name} at {layer}: launched {variants}, planned "
                  f"{plans[role]}")
            check(got.dtype == (torch.float32 if name == "tap_wgrad"
                                else dtype),
                  f"{name}: a {got.dtype} output from {dtype} operands")
            check(err <= tol, f"{name} at {layer} ({dtype}): relative error "
                              f"{err} > {tol}")
            if not summed:
                continue
            a = agg[name]
            a["variant"] = rec["variant"]
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
    from repro_torch.kernels import tap_gemm as tg
    paths = {}

    def run(path, fn):
        conv.reset_dispatch_events()
        kernels.reset_launch_counts()
        res = fn()
        paths[path] = kernels.launch_counts()
        return res, paths[path], conv.dispatch_events()

    res, counts, events = run("cnn_bp pallas", lambda: cnn_bp.main(
        ["--policy", "pallas", "--device", str(dev)]))      # accuracy floor
    variants = tg.variant_launch_counts()
    smoke.emit("train", model="cnn", policy="pallas",
               steps=len(res["losses"]), eval_acc=res["eval_acc"],
               seconds=res["seconds"], first_loss=res["losses"][0],
               last_loss=res["losses"][-1], launches=counts,
               variant_launches=variants, dispatch=events)
    check(res["eval_acc"] > 0.9, f"eval accuracy {res['eval_acc']} <= 0.9")
    check(all(counts[k] > 0 for k in TAP_KERNELS),
          f"a tap kernel was never launched on the main path: {counts}")
    # cnn.dw (16 groups of one channel) runs its three passes on the
    # depthwise variant.
    check(all(variants.get(f"{k}:dw", 0) > 0 for k in TAP_KERNELS),
          f"cnn.dw did not run the dw variant: {variants}")
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
#: moonshot-v1-16b-a3b prefill's (16 heads of 128), DeepSeek-V3 MLA's
#: (128 heads of 192: qk_nope 128 + qk_rope 64), recurrentgemma-9b's
#: (16 heads of 256 against one KV head) and hubert-xlarge's encoder's (4
#: clips of 1,000 frames, 16 heads of 80 on the D-128 instance, full
#: attention) follow the SmolLM cases.
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
       for dt in ("bfloat16", "float32")]
    + [(f"rg {shape} {dt[0]}{dt[-2:]}", 1, 16, 1, lq, lk, True, dt, 256)
       for shape, lq, lk, dts in (
           ("P1024", 1024, 1024, ("bfloat16", "float32")),
           ("ragged P1000", 1000, 1000, ("bfloat16",)),
           ("q256 k1024", 256, 1024, ("bfloat16",)))
       for dt in dts]
    + [(f"hubert P1000 full {dt[0]}{dt[-2:]}", 4, 16, 16, 1000, 1000, False,
        dt, 80) for dt in ("bfloat16", "float32")])
#: the cases of the ``kernels`` line's rows beside the first case's:
#: recurrentgemma-9b's prefill and hubert-xlarge's encoder.
FLASH_ROW_CASES = {"rg P1024 b16": "flash_attention_d256",
                   "hubert P1000 full b16": "flash_attention_bidir_d80"}


def attention_pairs(lq: int, lk: int, causal: bool) -> int:
    """(query, key) pairs the masks keep: row i sees keys j <= lk - lq + i
    under ``causal``."""
    if not causal:
        return lq * lk
    return sum(min(lk, lk - lq + i + 1) for i in range(lq))


def phase_flash(smoke, torch, F, fa, kref, dev):
    """``flash_attention`` against its plain version at ``FLASH_CASES``.
    Returns the records of the first case (SmolLM's serving shape) and of
    ``FLASH_ROW_CASES``, which make up the kernel's rows of the final
    ``kernels`` line (``flash_attention``, ``flash_attention_d256``,
    ``flash_attention_bidir_d80``)."""
    rows = {}
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
        name = "flash_attention" if i == 0 else FLASH_ROW_CASES.get(label)
        if name:
            rows[name] = {"ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
                          "library_ms": rec["library_ms"], "flops": flops,
                          "bytes": by, "max_abs_err": abs_err,
                          "peak": PEAK_BF16_FLOPS}
    return rows


#: SmolLM-360M through the launcher: the continuous engine on 1,024-token
#: prompts, the static engine (whose lockstep prefill is one decode step a
#: token, 75 ms each on the H100's host) on 128-token prompts, as
#: moonshot's; 1,024 took 158 s of the script's time (PERF.md, §6).
SERVE_ARGV = {
    "continuous": ["--full", "--requests", "8", "--prompt-len", "1024",
                   "--max-new", "32", "--max-batch", "4"],
    "static": ["--full", "--requests", "8", "--prompt-len", "128",
               "--max-new", "8", "--max-batch", "4"]}
#: the bf16 prefill-vs-scan check runs a quarter of SmolLM's 32 layers,
#: every width kept (its 1,024-step scan took 59 s at 32; 16 until the
#: dense, VLM and audio phases came); the device times and the launcher
#: run all 32.
SERVE_BF16_LAYERS = 8


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


def token_diffs(torch, M, cfg, params, runs_a, runs_b, dev) -> dict:
    """Two runs of the same requests (each sorted by rid): how many got
    identical greedy tokens, and for each that did not, the first
    differing step's top-2 logit margin under ``cfg``.  Every request of
    both runs must have ended ``ok``."""
    check(all(r.status == "ok" for r in (*runs_a, *runs_b)),
          f"{cfg.name}: a request did not end ok: "
          f"{[(r.rid, r.status) for r in (*runs_a, *runs_b)]}")
    diffs = []
    for a, b in zip(runs_a, runs_b):
        if a.out != b.out:
            step = next(i for i, (x, y) in enumerate(zip(a.out, b.out))
                        if x != y)
            diffs.append({"rid": a.rid, "step": step, "margin": margin_at(
                torch, M, cfg, params, a, step, dev)})
    return {"identical": sum(a.out == b.out for a, b in zip(runs_a, runs_b)),
            "requests": len(runs_a), "differing": diffs,
            "margin_tol": MARGIN_TOL}


def engines_agree(torch, serve, M, cfg, params, prompt_len, max_new, dev):
    """8 requests through both engines (static in one wave of 8, continuous
    on 4 lanes): ``token_diffs`` of the two."""
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
    return token_diffs(torch, M, cfg, params, runs["static"],
                       runs["continuous"], dev)


def device_time(torch, fn, reps: int = 3, top: int = 6) -> dict:
    """Host wall time of ``fn`` (median of ``reps`` runs, each ended by a
    synchronize) against the device time its kernels take, from one run
    under ``torch.profiler`` (kernels summed by name, the ``top`` longest
    listed; the busy share is device time over the unprofiled wall
    time)."""
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
    top = sorted(dev, key=lambda e: -e.device_time_total)[:top]
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
    for cfg, tol in ((dataclasses.replace(full, n_layers=SERVE_BF16_LAYERS),
                      SERVE_BF16_TOL), (cfg32, SERVE_F32_TOL)):
        params, info = init_timed(torch, serve, M, cfg, dev)
        prefill_check(smoke, "serve", torch, M, T, cfg, params, prompt, dev,
                      tol, check="prefill vs decode scan", **info)
        del params
        free_card(torch)
    # Where a request's time goes: one prefill of the prompt, and one
    # decode step of a full batch of 4 lanes past it.
    params = serve.init_params(full, 0, dev)
    toks = torch.as_tensor([prompt], device=dev)
    cache = T.init_cache(full, 4, len(prompt) + 34, dev)
    nxt = toks[0, :4].clone()
    pos = torch.full((4,), len(prompt), device=dev)
    smoke.emit("serve", check="device time", dtype=full.param_dtype,
               prefill=device_time(torch, lambda: M.prefill(
                   params, toks, full, len(prompt) + 34)),
               decode_step_batch4=device_time(
                   torch, lambda: M.decode_step(params, cache, nxt, pos,
                                                full)))
    del params, cache
    free_card(torch)

    paths = serve_engines(smoke, "serve", torch, kernels, serve, full,
                          SERVE_ARGV, dev)
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
                  dev, per_request: dict | None = None,
                  label: str | None = None,
                  variants: dict | None = None) -> dict:
    """``launch.serve.main(argv + ["--engine", engine])`` for each engine
    of ``argvs`` (``--requests`` each): every request ``ok`` with
    ``--max-new`` tokens; the continuous engine admits all and launches
    each kernel of ``per_request`` that many times per request (default:
    ``flash_attention`` once a layer, in its one-pass prefill), and no
    other kernel (a tap kernel's launches per request by variant:
    ``variants``), the static engine (lockstep prefill through the decode
    path) never; tokens/s, p50 latency, peak memory.  Returns each
    engine's launches as ``"{label} {engine}"`` (label: the phase)."""
    from repro_torch.kernels import tap_gemm as tg
    paths = {}
    label = label or phase
    per_request = ({"flash_attention": cfg.n_layers} if per_request is None
                   else per_request)
    for engine, argv in argvs.items():
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        res = serve.main(argv + ["--engine", engine])
        counts = paths[f"{label} {engine}"] = kernels.launch_counts()
        got_variants = tg.variant_launch_counts()
        s, reqs = res["summary"], res["requests"]
        max_new = int(argv[argv.index("--max-new") + 1])
        n_req = int(argv[argv.index("--requests") + 1])
        smoke.emit(phase, engine=engine, config=cfg.name, path=label,
                   dtype=cfg.param_dtype, layers=cfg.n_layers,
                   requests=len(reqs),
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
                       dev), launches=counts, variant_launches=got_variants,
                   summary=s)
        check(len(reqs) == n_req and all(r.status == "ok"
                                         and len(r.out) == max_new
                                         for r in reqs),
              f"{cfg.name} {engine}: "
              f"{[(r.status, len(r.out)) for r in reqs]}")
        n = s["admitted"] if engine == "continuous" else 0
        want = {k: per_request.get(k, 0) * n for k in counts}
        want_variants = {k: v * n for k, v in (variants or {}).items()
                         if v * n}
        check(counts == want
              and (engine == "static" or s["admitted"] == n_req)
              and (variants is None or got_variants == want_variants),
              f"{cfg.name} {label} {engine}: {counts} launches "
              f"({got_variants}), want {want} ({want_variants}), "
              f"{s['admitted']} admitted")
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
#: moonshot's bf16 prefill-vs-scan check runs its first 8 of 48 layers
#: (the dense one and 7 MoE layers), every width kept: the 512-step scan
#: of all 48 took 152 s on the H100's host (16 layers until the dense,
#: VLM and audio phases came); the device times and the launcher run all
#: 48.
MOE_SCAN_LAYERS = 8
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
    import dataclasses
    full = serve.get_config("moonshot-v1-16b-a3b")
    cut = dataclasses.replace(full, n_layers=MOE_SCAN_LAYERS)
    params, info = init_timed(torch, serve, M, cut, dev)
    prefill_check(smoke, "serve_moe", torch, M, T, cut, params,
                  prompt_for(cut, MOE_PROMPT), dev, MOE_BF16_TOL,
                  SERVE_BF16_TOL, check="prefill vs decode scan", **info)
    del params
    free_card(torch)
    params, info = init_timed(torch, serve, M, full, dev)
    smoke.emit("serve_moe", check="init", config=full.name,
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


def engine_run(smoke, phase, torch, kernels, serve, cfg, params,
               prompt_len: int, dev, max_new: int = 16) -> dict:
    """The continuous engine built directly (a depth cut the launcher has
    not) on 4 requests of ``prompt_len`` tokens, ``max_new`` new, 4 lanes:
    every request ``ok`` with its tokens and the flash kernel launched
    once a layer a request; tokens/s and peak memory.  Returns the
    launches."""
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = serve.ENGINES["continuous"](cfg, params, max_batch=4,
                                      max_len=prompt_len + max_new + 2)
    for rid in range(4):
        eng.submit(serve.Request(rid=rid, prompt=prompt_for(
            cfg, prompt_len, seed=10 + rid), max_new=max_new))
    t0 = time.perf_counter()
    reqs = eng.run()
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    s = eng.run_summary()
    smoke.emit(phase, engine="continuous", config=cfg.name,
               layers=cfg.n_layers, dtype=cfg.param_dtype,
               requests=len(reqs), prompt_len=prompt_len,
               status=sorted({r.status for r in reqs}),
               tokens=[len(r.out) for r in reqs], admitted=s["admitted"],
               decode_steps=s["decode_steps"],
               prefill_s_per_request=s["prefill_s"] / len(reqs),
               decode_ms_per_step=1e3 * s["decode_s"]
               / max(s["decode_steps"], 1),
               tok_s=sum(len(r.out) for r in reqs) / secs, seconds=secs,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(
                   dev), launches=counts)
    check(len(reqs) == 4 and all(r.status == "ok" and len(r.out) == max_new
                                 for r in reqs),
          f"{cfg.name} continuous: "
          f"{[(r.status, len(r.out)) for r in reqs]}")
    check(counts["flash_attention"] == cfg.n_layers * 4
          and s["admitted"] == 4,
          f"{cfg.name} continuous: {counts['flash_attention']} flash "
          f"launches, {s['admitted']} admitted")
    return counts


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
    counts = engine_run(smoke, "serve_moe", torch, kernels, serve, cfg,
                        params, MOE_PROMPT, dev)
    del params
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


#: Mamba2-370M (``configs/mamba2_370m.py``): the prefill-vs-scan prompt (not
#: a multiple of the SSD chunk, 128: its last chunk is ragged), and the
#: float32 checks' depth (every width kept).
MAMBA2_PROMPT = 500
SSM_F32_LAYERS = 4
#: the launcher under each conv policy: the continuous engine on 1,024-token
#: prompts (one ``tap_gemm`` launch a layer in each prefill under
#: ``pallas``), the static engine (lockstep prefill through the decode
#: path, which has no conv launch) on 128-token prompts.
SERVE_SSM_ARGV = {
    "continuous": ["--full", "--arch", "mamba2-370m", "--requests", "8",
                   "--prompt-len", "1024", "--max-new", "32",
                   "--max-batch", "4"],
    "static": ["--full", "--arch", "mamba2-370m", "--requests", "8",
               "--prompt-len", "128", "--max-new", "8", "--max-batch", "4"]}


def mamba2_conv_dims(ConvDims, batch: int, length: int):
    """Per-group dims of Mamba2-370M's depthwise causal conv: one channel a
    group, 4 taps on an H = 1 plane, left pad 3 (2,304 groups)."""
    return ConvDims(B=batch, C=1, H_i=1, W_i=length, N=1, K_h=1, K_w=4, S=1,
                    P_h=0, P_w=3, P_h_hi=0, P_w_hi=0)


def kernel_bf16_shapes(ConvDims, paper_cnn):
    """The bf16 instances' shapes: Mamba2-370M's conv at its training shape
    (batch 8 x seq 512, 2,304 groups; the row the ``kernels`` line sums)
    and at a 1,024-token prefill, and Table II layer 4 (C = N = 244, the
    vector copies) cast to bf16."""
    return [("mamba2 train 8x512 g2304", mamba2_conv_dims(ConvDims, 8, 512),
             2304, True),
            ("mamba2 prefill 1x1024 g2304",
             mamba2_conv_dims(ConvDims, 1, 1024), 2304, False),
            ("table2 28/244/244/3/2/1 bf16",
             paper_cnn.dims(paper_cnn.TABLE2_LAYERS[3]), 1, False)]


def rg_conv_shapes(ConvDims):
    """recurrentgemma-9b's temporal conv (``rglru_width`` = 4,096 groups of
    one channel, 4 taps, causal; the geometry of Mamba2's): its training
    shape in lm_train_hybrid (batch 4 x seq 512, the row the ``kernels``
    line sums) and a 1,024-token prefill."""
    return [("rg train 4x512 g4096", mamba2_conv_dims(ConvDims, 4, 512),
             4096, True),
            ("rg prefill 1x1024 g4096", mamba2_conv_dims(ConvDims, 1, 1024),
             4096, False)]


def dw_conv_times(smoke, torch, conv, tg, dev) -> None:
    """Mamba2-370M's conv as its layers call it at the training shape:
    ``depthwise_causal_conv1d`` on a (8, 512, 2,304) bf16 input, forward
    and backward, under ``pallas`` (the dw forward, input grad and weight
    grad, beside the lowering's transposes, pads and channels-last copies)
    and under ``lax`` (the library's grouped conv):
    device time by kernel (``device_time``) and the variants launched."""
    gen = torch.Generator().manual_seed(500)
    x0 = torch.randn(8, 512, 2304, generator=gen).to(dev, torch.bfloat16)
    w0 = (0.2 * torch.randn(4, 2304, generator=gen)).to(dev, torch.bfloat16)
    dy = torch.randn(8, 512, 2304, generator=gen).to(dev, torch.bfloat16)
    want = {"pallas": {"tap_gemm:dw": 1, "tap_gemm_phased:dw": 1,
                       "tap_wgrad:dw": 1}, "lax": {}}
    for policy in ("pallas", "lax"):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)

        def step():
            x.grad = w.grad = None
            conv.depthwise_causal_conv1d(x, w, policy).backward(dy)

        tg.reset_launch_counts()
        step()
        variants = tg.variant_launch_counts()
        smoke.emit("kernels_bf16", check="depthwise_causal_conv1d forward "
                   "+ backward", shape=[8, 512, 2304], policy=policy,
                   variant_launches=variants,
                   **device_time(torch, step, top=12))
        check(variants == want[policy],
              f"depthwise_causal_conv1d under {policy} launched {variants}")


def ssm_prefill_vs_scan(torch, M, T, tg, cfg, params, prompt, dev) -> dict:
    """Mamba2's one-pass prefill against a scan of decode steps on one
    prompt: relative errors (max |a - b| / max |b|) of the last logits and
    of each layer's cache (its SSM state and its last conv inputs), the tap
    kernels' launches (by operand type) of each side, and their wall
    times."""
    toks = torch.as_tensor([prompt], device=dev)
    tg.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = M.prefill(params, toks, cfg, len(prompt) + 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = tg.type_launch_counts()
    pre_variants = tg.variant_launch_counts()
    tg.reset_launch_counts()
    scan = T.init_cache(cfg, 1, len(prompt) + 1, dev)
    t0 = time.perf_counter()
    for t in range(len(prompt)):
        want, scan = M.decode_step(params, scan, toks[:, t], t, cfg)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    by_layer = {key: [rel_err(torch, c[i], scan["blocks"][key][i])[0]
                      for i in range(cfg.n_layers)]
                for key, c in cache["blocks"].items()}
    return {"rel_err_logits": rel_err(torch, logits, want)[0],
            "rel_err_ssm_max": max(by_layer["ssm"]),
            "rel_err_conv_max": max(by_layer["conv"]),
            "rel_err_ssm_by_layer": by_layer["ssm"],
            "rel_err_conv_by_layer": by_layer["conv"],
            "prefill_launches": pre,
            "prefill_variant_launches": pre_variants,
            "scan_launches": tg.type_launch_counts(),
            "prefill_seconds": prefill_s, "scan_seconds": scan_s}


def ssm_prefill_check(smoke, torch, M, T, tg, cfg, params, prompt, dev, tol,
                      early_tol=None, **fields) -> dict:
    """``ssm_prefill_vs_scan``, emitted with ``fields``: under ``pallas``
    one ``tap_gemm`` launch a layer in the prefill (of the operands' type,
    on the depthwise variant), none otherwise and none in the scan; errors
    within ``tol`` and, where given, those of the first
    ``SSM_EARLY_LAYERS`` layers within ``early_tol``."""
    rec = ssm_prefill_vs_scan(torch, M, T, tg, cfg, params, prompt, dev)
    early = max(rec["rel_err_ssm_by_layer"][:SSM_EARLY_LAYERS]
                + rec["rel_err_conv_by_layer"][:SSM_EARLY_LAYERS])
    rec.update(config=cfg.name, dtype=cfg.param_dtype, layers=cfg.n_layers,
               conv_policy=cfg.conv_policy, prompt_len=len(prompt), tol=tol,
               early_tol=early_tol, rel_err_early_max=early, **fields)
    smoke.emit("serve_ssm", **rec)
    kind = "bf16" if cfg.param_dtype == "bfloat16" else "f32"
    pallas = cfg.conv_policy == "pallas"
    want = {f"tap_gemm:{kind}": cfg.n_layers} if pallas else {}
    want_variants = {"tap_gemm:dw": cfg.n_layers} if pallas else {}
    check(rec["prefill_launches"] == want and not rec["scan_launches"]
          and rec["prefill_variant_launches"] == want_variants,
          f"{cfg.name} {cfg.conv_policy}: prefill launched "
          f"{rec['prefill_launches']} ({rec['prefill_variant_launches']}), "
          f"the scan {rec['scan_launches']}")
    worst = max(rec["rel_err_logits"], rec["rel_err_ssm_max"],
                rec["rel_err_conv_max"])
    check(worst <= tol and (early_tol is None or early <= early_tol),
          f"{cfg.name} {cfg.param_dtype} prefill vs decode scan: {worst} "
          f"(tol {tol}), first layers {early} (tol {early_tol})")
    return rec


def ssm_policies_agree(torch, serve, M, cfg, params, prompt_len, max_new,
                       dev) -> dict:
    """8 requests through the continuous engine under ``pallas`` and under
    ``auto``: ``token_diffs`` of the two."""
    import dataclasses
    runs = {}
    for policy in ("pallas", "auto"):
        eng = serve.ENGINES["continuous"](cfg, params, max_batch=4,
                                          max_len=prompt_len + max_new + 2,
                                          conv_policy=policy)
        for rid in range(8):
            eng.submit(serve.Request(rid=rid, prompt=prompt_for(
                cfg, prompt_len, seed=20 + rid), max_new=max_new))
        runs[policy] = sorted(eng.run(), key=lambda r: r.rid)
    return token_diffs(torch, M, dataclasses.replace(cfg, conv_policy="auto"),
                       params, runs["pallas"], runs["auto"], dev)


def phase_serve_ssm(smoke, torch, kernels, tg, serve, M, T, dev) -> dict:
    """Mamba2-370M at full width: prefill vs the decode scan in bf16 (48
    layers) and float32 (``SSM_F32_LAYERS``), device times of a prefill and
    a decode step, greedy tokens under ``pallas`` and ``auto`` (float32),
    and both engines through the launcher under both policies.  Returns
    each engine's kernel launches."""
    import dataclasses
    full = dataclasses.replace(serve.get_config("mamba2-370m"),
                               conv_policy="pallas")
    params, info = init_timed(torch, serve, M, full, dev)
    check(info["n_params"] == 368_227_840,
          f"mamba2-370m: {info['n_params']} parameters")
    ssm_prefill_check(smoke, torch, M, T, tg, full, params,
                      prompt_for(full, MAMBA2_PROMPT), dev, SSM_BF16_TOL,
                      SERVE_BF16_TOL, check="prefill vs decode scan", **info)
    toks = torch.as_tensor([prompt_for(full, 1024, seed=1)], device=dev)
    cache = T.init_cache(full, 4, 1024 + 34, dev)
    nxt = toks[0, :4].clone()
    pos = torch.full((4,), 1024, device=dev)
    tg.reset_launch_counts()
    step = device_time(torch, lambda: M.decode_step(params, cache, nxt, pos,
                                                    full))
    decode_launches = tg.type_launch_counts()
    smoke.emit("serve_ssm", check="device time", config=full.name,
               dtype=full.param_dtype, conv_policy=full.conv_policy,
               prefill_1024=device_time(torch, lambda: M.prefill(
                   params, toks, full, 1024 + 34)),
               decode_step_batch4=step, decode_launches=decode_launches)
    check(not decode_launches, f"decode launched {decode_launches}")
    del params, cache
    free_card(torch)

    cfg32 = dataclasses.replace(full, param_dtype="float32",
                                act_dtype="float32", n_layers=SSM_F32_LAYERS)
    params, info = init_timed(torch, serve, M, cfg32, dev)
    ssm_prefill_check(smoke, torch, M, T, tg, cfg32, params,
                      prompt_for(cfg32, MAMBA2_PROMPT), dev, SERVE_F32_TOL,
                      check="prefill vs decode scan", **info)
    rec = ssm_policies_agree(torch, serve, M, cfg32, params, 256, 16, dev)
    smoke.emit("serve_ssm", check="float32 greedy tokens, pallas vs auto",
               config=cfg32.name, layers=cfg32.n_layers, **rec)
    check(all(d["margin"] < MARGIN_TOL for d in rec["differing"]),
          f"float32 mamba2 policies disagree beyond a near-tie: "
          f"{rec['differing']}")
    del params
    free_card(torch)

    paths = {}
    for policy in ("pallas", "auto"):
        n = full.n_layers if policy == "pallas" else 0
        paths.update(serve_engines(
            smoke, "serve_ssm", torch, kernels, serve, full,
            {e: a + ["--conv-policy", policy]
             for e, a in SERVE_SSM_ARGV.items()}, dev,
            per_request={"tap_gemm": n}, label=f"serve_ssm {policy}",
            variants={f"tap_gemm:{tg.DW}": n}))
    return paths


#: recurrentgemma-9b (``configs/recurrentgemma_9b.py``) through the
#: launcher under ``--conv-policy pallas``, as the other families: the
#: continuous engine on 1,024-token prompts (inside the 2,048-token window:
#: each prefill runs ``tap_gemm`` once in each of the 26 RG-LRU layers and
#: the flash kernel once in each of the 12 attention layers), the static
#: engine on 128-token prompts.
SERVE_HYBRID_ARGV = {
    "continuous": ["--full", "--arch", "recurrentgemma-9b", "--requests",
                   "8", "--prompt-len", "1024", "--max-new", "32",
                   "--max-batch", "4", "--conv-policy", "pallas"],
    "static": ["--full", "--arch", "recurrentgemma-9b", "--requests", "8",
               "--prompt-len", "128", "--max-new", "8", "--max-batch", "4",
               "--conv-policy", "pallas"]}
#: the prefill-vs-scan checks' depth: one (rec, rec, attn) super-block and
#: the two extra RG-LRU layers (the remainder full depth has), every width
#: kept; the launcher and the device times run all 38 layers.
HYBRID_SCAN_LAYERS = 5
#: their prompts: 1,000 tokens fit the 2,048-token window (the prefill's
#: attention runs the flash kernel at head dim 256); 2,100 pass it (the
#: blockwise path with the window mask; the decode steps run the dense
#: masked path).
HYBRID_PROMPTS = (1000, 2100)
#: the float32 checks' depth (one super-block and one extra RG-LRU layer).
HYBRID_F32_LAYERS = 4
#: recurrentgemma-9b's bf16 prefill vs its decode scan, as max |a - b| /
#: max |b| over the last logits and every cache leaf of every layer: the
#: bf16 roundings of the other families' checks (kernel attention and the
#: conv's float32 sums against bf16 einsums), at 5 layers.
HYBRID_BF16_TOL = SERVE_BF16_TOL


def flat(tree, prefix: str = "") -> dict:
    """``{"super/rec1/h": leaf, ...}`` of a nested dict."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = val
    return out


def hybrid_layers(cfg) -> tuple[int, int]:
    """(RG-LRU layers, attention layers) of a hybrid config: a super-block
    holds two and one, the remainder is RG-LRU."""
    n_super = cfg.n_layers // len(cfg.layer_pattern)
    return cfg.n_layers - n_super, n_super


def hybrid_prefill_check(smoke, torch, M, T, kernels, tg, cfg, params,
                         prompt, dev, tol, **fields) -> dict:
    """The hybrid one-pass prefill against a scan of decode steps on one
    prompt: relative errors of the last logits and of each cache leaf per
    layer (``super/rec1/h`` ...); the prefill launches ``tap_gemm`` (on
    ``dw``) once an RG-LRU layer under ``pallas`` and the flash kernel once
    an attention layer when the prompt fits the window, the scan
    nothing."""
    toks = torch.as_tensor([prompt], device=dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = M.prefill(params, toks, cfg, len(prompt) + 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = {k: v for k, v in kernels.launch_counts().items() if v}
    pre_variants = tg.variant_launch_counts()
    kernels.reset_launch_counts()
    scan = T.init_cache(cfg, 1, len(prompt) + 1, dev)
    t0 = time.perf_counter()
    for t in range(len(prompt)):
        want, scan = M.decode_step(params, scan, toks[:, t], t, cfg)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    scan_launches = {k: v for k, v in kernels.launch_counts().items() if v}
    theirs = flat(scan)
    by_leaf = {key: [rel_err(torch, leaf[i], theirs[key][i])[0]
                     for i in range(leaf.shape[0])]
               for key, leaf in flat(cache).items()}
    rec = {"rel_err_logits": rel_err(torch, logits, want)[0],
           "rel_err_cache_max": max(max(v) for v in by_leaf.values()),
           "rel_err_by_leaf": by_leaf, "prefill_launches": pre,
           "prefill_variant_launches": pre_variants,
           "scan_launches": scan_launches, "prefill_seconds": prefill_s,
           "scan_seconds": scan_s}
    n_rec, n_attn = hybrid_layers(cfg)
    pallas = cfg.conv_policy == "pallas"
    flash = len(prompt) <= cfg.local_window
    want_launches = {k: v for k, v in (("tap_gemm", n_rec * pallas),
                                       ("flash_attention", n_attn * flash))
                     if v}
    rec.update(config=cfg.name, dtype=cfg.param_dtype, layers=cfg.n_layers,
               conv_policy=cfg.conv_policy, prompt_len=len(prompt),
               window=cfg.local_window, tol=tol,
               want_prefill_launches=want_launches, **fields)
    smoke.emit("serve_hybrid", **rec)
    check(pre == want_launches and not scan_launches
          and pre_variants == ({f"tap_gemm:{tg.DW}": n_rec} if pallas
                               else {}),
          f"{cfg.name} {len(prompt)} tokens: prefill launched {pre} "
          f"({pre_variants}), want {want_launches}; the scan "
          f"{scan_launches}")
    check(max(rec["rel_err_logits"], rec["rel_err_cache_max"]) <= tol,
          f"{cfg.name} {cfg.param_dtype} prefill vs decode scan at "
          f"{len(prompt)} tokens: logits {rec['rel_err_logits']}, cache "
          f"{rec['rel_err_cache_max']} (tol {tol})")
    return rec


def phase_serve_hybrid(smoke, torch, kernels, tg, serve, M, T, dev) -> dict:
    """recurrentgemma-9b at its published widths under ``pallas``:
    prefill vs the decode scan at ``HYBRID_SCAN_LAYERS`` layers on
    ``HYBRID_PROMPTS`` (bf16), the 38-layer model's init, the launches and
    device time of a 1,024-token prefill and a 4-lane decode step, both
    engines through the launcher, and in float32 at ``HYBRID_F32_LAYERS``
    layers prefill vs scan on the longer prompt and the greedy tokens of
    the two engines and of ``pallas`` against ``auto``.  Returns each
    engine's kernel launches."""
    import dataclasses
    full = dataclasses.replace(serve.get_config("recurrentgemma-9b"),
                               conv_policy="pallas")
    n_rec, n_attn = hybrid_layers(full)
    cut = dataclasses.replace(full, n_layers=HYBRID_SCAN_LAYERS)
    params, info = init_timed(torch, serve, M, cut, dev)
    for plen in HYBRID_PROMPTS:
        hybrid_prefill_check(smoke, torch, M, T, kernels, tg, cut, params,
                             prompt_for(cut, plen), dev, HYBRID_BF16_TOL,
                             check="prefill vs decode scan", **info)
    del params
    free_card(torch)

    params, info = init_timed(torch, serve, M, full, dev)
    check(info["n_params"] == 10_444_664_832,
          f"recurrentgemma-9b: {info['n_params']} parameters")
    smoke.emit("serve_hybrid", check="init", config=full.name,
               memory_allocated_bytes=torch.cuda.memory_allocated(dev),
               **info)
    toks = torch.as_tensor([prompt_for(full, 1024, seed=1)], device=dev)
    cache = T.init_cache(full, 4, 1024 + 34, dev)
    nxt = toks[0, :4].clone()
    pos = torch.full((4,), 1024, device=dev)
    kernels.reset_launch_counts()
    M.prefill(params, toks, full, 1024 + 34)
    pre = kernels.launch_counts()
    pre_variants = tg.variant_launch_counts()
    prefill = device_time(torch, lambda: M.prefill(params, toks, full,
                                                   1024 + 34), top=10)
    kernels.reset_launch_counts()
    step = device_time(torch, lambda: M.decode_step(params, cache, nxt, pos,
                                                    full), top=10)
    decode_launches = {k: v for k, v in kernels.launch_counts().items() if v}
    smoke.emit("serve_hybrid", check="device time", config=full.name,
               dtype=full.param_dtype, conv_policy=full.conv_policy,
               prefill_1024=prefill, prefill_launches=pre,
               prefill_variant_launches=pre_variants,
               decode_step_batch4=step, decode_launches=decode_launches)
    check(pre["tap_gemm"] == n_rec and pre["flash_attention"] == n_attn
          and sum(pre.values()) == n_rec + n_attn
          and pre_variants == {f"tap_gemm:{tg.DW}": n_rec},
          f"a 1,024-token prefill launched {pre} ({pre_variants})")
    check(not decode_launches, f"decode launched {decode_launches}")
    del params, cache
    free_card(torch)

    paths = serve_engines(smoke, "serve_hybrid", torch, kernels, serve, full,
                          SERVE_HYBRID_ARGV, dev,
                          per_request={"tap_gemm": n_rec,
                                       "flash_attention": n_attn},
                          variants={f"tap_gemm:{tg.DW}": n_rec})

    cfg32 = dataclasses.replace(full, param_dtype="float32",
                                act_dtype="float32",
                                n_layers=HYBRID_F32_LAYERS)
    params, info = init_timed(torch, serve, M, cfg32, dev)
    hybrid_prefill_check(smoke, torch, M, T, kernels, tg, cfg32, params,
                         prompt_for(cfg32, HYBRID_PROMPTS[-1]), dev,
                         SERVE_F32_TOL, check="prefill vs decode scan",
                         **info)
    for label, rec in (
            ("static vs continuous",
             engines_agree(torch, serve, M, cfg32, params, 256, 16, dev)),
            ("pallas vs auto",
             ssm_policies_agree(torch, serve, M, cfg32, params, 256, 16,
                                dev))):
        smoke.emit("serve_hybrid", check=f"float32 greedy tokens, {label}",
                   config=cfg32.name, layers=cfg32.n_layers, **rec)
        check(all(d["margin"] < MARGIN_TOL for d in rec["differing"]),
              f"float32 recurrentgemma {label} disagree beyond a near-tie: "
              f"{rec['differing']}")
    del params
    free_card(torch)
    return paths


#: the dense configs served at full width, with their parameter counts
#: (the JAX package's ``init_params`` under ``jax.eval_shape``).
DENSE_PARAMS = {"granite-3-8b": 8_170_848_256, "minicpm-2b": 2_724_880_896,
                "phi4-mini-3.8b": 4_450_618_368}
#: the prefill-vs-scan checks of the dense configs and the VLM's text, and
#: the audio encoder's float32 forward: the first layers, every width
#: kept; the prompt of the prefill-vs-scan checks.
DENSE_SCAN_LAYERS = 4
DENSE_PROMPT = 256


def dense_argv(arch: str) -> dict:
    """The continuous engine through the launcher: 4 requests of 1,024
    tokens, 16 new, on 4 lanes."""
    return {"continuous": ["--full", "--arch", arch, "--requests", "4",
                           "--prompt-len", "1024", "--max-new", "16",
                           "--max-batch", "4"]}


def prefill_and_step_times(smoke, phase, torch, M, T, cfg, params, dev):
    """Device time of one 1,024-token prefill and of one decode step of 4
    lanes past it, emitted under ``phase``."""
    toks = torch.as_tensor([prompt_for(cfg, 1024, seed=1)], device=dev)
    cache = T.init_cache(cfg, 4, 1024 + 34, dev)
    nxt = toks[0, :4].clone()
    pos = torch.full((4,), 1024, device=dev)
    smoke.emit(phase, check="device time", config=cfg.name,
               layers=cfg.n_layers, dtype=cfg.param_dtype,
               prefill_1024=device_time(torch, lambda: M.prefill(
                   params, toks, cfg, 1024 + 34)),
               decode_step_batch4=device_time(
                   torch, lambda: M.decode_step(params, cache, nxt, pos,
                                                cfg)))


def phase_serve_dense(smoke, torch, kernels, serve, M, T, dev) -> dict:
    """granite-3-8b, minicpm-2b and phi4-mini-3.8b at their published
    widths: prefill vs the decode scan at ``DENSE_SCAN_LAYERS`` layers in
    bf16 and float32, the full model's init (its parameter count held to
    ``DENSE_PARAMS``), the device time of a prefill and a decode step, and
    the continuous engine through the launcher.  Returns each config's
    launches."""
    import dataclasses
    paths = {}
    for arch, n_params in DENSE_PARAMS.items():
        full = serve.get_config(arch)
        cut = dataclasses.replace(full, n_layers=DENSE_SCAN_LAYERS)
        for cfg, tol in ((cut, SERVE_BF16_TOL), (dataclasses.replace(
                cut, param_dtype="float32", act_dtype="float32"),
                SERVE_F32_TOL)):
            params, info = init_timed(torch, serve, M, cfg, dev)
            prefill_check(smoke, "serve_dense", torch, M, T, cfg, params,
                          prompt_for(cfg, DENSE_PROMPT), dev, tol,
                          check="prefill vs decode scan", **info)
            del params
            free_card(torch)
        params, info = init_timed(torch, serve, M, full, dev)
        smoke.emit("serve_dense", check="init", config=full.name,
                   memory_allocated_bytes=torch.cuda.memory_allocated(dev),
                   **info)
        check(info["n_params"] == n_params,
              f"{arch}: {info['n_params']} parameters, want {n_params}")
        prefill_and_step_times(smoke, "serve_dense", torch, M, T, full,
                               params, dev)
        del params
        free_card(torch)
        paths.update(serve_engines(smoke, "serve_dense", torch, kernels,
                                   serve, full, dense_argv(arch), dev,
                                   label=f"serve_dense {arch}"))
    return paths


#: internvl2-76b at its published widths cut to its first 8 of 80 layers
#: (8,972,804,096 parameters, 17.9 GB in bf16; the 80 layers' 141 GB fit
#: no card), as DeepSeek-V3 is cut; 256 image embeddings (its
#: ``frontend_tokens``) ahead of 768 text tokens.
VLM_LAYERS = 8
VLM_PARAMS = 8_972_804_096
VLM_TEXT = 768


def phase_serve_vlm(smoke, torch, kernels, serve, M, T, dev) -> dict:
    """internvl2-76b at ``VLM_LAYERS`` layers in bf16: a no-grad forward on
    image embeddings and text (one flash launch a layer, logits over the
    text only) against the grad-mode forward (dense attention), the
    continuous engine on text prompts (built directly: the launcher has
    no depth cut, nor has the JAX one), and prefill vs scan at
    ``DENSE_SCAN_LAYERS`` layers on text.  Returns the engine's
    launches."""
    import dataclasses
    full = serve.get_config("internvl2-76b")
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    params, info = init_timed(torch, serve, M, cfg, dev)
    check(info["n_params"] == VLM_PARAMS,
          f"internvl2-76b at {VLM_LAYERS} layers: {info['n_params']} "
          f"parameters, want {VLM_PARAMS}")
    gen = torch.Generator(device=dev).manual_seed(500)
    image = torch.randn(1, cfg.frontend_tokens, cfg.d_frontend, device=dev,
                        generator=gen)
    batch = {"tokens": torch.as_tensor([prompt_for(cfg, VLM_TEXT)],
                                       device=dev), "frontend": image}
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = M.forward(params, batch, cfg)[0]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["flash_attention"]
    with torch.no_grad():
        fwd = device_time(torch, lambda: M.forward(params, batch, cfg))
    kernels.reset_launch_counts()
    want = M.forward(params, dict(batch, frontend=image.clone()
                                  .requires_grad_(True)), cfg)[0].detach()
    dense_launches = kernels.launch_counts()["flash_attention"]
    err = rel_err(torch, got, want)[0]
    smoke.emit("serve_vlm", check="forward, flash vs dense", config=cfg.name,
               layers=cfg.n_layers, dtype=cfg.param_dtype,
               image_tokens=cfg.frontend_tokens, text_tokens=VLM_TEXT,
               logits_shape=list(got.shape), flash_launches=launches,
               dense_launches=dense_launches, rel_err_logits=err,
               tol=SERVE_BF16_TOL, forward=fwd, **info)
    check(tuple(got.shape) == (1, VLM_TEXT, cfg.vocab),
          f"VLM logits {tuple(got.shape)}")
    check(launches == cfg.n_layers and dense_launches == 0,
          f"VLM forward: {launches} flash launches, grad mode "
          f"{dense_launches}")
    check(err <= SERVE_BF16_TOL, f"VLM forward flash vs dense: {err}")
    del got, want

    counts = engine_run(smoke, "serve_vlm", torch, kernels, serve, cfg,
                        params, 1024, dev)
    del params
    free_card(torch)

    cut = dataclasses.replace(full, n_layers=DENSE_SCAN_LAYERS)
    params, info = init_timed(torch, serve, M, cut, dev)
    prefill_check(smoke, "serve_vlm", torch, M, T, cut, params,
                  prompt_for(cut, DENSE_PROMPT), dev, SERVE_BF16_TOL,
                  check="text prefill vs decode scan", **info)
    del params
    free_card(torch)
    return {"serve_vlm continuous": counts}


#: hubert-xlarge's encoder input: 4 clips of 20 s at its 50 frames a
#: second, 1,000 frames each; its parameter count (the JAX package's).
AUDIO_CLIPS, AUDIO_FRAMES = 4, 1000
AUDIO_PARAMS = 1_260_360_960


def audio_forward_check(smoke, torch, kernels, serve, M, cfg, dev, tol,
                        n_params: int | None = None) -> dict:
    """A no-grad forward of the audio encoder (the flash kernel, full, once
    a layer) against the grad-mode forward (dense attention, no launch):
    the largest logit difference over the largest logit within ``tol``;
    with ``n_params`` (the published model), the parameter count held to
    it and the forward's device time.  Returns the no-grad forward's
    launches."""
    params, info = init_timed(torch, serve, M, cfg, dev)
    check(n_params is None or info["n_params"] == n_params,
          f"{cfg.name}: {info['n_params']} parameters, want {n_params}")
    gen = torch.Generator(device=dev).manual_seed(600)
    frames = torch.randn(AUDIO_CLIPS, AUDIO_FRAMES, cfg.d_frontend,
                         device=dev, generator=gen)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        got = M.forward(params, {"frontend": frames}, cfg)[0]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    rec = {"max_memory_allocated_bytes": torch.cuda.max_memory_allocated(
        dev)}
    if n_params is not None:
        with torch.no_grad():
            rec["forward"] = device_time(torch, lambda: M.forward(
                params, {"frontend": frames}, cfg), top=8)
        rec["frames_per_s"] = (AUDIO_CLIPS * AUDIO_FRAMES * 1e3
                               / rec["forward"]["wall_ms"])
    kernels.reset_launch_counts()
    want = M.forward(params, {"frontend": frames.clone().requires_grad_(
        True)}, cfg)[0].detach()
    dense = kernels.launch_counts()["flash_attention"]
    err = rel_err(torch, got, want)[0]
    smoke.emit("encode_audio", check="forward, flash (full, D 80) vs dense",
               config=cfg.name, layers=cfg.n_layers, dtype=cfg.param_dtype,
               clips=AUDIO_CLIPS, frames=AUDIO_FRAMES,
               logits_shape=list(got.shape), launches=counts,
               dense_launches=dense, rel_err_logits=err, tol=tol, **rec,
               **info)
    check(tuple(got.shape) == (AUDIO_CLIPS, AUDIO_FRAMES, cfg.vocab),
          f"audio logits {tuple(got.shape)}")
    check(counts["flash_attention"] == cfg.n_layers and dense == 0,
          f"audio forward: {counts['flash_attention']} flash launches, "
          f"grad mode {dense}")
    check(err <= tol, f"audio forward flash vs dense: {err} > {tol}")
    del params, got, want
    free_card(torch)
    return counts


def phase_encode_audio(smoke, torch, kernels, serve, M, dev) -> dict:
    """hubert-xlarge at full width in bf16 and in float32 at
    ``DENSE_SCAN_LAYERS`` layers: ``audio_forward_check``.  Returns the
    bf16 forward's launches."""
    import dataclasses
    full = serve.get_config("hubert-xlarge")
    counts = audio_forward_check(smoke, torch, kernels, serve, M, full, dev,
                                 SERVE_BF16_TOL, AUDIO_PARAMS)
    audio_forward_check(smoke, torch, kernels, serve, M, dataclasses.replace(
        full, param_dtype="float32", act_dtype="float32",
        n_layers=DENSE_SCAN_LAYERS), dev, SERVE_F32_TOL)
    return {"encode_audio": counts}


#: the launcher's own --lr: 3e-3 (what examples/train_lm.py passes at the
#: smoke config) drives the full-width model's loss up within 30 steps of
#: a one-step warmup on the H100 (PERF.md, §6).
LM_TRAIN_ARGV = ["--arch", "smollm-360m", "--batch", "8", "--seq", "512",
                 "--lr", "3e-4", "--log-every", "5"]


def phase_lm_train(smoke, torch, kernels, train, smi, dev):
    """SmolLM-360M trained at full width through the port's launcher: runs
    (a)-(d), their checks, and one profiled step.  Returns the path's
    kernel launches (counts set to 0 just before (a), read after (d)), and
    (a)'s first two losses and median step time."""
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
    return {"lm_train": launches}, {"losses": a[:2], "median_step_s": step_s}


#: Mamba2-370M trained at full width through the launcher (bf16, guard on).
LM_TRAIN_SSM_ARGV = ["--arch", "mamba2-370m", "--batch", "8", "--seq",
                     "512", "--lr", "3e-4", "--log-every", "1", "--steps",
                     "6"]
LM_TRAIN_SSM_STEPS = 6


def phase_lm_train_ssm(smoke, torch, kernels, tg, train, smi, dev) -> dict:
    """Mamba2-370M trained at full width through the port's launcher under
    ``--conv-policy pallas``: every layer's conv on the three tap kernels'
    bf16 instances (the forward twice a step: remat), the first loss and
    gradient norm against the same run under ``auto``
    (``LM_SSM_BF16_TOL``, ``LM_SSM_GNORM_TOL``); in float32
    at ``SSM_F32_LAYERS`` layers, 5 steps under ``pallas`` against ``lax``
    (``LOSS_TOL``).  Returns the two launcher runs' kernel launches."""
    import dataclasses

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    t_phase = time.perf_counter()
    paths, hist, losses, types, variants = {}, {}, {}, {}, {}
    for policy in ("pallas", "auto"):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        hist[policy] = []
        extra = ["--conv-policy", policy]
        if policy == "auto":          # (a)'s schedule, its first step only
            extra += ["--stop-after", "1"]
        losses[policy] = train.main(LM_TRAIN_SSM_ARGV + extra,
                                    history=hist[policy])
        paths[f"lm_train_ssm {policy}"] = kernels.launch_counts()
        types[policy] = tg.type_launch_counts()
        variants[policy] = tg.variant_launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        if policy == "pallas":
            peak_pallas = peak
    a = losses["pallas"]
    secs = [h["seconds"] for h in hist["pallas"]]
    step_s = statistics.median(secs[1:])
    first_err = abs(a[0] - losses["auto"][0]) / abs(losses["auto"][0])
    norms = [hist[p][0]["grad_norm"] for p in ("pallas", "auto")]
    gnorm_err = abs(norms[0] - norms[1]) / abs(norms[1])

    # float32, a quarter of the depth: pallas against lax, 5 steps.
    cfg = dataclasses.replace(train.get_config("mamba2-370m"),
                              param_dtype="float32", act_dtype="float32",
                              n_layers=SSM_F32_LAYERS)
    dcfg = DataConfig(seed=0, seq_len=512, global_batch=8, vocab=cfg.vocab)
    f32 = {}
    for policy in ("pallas", "lax"):
        params = M.init_params(torch.Generator().manual_seed(0), cfg, dev)
        opt = adamw.init_state(params)
        step_fn = TS.make_train_step(cfg, adamw.AdamWConfig(peak_lr=3e-4),
                                     total_steps=5, warmup=1, guard=True,
                                     conv_policy=policy)
        f32[policy] = []
        for step in range(5):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in make_batch(cfg, dcfg, step).items()}
            params, opt, metrics = step_fn(params, opt, batch, step)
            f32[policy].append(float(metrics["loss"]))
        del params, opt
    f32_err = max(abs(x - y) / abs(y) for x, y in zip(f32["pallas"],
                                                      f32["lax"]))
    n = LM_TRAIN_SSM_STEPS * 48
    want = {"tap_gemm:bf16": 2 * n, "tap_gemm_phased:bf16": n,
            "tap_wgrad:bf16": n}
    # every pass on the depthwise variant
    want_variants = {"tap_gemm:dw": 2 * n, "tap_gemm_phased:dw": n,
                     "tap_wgrad:dw": n}
    smoke.emit("lm_train_ssm", nvidia_smi=smi, config="mamba2-370m",
               dtype="bfloat16", batch=8, seq=512, steps=len(a),
               median_step_s=step_s, first_step_s=secs[0],
               tokens_per_s=8 * 512 / step_s,
               max_memory_allocated_bytes=peak_pallas, losses=losses,
               grad_norms={k: [h["grad_norm"] for h in v]
                           for k, v in hist.items()},
               guard_bad={k: sum(h["guard_bad"] for h in v)
                          for k, v in hist.items()},
               first_loss_pallas_vs_auto=first_err, tol=LM_SSM_BF16_TOL,
               first_grad_norm_pallas_vs_auto=gnorm_err,
               grad_norm_tol=LM_SSM_GNORM_TOL,
               f32_layers=SSM_F32_LAYERS, f32_losses=f32,
               f32_max_rel_err=f32_err, f32_tol=LOSS_TOL,
               launches=paths, launches_by_type=types,
               launches_by_variant=variants, want_launches=want,
               want_variant_launches=want_variants,
               seconds=time.perf_counter() - t_phase)
    every = a + losses["auto"] + f32["pallas"] + f32["lax"]
    check(all(math.isfinite(x) for x in every), f"non-finite loss: {every}")
    check(len(a) == LM_TRAIN_SSM_STEPS and len(losses["auto"]) == 1,
          f"steps run: {len(a)}, {len(losses['auto'])}")
    check(not any(h["guard_bad"] for v in hist.values() for h in v),
          "the guard dropped a step")
    check(types["pallas"] == want and variants["pallas"] == want_variants,
          f"pallas training launched {types['pallas']} "
          f"({variants['pallas']}), want {want} ({want_variants})")
    check(not any(paths["lm_train_ssm auto"].values()),
          f"auto training launched {paths['lm_train_ssm auto']}")
    check(first_err <= LM_SSM_BF16_TOL and gnorm_err <= LM_SSM_GNORM_TOL,
          f"first step pallas vs auto: loss {first_err} (tol "
          f"{LM_SSM_BF16_TOL}), grad norm {gnorm_err} (tol "
          f"{LM_SSM_GNORM_TOL})")
    check(f32_err <= LOSS_TOL,
          f"float32 losses pallas vs lax: {f32_err} > {LOSS_TOL}")
    return paths


#: recurrentgemma-9b trained at its published widths and a depth cut:
#: one super-block and the two extra RG-LRU layers (3.22 B parameters,
#: 38.6 GB with AdamW's float32 moments; 38 layers would need 83.6 GB of
#: moments alone), bf16, batch 4 x 512, through ``make_train_step`` with
#: ``donate=True``: the functional update's second copy of the parameters
#: and moments (and the guard's float32 grads) ran the card out of memory
#: at 72.9 GB allocated.
LM_TRAIN_HYBRID_LAYERS = 5
LM_TRAIN_HYBRID_STEPS = 6


def phase_lm_train_hybrid(smoke, torch, kernels, tg, train, smi,
                          dev) -> dict:
    """recurrentgemma-9b's train step at ``LM_TRAIN_HYBRID_LAYERS`` layers,
    full width, bf16, guard on, donating its parameters and moments:
    ``LM_TRAIN_HYBRID_STEPS`` steps under
    ``pallas`` (each RG-LRU layer's conv on the three tap kernels' bf16
    ``dw`` instances at 4,096 groups: the forward twice a layer a step,
    remat, the super-block one checkpoint; the other two once), their
    first loss and gradient norm against one step under ``auto``
    (``LM_SSM_BF16_TOL``, ``LM_SSM_GNORM_TOL``; no launch); float32 at
    ``HYBRID_F32_LAYERS`` layers, 5 steps (batch 2 x 256) under ``pallas``
    against ``lax`` (``LOSS_TOL``).  Returns the bf16 runs' launches."""
    import dataclasses

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    t_phase = time.perf_counter()
    full = train.get_config("recurrentgemma-9b")

    def run(cfg, policy, steps, batch, seq, timed=False):
        dcfg = DataConfig(seed=0, seq_len=seq, global_batch=batch,
                          vocab=cfg.vocab)
        params = M.init_params(torch.Generator().manual_seed(0), cfg, dev)
        n_params = M.count_params(params)
        opt = adamw.init_state(params)
        step_fn = TS.make_train_step(cfg, adamw.AdamWConfig(peak_lr=3e-4),
                                     total_steps=steps, warmup=1, guard=True,
                                     conv_policy=policy, donate=True)
        hist = []
        for step in range(steps):
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in make_batch(cfg, dcfg, step).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, b, step)
            loss = float(metrics["loss"])
            hist.append({"loss": loss, "seconds": time.perf_counter() - t0,
                         "grad_norm": float(metrics["grad_norm"]),
                         "guard_bad": float(metrics["guard_bad"])})
        del params, opt, metrics
        free_card(torch)
        return hist, n_params

    cut = dataclasses.replace(full, n_layers=LM_TRAIN_HYBRID_LAYERS)
    n_rec, _ = hybrid_layers(cut)
    paths, hist, types, variants, peak = {}, {}, {}, {}, {}
    for policy, steps in (("pallas", LM_TRAIN_HYBRID_STEPS), ("auto", 1)):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        hist[policy], n_params = run(cut, policy, steps, 4, 512)
        paths[f"lm_train_hybrid {policy}"] = kernels.launch_counts()
        types[policy] = tg.type_launch_counts()
        variants[policy] = tg.variant_launch_counts()
        peak[policy] = torch.cuda.max_memory_allocated(dev)
    a = [h["loss"] for h in hist["pallas"]]
    secs = [h["seconds"] for h in hist["pallas"]]
    step_s = statistics.median(secs[1:])
    rel = lambda x, y: abs(x - y) / abs(y)     # noqa: E731
    first_err = rel(a[0], hist["auto"][0]["loss"])
    gnorm_err = rel(hist["pallas"][0]["grad_norm"],
                    hist["auto"][0]["grad_norm"])

    cfg32 = dataclasses.replace(full, param_dtype="float32",
                                act_dtype="float32",
                                n_layers=HYBRID_F32_LAYERS)
    f32 = {policy: [h["loss"] for h in run(cfg32, policy, 5, 2, 256)[0]]
           for policy in ("pallas", "lax")}
    f32_err = max(rel(x, y) for x, y in zip(f32["pallas"], f32["lax"]))
    n = LM_TRAIN_HYBRID_STEPS * n_rec
    want = {"tap_gemm:bf16": 2 * n, "tap_gemm_phased:bf16": n,
            "tap_wgrad:bf16": n}
    want_variants = {"tap_gemm:dw": 2 * n, "tap_gemm_phased:dw": n,
                     "tap_wgrad:dw": n}
    smoke.emit("lm_train_hybrid", nvidia_smi=smi, config=full.name,
               layers=cut.n_layers, n_params=n_params, dtype="bfloat16",
               batch=4, seq=512, steps=len(a), median_step_s=step_s,
               first_step_s=secs[0], tokens_per_s=4 * 512 / step_s,
               max_memory_allocated_bytes=peak, history=hist,
               first_loss_pallas_vs_auto=first_err, tol=LM_SSM_BF16_TOL,
               first_grad_norm_pallas_vs_auto=gnorm_err,
               grad_norm_tol=LM_SSM_GNORM_TOL,
               f32_layers=HYBRID_F32_LAYERS, f32_losses=f32,
               f32_max_rel_err=f32_err, f32_tol=LOSS_TOL, launches=paths,
               launches_by_type=types, launches_by_variant=variants,
               want_launches=want, want_variant_launches=want_variants,
               seconds=time.perf_counter() - t_phase)
    every = a + [hist["auto"][0]["loss"]] + f32["pallas"] + f32["lax"]
    check(all(math.isfinite(x) for x in every), f"non-finite loss: {every}")
    check(not any(h["guard_bad"] for v in hist.values() for h in v),
          "the guard dropped a step")
    check(types["pallas"] == want and variants["pallas"] == want_variants,
          f"pallas training launched {types['pallas']} "
          f"({variants['pallas']}), want {want} ({want_variants})")
    check(not any(paths["lm_train_hybrid auto"].values()),
          f"auto training launched {paths['lm_train_hybrid auto']}")
    check(first_err <= LM_SSM_BF16_TOL and gnorm_err <= LM_SSM_GNORM_TOL,
          f"first step pallas vs auto: loss {first_err} (tol "
          f"{LM_SSM_BF16_TOL}), grad norm {gnorm_err} (tol "
          f"{LM_SSM_GNORM_TOL})")
    check(f32_err <= LOSS_TOL,
          f"float32 losses pallas vs lax: {f32_err} > {LOSS_TOL}")
    return paths


#: hubert-xlarge through the training launcher at its published widths.
LM_TRAIN_AUDIO_ARGV = ["--arch", "hubert-xlarge", "--batch", "8", "--seq",
                       "512", "--steps", "6", "--log-every", "5"]
#: the float32 card-vs-CPU steps: batch and frames (the CPU's time).
AUDIO_F32_BATCH, AUDIO_F32_SEQ, AUDIO_F32_STEPS = 2, 128, 3


def phase_lm_train_audio(smoke, torch, kernels, train, smi, dev) -> dict:
    """hubert-xlarge trained through the launcher at full width (bf16,
    guard on; dense attention, no launch): finite losses, no step dropped,
    seconds a step, frames/s, peak memory.  Then in float32 at
    ``DENSE_SCAN_LAYERS`` layers, ``AUDIO_F32_STEPS`` guarded steps of
    ``make_train_step`` on the card and on this machine's CPU from the
    same parameters (drawn on the CPU) and batches: losses within
    ``LOSS_TOL``.  Returns the launcher run's launches."""
    import dataclasses

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    from repro_torch.tree import tree_map
    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    hist = []
    losses = train.main(LM_TRAIN_AUDIO_ARGV, history=hist)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    free_card(torch)
    secs = [h["seconds"] for h in hist]
    step_s = statistics.median(secs[1:])
    frames = 8 * 512

    cfg32 = dataclasses.replace(train.get_config("hubert-xlarge"),
                                param_dtype="float32", act_dtype="float32",
                                n_layers=DENSE_SCAN_LAYERS)
    dcfg = DataConfig(seed=0, seq_len=AUDIO_F32_SEQ,
                      global_batch=AUDIO_F32_BATCH, vocab=cfg32.vocab)
    on_cpu = M.init_params(torch.Generator().manual_seed(0), cfg32, "cpu")
    f32 = {}
    for where, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        params = tree_map(lambda t: t.to(d, copy=True), on_cpu)
        opt = adamw.init_state(params)
        step_fn = TS.make_train_step(cfg32, adamw.AdamWConfig(peak_lr=3e-4),
                                     total_steps=AUDIO_F32_STEPS, warmup=1,
                                     guard=True)
        f32[where] = []
        for step in range(AUDIO_F32_STEPS):
            b = {k: torch.from_numpy(v).to(d)
                 for k, v in make_batch(cfg32, dcfg, step).items()}
            params, opt, metrics = step_fn(params, opt, b, step)
            f32[where].append(float(metrics["loss"]))
        del params, opt, metrics
    free_card(torch)
    f32_err = max(abs(a - b) / abs(b) for a, b in zip(f32["cuda"],
                                                      f32["cpu"]))
    smoke.emit("lm_train_audio", nvidia_smi=smi, config="hubert-xlarge",
               dtype="bfloat16", batch=8, seq=512, steps=len(losses),
               losses=losses, history=hist, median_step_s=step_s,
               first_step_s=secs[0], frames_per_s=frames / step_s,
               max_memory_allocated_bytes=peak, launches=counts,
               f32_layers=DENSE_SCAN_LAYERS, f32_batch=AUDIO_F32_BATCH,
               f32_seq=AUDIO_F32_SEQ, f32_losses=f32,
               f32_max_rel_err=f32_err, f32_tol=LOSS_TOL,
               seconds=time.perf_counter() - t_phase)
    check(len(losses) == 6 and all(math.isfinite(x) for x in losses)
          and not any(h["guard_bad"] for h in hist),
          f"hubert-xlarge training: {hist}")
    check(not any(counts.values()), f"training launched {counts}")
    check(f32_err <= LOSS_TOL,
          f"float32 losses card vs CPU: {f32} ({f32_err} > {LOSS_TOL})")
    return {"lm_train_audio": counts}


#: the chaos drill's steps: 14 armed (a pass of step 3 faulted, steps 4-5
#: quarantined, so 11 on the tap kernels) and 2 disarmed.
CHAOS_STEPS = 14
CHAOS_LAUNCH_STEPS = CHAOS_STEPS - 3 + 2
#: the pass each tap kernel serves.
PASS_KERNEL = {"forward": "tap_gemm", "input_grad": "tap_gemm_phased",
               "weight_grad": "tap_wgrad"}


def phase_chaos(smoke, torch, conv, kernels, config, dev):
    """The chaos drill on the card (``python -m repro_torch.train.chaos``
    under ``pallas``, trace and metrics on): every assertion of the drill;
    each tap kernel launched ``n_pallas[pass] x 13`` times (the faulted and
    quarantined passes launch nothing); the 14 losses against the same run
    under ``bp_phase`` with the same NaN at step 5 (``LOSS_TOL``); the
    trace and metrics through ``scripts/validate_trace.py``; the bus
    consistent with the legacy counters.  Returns the path's launches."""
    import tempfile

    from repro_torch import obs
    from repro_torch.train import chaos
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chaos_") as tmp:
        trace, metrics = f"{tmp}/chaos.json", f"{tmp}/chaos.jsonl"
        kernels.reset_launch_counts()
        res = chaos.main(["--device", str(dev), "--steps", str(CHAOS_STEPS),
                          "--trace", trace, "--metrics", metrics])
        counts = kernels.launch_counts()
        drill_s = time.perf_counter() - t0
        val = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "validate_trace.py"),
             trace, "--require-span", "conv:", "--metrics", metrics,
             "--require-metrics-kind", "train_step"],
            capture_output=True, text=True, timeout=120)
    n = res["n_pallas"]
    want = {k: 0 for k in counts}
    want.update({PASS_KERNEL[p]: n[p] * CHAOS_LAUNCH_STEPS for p in n})
    with config.override(fault_spec="grad.values:nan@step5"):
        ref = chaos.train_loop("bp_phase", CHAOS_STEPS, 32, 0.05, dev)
    diff = max(abs(a - b) for a, b in zip(res["losses"], ref["losses"]))
    rep = res["obs"]
    smoke.emit("chaos", n_pallas=n, launches=counts, want_launches=want,
               losses=res["losses"], bp_phase_losses=ref["losses"],
               max_loss_diff=diff, tol=LOSS_TOL, bad_steps=res["bad_steps"],
               bp_phase_bad_steps=ref["bad_steps"],
               survivors=sorted({f["survivor"]
                                 for f in res["runtime_failures"]}),
               dispatch=res["dispatch_events"],
               faults_fired=len(res["fired"]),
               events_by_kind=rep["events_by_kind"],
               trace_events=rep["trace"]["events"],
               metrics_lines=rep["metrics"]["lines"],
               consistent=rep["consistent"],
               validate_trace=(val.returncode, val.stdout.strip()
                               or val.stderr.strip()),
               drill_s=drill_s, seconds=time.perf_counter() - t0)
    check(counts == want, f"chaos launches {counts}, want {want}")
    check(len(res["losses"]) == len(ref["losses"]) == CHAOS_STEPS
          and diff <= LOSS_TOL and ref["bad_steps"] == [5],
          f"chaos vs bp_phase losses differ by {diff} (bad steps "
          f"{res['bad_steps']} / {ref['bad_steps']})")
    check({f["survivor"] for f in res["runtime_failures"]} == {"bp_phase"},
          f"survivors {res['runtime_failures']}")
    check(val.returncode == 0, f"validate_trace: {val.stdout} {val.stderr}")
    check(rep["consistent"], f"bus divergence: {rep['divergences']}")
    # The drill's degradation was asked for: forget it, and its state.
    conv.reset_dispatch_events()
    obs.reset_all()
    return {"chaos": counts}


#: SmolLM-360M served at full width by the continuous engine with one
#: decode step faulted: 8 requests of 256 tokens, 16 new, on 4 lanes.
CHAOS_SERVE = {"requests": 8, "prompt_len": 256, "max_new": 16, "lanes": 4,
               "fault_spec": "serve.decode:raise@step3"}


def phase_chaos_serve(smoke, torch, kernels, serve, M, config, dev):
    """A failed lane on flash serving: the continuous engine unarmed, then
    with ``serve.decode`` faulted at decode step 3 (telemetry on).  The 4
    lanes active at step 3 end ``failed`` with their partial tokens (the
    unarmed run's first 3), the other 4 ``ok`` with the unarmed run's
    tokens (a difference only at a near-tie, ``token_diffs``); flash
    launched once a layer per admitted request (8); a ``serve_tick`` line
    a decode step.  Returns the armed run's launches."""
    import tempfile

    from repro_torch import obs
    from repro_torch.ft import inject
    c = CHAOS_SERVE
    cfg = serve.get_config("smollm-360m")
    params = serve.init_params(cfg, 0, dev)

    def run():
        kernels.reset_launch_counts()
        inject.set_step(0)
        eng = serve.ENGINES["continuous"](
            cfg, params, max_batch=c["lanes"],
            max_len=c["prompt_len"] + c["max_new"] + 2)
        for rid in range(c["requests"]):
            eng.submit(serve.Request(rid=rid, prompt=prompt_for(
                cfg, c["prompt_len"], seed=30 + rid), max_new=c["max_new"]))
        t0 = time.perf_counter()
        reqs = sorted(eng.run(), key=lambda r: r.rid)
        return reqs, eng.run_summary(), kernels.launch_counts(), \
            time.perf_counter() - t0

    want_reqs, want_s, want_counts, want_secs = run()
    check(all(r.status == "ok" and len(r.out) == c["max_new"]
              for r in want_reqs),
          f"unarmed: {[(r.status, len(r.out)) for r in want_reqs]}")
    with tempfile.TemporaryDirectory(prefix="chaos_serve_") as tmp:
        metrics = f"{tmp}/serve.jsonl"
        with config.override(fault_spec=c["fault_spec"], telemetry=True,
                             metrics_path=metrics):
            obs.reset_all()
            reqs, s, counts, secs = run()
            fired = inject.fired_events()
            rep = obs.finalize()
        with open(metrics) as f:
            lines = [json.loads(ln) for ln in f]
    inject.set_step(0)
    failed = [r.rid for r in reqs if r.status == "failed"]
    ok = [r for r in reqs if r.status == "ok"]
    diffs = token_diffs(torch, M, cfg, params, ok,
                        [want_reqs[r.rid] for r in ok], dev)
    smoke.emit("chaos_serve", config=cfg.name, dtype=cfg.param_dtype,
               layers=cfg.n_layers, **c, status=[r.status for r in reqs],
               tokens=[len(r.out) for r in reqs], failed=failed,
               faults_fired=[(f["site"], f["step"]) for f in fired],
               summary=s, unarmed_summary=want_s, launches=counts,
               unarmed_launches=want_counts, token_diffs=diffs,
               metrics_lines=len(lines),
               serve_events=rep["events_by_kind"]["serve"],
               consistent=rep["consistent"], seconds=secs,
               unarmed_seconds=want_secs)
    check(failed == [0, 1, 2, 3] and len(ok) == 4
          and all(r.out == want_reqs[r.rid].out[:3]
                  for r in reqs if r.status == "failed")
          and all(len(r.out) == c["max_new"] for r in ok),
          f"failed lanes {failed}: {[(r.status, len(r.out)) for r in reqs]}")
    check(all(d["margin"] < MARGIN_TOL for d in diffs["differing"]),
          f"the ok requests' tokens differ beyond a near-tie: {diffs}")
    check(s["failed"] == 4 and s["admitted"] == c["requests"]
          and counts == {**{k: 0 for k in counts},
                         "flash_attention": cfg.n_layers * s["admitted"]}
          and counts == want_counts,
          f"summary {s}, launches {counts} (unarmed {want_counts})")
    check(len(lines) == s["decode_steps"]
          and all(ln["kind"] == "serve_tick" for ln in lines)
          and lines[-1]["failed"] == 4 and rep["consistent"],
          f"{len(lines)} metrics lines for {s['decode_steps']} decode steps")
    check([f["step"] for f in fired] == [3] * 4, f"fired {fired}")
    obs.reset_all()
    del params
    free_card(torch)
    return {"chaos_serve continuous": counts}


#: the traced LM training run: ``LM_TRAIN_ARGV`` for 6 steps, step 2's
#: gradients NaN-poisoned.
LM_TRAIN_OBS_STEPS = 6
LM_TRAIN_OBS_FAULT = "grad.values:nan@step2"


def phase_lm_train_obs(smoke, torch, kernels, train, config, smi, lm, dev):
    """``python -m repro_torch.launch.train`` at full width with
    ``--fault-spec grad.values:nan@step2 --trace T --metrics M``: only step
    2 dropped by the guard, steps 0-1's losses equal the unarmed
    ``lm_train`` phase's (``LM_TRAIN_TOL``), the trace valid with a
    ``train:step`` span a step, a ``train_step`` metrics line a step; the
    seconds a step with telemetry on beside ``lm_train``'s.  Returns the
    path's launches (none)."""
    import tempfile

    from repro_torch import obs
    t0 = time.perf_counter()
    hist = []
    saved = config.snapshot()
    with tempfile.TemporaryDirectory(prefix="lm_train_obs_") as tmp:
        trace, metrics = f"{tmp}/train.json", f"{tmp}/train.jsonl"
        kernels.reset_launch_counts()
        try:
            losses = train.main(
                LM_TRAIN_ARGV + ["--steps", str(LM_TRAIN_OBS_STEPS),
                                 "--fault-spec", LM_TRAIN_OBS_FAULT,
                                 "--trace", trace, "--metrics", metrics],
                history=hist)
        finally:
            config.update(**saved)
            obs.reset_all()
        launches = kernels.launch_counts()
        val = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "validate_trace.py"),
             trace, "--require-span", "train:step", "--metrics", metrics,
             "--require-metrics-kind", "train_step"],
            capture_output=True, text=True, timeout=120)
        with open(trace) as f:
            spans = [e["name"] for e in json.load(f)["traceEvents"]
                     if e["ph"] == "B"]
        with open(metrics) as f:
            lines = [json.loads(ln) for ln in f]
    bad = [h["guard_bad"] for h in hist]
    rel = [abs(x - y) / abs(y) for x, y in zip(losses[:2], lm["losses"])]
    step_s = statistics.median(h["seconds"] for h in hist)
    smoke.emit("lm_train_obs", nvidia_smi=smi, config="smollm-360m",
               steps=len(losses), fault_spec=LM_TRAIN_OBS_FAULT,
               losses=losses, guard_bad=bad, rel_err_steps_0_1=rel,
               tol=LM_TRAIN_TOL, median_step_s=step_s,
               lm_train_median_step_s=lm["median_step_s"],
               step_s=[h["seconds"] for h in hist],
               train_step_spans=spans.count("train:step"),
               metrics_lines=len(lines),
               validate_trace=(val.returncode, val.stdout.strip()
                               or val.stderr.strip()),
               launches=launches, seconds=time.perf_counter() - t0)
    check(bad == [float(s == 2) for s in range(LM_TRAIN_OBS_STEPS)],
          f"guard_bad by step {bad}")
    check(all(math.isfinite(x) for x in losses) and max(rel) <= LM_TRAIN_TOL,
          f"steps 0-1 against lm_train: {rel}")
    check(val.returncode == 0, f"validate_trace: {val.stdout} {val.stderr}")
    check(spans.count("train:step") == LM_TRAIN_OBS_STEPS
          and [(ln["kind"], ln["step"]) for ln in lines]
          == [("train_step", s) for s in range(LM_TRAIN_OBS_STEPS)],
          f"{spans.count('train:step')} spans, {len(lines)} metrics lines")
    check(not any(launches.values()),
          f"a kernel launched while training: {launches}")
    return {"lm_train_obs": launches}


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
    agg_bf16 = phase_kernels(smoke, torch, F, nn_grad, ops, tg, ref,
                             kernel_bf16_shapes(ConvDims, paper_cnn), dev,
                             torch.bfloat16, "kernels_bf16")
    agg_rg = phase_kernels(smoke, torch, F, nn_grad, ops, tg, ref,
                           rg_conv_shapes(ConvDims), dev, torch.bfloat16,
                           "kernels_bf16")
    dw_conv_times(smoke, torch, conv, tg, dev)
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
    paths.update(phase_chaos(smoke, torch, conv, kernels, config, dev))
    agg.update(phase_flash(smoke, torch, F, fa, ref, dev))
    paths.update(phase_serve(smoke, torch, kernels, serve, M, T, dev))
    free_card(torch)
    paths.update(phase_chaos_serve(smoke, torch, kernels, serve, M, config,
                                   dev))
    paths.update(phase_serve_moe(smoke, torch, kernels, serve, M, T, dev))
    paths.update(phase_serve_ssm(smoke, torch, kernels, tg, serve, M, T,
                                 dev))
    paths.update(phase_serve_hybrid(smoke, torch, kernels, tg, serve, M, T,
                                    dev))
    paths.update(phase_serve_dense(smoke, torch, kernels, serve, M, T, dev))
    paths.update(phase_serve_vlm(smoke, torch, kernels, serve, M, T, dev))
    paths.update(phase_encode_audio(smoke, torch, kernels, serve, M, dev))
    lm_paths, lm = phase_lm_train(smoke, torch, kernels, train, smi, dev)
    paths.update(lm_paths)
    paths.update(phase_lm_train_obs(smoke, torch, kernels, train, config,
                                    smi, lm, dev))
    paths.update(phase_lm_train_ssm(smoke, torch, kernels, tg, train, smi,
                                    dev))
    paths.update(phase_lm_train_hybrid(smoke, torch, kernels, tg, train, smi,
                                       dev))
    paths.update(phase_lm_train_audio(smoke, torch, kernels, train, smi,
                                      dev))
    smoke.emit("summary", launches_by_path=paths)

    main_path = {k: "cnn_bp pallas" for k in TAP_KERNELS}
    main_path["matmul"] = "cnn_bp traditional"
    main_path["flash_attention"] = "serve continuous"
    main_path["flash_attention_d256"] = "serve_hybrid continuous"
    main_path["flash_attention_bidir_d80"] = "encode_audio"
    shapes = {"matmul": "sum over the 15 traditional GEMMs (forward, input "
                        "grad, weight grad) of the 5 Table II layers, batch "
                        "2, float32",
              "flash_attention": "one prefill's attention: causal (1, 15, "
                                 "1024, 64) queries against (1, 5, 1024, 64) "
                                 "keys and values, bf16",
              "flash_attention_d256": "one recurrentgemma-9b prefill's "
                                      "attention layer: causal (1, 16, 1024, "
                                      "256) queries against (1, 1, 1024, 256) "
                                      "keys and values, bf16",
              "flash_attention_bidir_d80": "one hubert-xlarge encoder "
                                           "layer's attention: full (4, 16, "
                                           "1000, 80) queries, keys and "
                                           "values, bf16, on the D-128 "
                                           "instance"}
    for name in TAP_KERNELS:
        agg[f"{name}_bf16"] = agg_bf16[name]
        main_path[f"{name}_bf16"] = "lm_train_ssm pallas"
        shapes[f"{name}_bf16"] = ("the bf16 instance at Mamba2-370M's "
                                  "depthwise causal conv, training shape: "
                                  "batch 8 x seq 512, 2,304 groups of one "
                                  "channel, 4 taps; variant "
                                  + agg_bf16[name]["variant"])
        agg[f"{name}_bf16_g4096"] = agg_rg[name]
        main_path[f"{name}_bf16_g4096"] = "lm_train_hybrid pallas"
        shapes[f"{name}_bf16_g4096"] = (
            "the bf16 instance at recurrentgemma-9b's temporal conv, "
            "training shape: batch 4 x seq 512, 4,096 groups of one "
            "channel, 4 taps; variant " + agg_rg[name]["variant"])
    # The tap kernels' bf16-operand instances (the TPU kernels take the
    # operands' dtype and sum in float32) have rows of their own, at
    # Mamba2's and recurrentgemma's convs; so has flash attention at
    # recurrentgemma's head dim 256 and, full, at hubert-xlarge's 80.
    rows = {**KERNELS, **{f"{k}_bf16{g}": KERNELS[k] for k in TAP_KERNELS
                          for g in ("", "_g4096")},
            "flash_attention_d256": KERNELS["flash_attention"],
            "flash_attention_bidir_d80": KERNELS["flash_attention"]}
    out = []
    for name, (replaces, source) in rows.items():
        a = agg[name]
        b_s, b_by = bound(a["flops"], a["bytes"],
                          a.get("peak", PEAK_F32_FLOPS))
        kernel = re.sub(r"_(bf16|d256|bidir).*", "", name)
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": paths[main_path[name]][kernel],
            "max_abs_err": a["max_abs_err"], "ms": a["ms"],
            "plain_ms": a["plain_ms"], "bound_ms": b_s * 1e3,
            "bound_by": b_by, "library_ms": a["library_ms"],
            "launches_path": main_path[name],
            "launches_by_path": {p: c[kernel] for p, c in paths.items()},
            "shapes": shapes.get(name, "sum over the 5 Table II layers, "
                                       "batch 2, float32")})
    print(smi)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
