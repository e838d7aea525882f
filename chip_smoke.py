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
                   flash attention at head dims 64, 128, 192 and 256, the
                   float32 one at 64, 80, 128, 192 and 256, which must not
                   spill nor pass 227 KB of shared memory); the
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
                   bf16, the last two in float32 too) and hubert-xlarge's
                   encoder (4 x 16 heads of 80, full attention over 1,000
                   frames, bf16 and float32, and causal in float32); the
                   float32 instance's edges: head dims 96, 100 and 250
                   (rows not 16-byte aligned) and one query row; two runs
                   are bit-equal; kernel, plain and
                   ``F.scaled_dot_product_attention`` device times (timed
                   only: the port never calls it), host time, bound (a
                   float32 row against its path's, three TF32 products a
                   pair at 495 TFLOP/s, and beside it the float32 bound
                   at 67 TFLOP/s); a float32 call counts one launch of
                   ``flash_attention_f32`` as well.
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
                   1,024 tokens, 32 new, batch 4; static, 8 of 32 tokens,
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
                   batch 4: 48 launches a request) and ``static`` (8 of 32
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
                   ``conv_policy="pallas"``: at ``SSM_SCAN_LAYERS`` layers
                   the one-pass prefill (chunked SSD with a ragged last
                   chunk, the conv on ``tap_gemm``: one bf16 launch of
                   ``dw`` a layer) vs the decode scan (none) on a
                   ``MAMBA2_PROMPT``-token prompt, logits and each layer's
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
                   static: 8 of 32 tokens, 8 new, none), tokens/s, p50,
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
                   launches a request; static: 8 of 32 tokens, 8 new,
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
 21. lm_train_moe -- moonshot-v1-16b-a3b's ``make_train_step`` at its
                   published widths and ``LM_TRAIN_MOE_LAYERS`` layers (the
                   dense one and 3 MoE layers, 2,520,664,064 parameters;
                   bf16, seed 0, 8 x 512, guard on, donated): 6 steps,
                   every loss and grad norm finite, none dropped; the first
                   loss against ``loss_fn`` in float32 on the same weights
                   (``LM_TRAIN_MOE_TOL``); median step time, tokens/s, peak
                   memory, one profiled step's device-busy share; no launch
                   (dense attention in training, no conv).
 22. lm_train_audio -- ``python -m repro_torch.launch.train --arch
                   hubert-xlarge`` at full width (bf16, batch 8, seq 512,
                   6 steps, guard on; no launch: training runs dense
                   attention): finite losses, seconds a step, frames/s,
                   peak memory; float32 at ``DENSE_SCAN_LAYERS`` layers,
                   the first 3 losses of ``make_train_step`` on the card
                   against the same run on this machine's CPU from the same
                   parameters (``LOSS_TOL``).
 23. chaos      -- (run after autotune) the chaos drill
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
 24. chaos_serve -- (after serve) SmolLM-360M at full width, bf16, on the
                   continuous engine: 8 requests of 256 tokens, 16 new, 4
                   lanes, unarmed and then with ``serve.decode:raise@step3``
                   (telemetry on): the 4 lanes of decode step 3 end
                   ``failed`` with the unarmed run's first 3 tokens, the
                   other 4 ``ok`` with its tokens (``token_diffs``' near-tie
                   rule); flash launched 32 x 8 times; ``run_summary()
                   ["failed"] == 4``; a ``serve_tick`` line a decode step.
 25. lm_train_obs -- (after lm_train) the launcher at lm_train's settings
                   for 6 steps with ``--fault-spec grad.values:nan@step2
                   --trace --metrics``: only step 2 dropped by the guard;
                   steps 0-1's losses within ``LM_TRAIN_TOL`` of lm_train's;
                   the trace valid with a ``train:step`` span a step; a
                   ``train_step`` line a step; seconds a step beside
                   lm_train's; no kernel launched.
 26. mesh       -- (after chaos) the mesh-parallel conv
                   (``repro_torch.dist.conv_parallel``) on ``MESH_RANKS``
                   ranks spawned on the one card: a ``(data=2, model=2)``
                   mesh on gloo, each collective's tensors staged to the
                   host, the kernels built by this process before the
                   spawn.  (a) the five Table II layers at batch 2,
                   float32, under ``pallas``, for ``spatial`` and ``tp``:
                   forward, input grad and weight grad held to the same
                   pass unsharded on the card (``MESH_TOL`` relative to
                   max |.|), each plan's tag and drops to
                   ``MESH_TABLE2``, each rank's ``halo`` bytes to
                   ``shard_halo``'s rows x its block's bytes (three
                   exchanges a layer: forward, input grad, weight grad);
                   (b) the autoencoder CLI's loop (batch 16, widths (16,
                   32), 16 x 16) for ``MESH_AE_STEPS`` steps through
                   ``make_train_step(conv_mesh=)`` under ``tp``,
                   ``dp_only`` and ``spatial``, every loss within
                   ``MESH_AE_TOL`` relative of the unsharded card run's,
                   parameters and moments bit-identical on every rank;
                   every rank that sharded a pass launched every tap
                   kernel.  (c) Mamba2-370M at full width through the
                   launcher, ``--conv-policy pallas --conv-mesh dp_only``
                   on 2 ranks started by ``torch.distributed.run``
                   (lm_train_ssm's settings, ``MESH_LM_STEPS`` steps):
                   the batch-sharded step, each rank's forward and
                   backward on its 4 x 512 block, every conv pass on the
                   bf16 ``dw`` kernels at batch 4.  (d) on the 4 ranks of
                   (a) and (b), Mamba2-370M's parameters, AdamW moments
                   and batch in their ``tp`` blocks through
                   ``dist.spmd.sharded_step`` (``conv_mesh="tp"``, the
                   launcher's settings): each rank holds exactly the
                   bytes ``launch.dryrun.bytes_per_device`` counts a
                   device of an abstract (2, 2) mesh and computes on its
                   ``model`` block of every ``ssm`` leaf
                   (``dist.tensor_parallel``: 16 of 32 heads, B and C
                   whole; ``in_proj``, ``conv_w`` and ``out_proj`` taken
                   from the leaf gathered whole), the bytes it gathers and
                   computes with in each step the plan's counts, its
                   depthwise conv on its 4 x 1,280 block (the ``dw``
                   kernels, launched twice / once / once a layer a step;
                   the conv hook cuts the block no further: ``mesh:*``
                   events), the ranks' gathered parameters bit-identical;
                   plan, model psums, peak memory and seconds a step on
                   the (d) line.  (c)'s and (d)'s losses and gradient
                   norms at every step within ``MESH_LM_LOSS_TOL`` /
                   ``MESH_LM_GNORM_TOL`` of the launcher's unsharded run,
                   the ranks' losses equal.
                   (e) on the same 4 ranks, moonshot-v1-16b-a3b at its
                   published widths cut to ``MESH_MOE_LAYERS`` layers
                   through ``sharded_step``, each policy of
                   ``MESH_MOE_RUNS`` (``tp`` at 8 x 512 for 2 steps: 2
                   batch blocks of whole MoE groups; ``dp_only`` at 8 x
                   500 for 1 step: 4 blocks across groups of 800) against an
                   unsharded run of the same cut and batch made before the
                   spawn: bytes a rank against the dry run, losses and
                   norms (``MESH_MOE_LOSS_TOL`` / ``MESH_MOE_GNORM_TOL``),
                   the tokens whose expert set or kept set differs at step
                   0 (``MESH_MOE_ROUTE_TOL``), no launch.  ``tp`` computes
                   on the ``model`` blocks (``dist.tensor_parallel``):
                   each rank's plan, the bytes it computes with in a step
                   (the plan's count), its expert einsums' experts (32 of
                   64; 64 under ``dp_only``), its peak memory over each
                   step and its seconds a step beside those of the step
                   that gathered every parameter whole, on the
                   (e) lines.  (f) on the same 4 ranks, recurrentgemma-9b
                   at its published widths cut to one super-block
                   (``MESH_HYBRID_CUT``), lm_train_hybrid's 4 x 512
                   for ``MESH_HYBRID_STEPS`` steps through
                   ``sharded_step`` under ``tp`` (each rank 2,048 of 4,096
                   RG-LRU channels, its gates reading the conv output
                   gathered over ``model``; 8 of 16 query heads against
                   the one KV head), against the same cut trained
                   unsharded on the card before the spawn, checked as
                   (d), with its ``gather`` calls.  (d) and (f) then hold
                   each rank's first conv operands (its batch and channel
                   block) on the three ``dw`` kernels against their plain
                   versions, on a line of their own.  (g) on the same 4
                   ranks, DeepSeek-V3 at its published widths cut to one
                   dense MLA layer and its MTP block (``MESH_MLA_CUT``),
                   2 x 512 for ``MESH_MLA_STEPS`` steps through
                   ``sharded_step`` under ``tp`` (each rank 64 of 128 MLA
                   heads against the latents computed whole, 9,216 of
                   18,432 MLP columns, 3,584 of 7,168 ``d_model`` columns
                   of ``mtp.proj``, its output gathered over ``model``
                   once a step), against the same cut trained unsharded
                   on the card before the spawn, checked as (f) without
                   the conv, no launch, its ``model_flops`` beside its
                   seconds a step; then the plans of internvl2-76b at 8
                   layers and hubert-xlarge (``MESH_PLAN_COUNTS``) counted
                   on ``meta`` tensors (``frontend_proj`` on its
                   ``d_model`` columns), with no step.  Each rank's
                   launches, ``mesh:*`` events and halo bytes on lines of
                   their own; the ranks' seconds are those of processes
                   sharing one card, not speeds.  NCCL across cards is not
                   run.  Every mesh line also carries the bytes each rank
                   sends and receives a step in the grad sync (a
                   fixed-order reduce-scatter into each rank's blocks on
                   ``sharded_step``), the model psums and the folds
                   (``tensor_parallel.COUNTS``), held to the counts worked
                   out from the plan and the specs (``want_sync_bytes``,
                   ``want_fold_bytes``; a model psum at ``model`` = 2
                   sends and receives the bytes it sums; (a) makes none).
 27. summary    -- every kernel's launches on each path, each path run with
                   the counts set to 0 just before it and read just after.
 28. quickstart -- (after transposed) ``repro_torch.quickstart`` on the card:
                   the sparsities, Algorithm 1 against explicit
                   zero-insertion, the implicit grads against the dense
                   library conv (TF32 off), the traffic figures; its
                   checks raise, its printed lines on the line.

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
import contextlib
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
#: float32 flash attention runs three TF32 products (495 TFLOP/s dense) for
#: each float32 product: its path's peak for float32 work.
PEAK_TF32_FLOPS = 495e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
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
#: tensor-core flash attention: head dims 64, 128, 192 and 256, and the
#: float32 one, three TF32 products a pair: 64, 80, 128, 192 and 256, each
#: with and without 16-byte rows), whose registers, spills and shared
#: memory the build phase reports, and how many entries each has.
REDESIGNED = {"tap_gemm": (("3fwd6kernel", "2dw10fwd_kernel"), 12),
              "tap_gemm_phased": (("6phased6kernel", "2dw13phased_kernel"),
                                  28),
              "tap_wgrad": (("5wgrad6kernel", "2dw12wgrad_kernel"), 20),
              "matmul": (("4gemm6kernel", "4tall6kernel", "6mirror6kernel"),
                         22),
              "flash_attention": (("flash_bf16_kernel",), 8),
              "flash_attention_f32": (("flash_f32_kernel",), 10)}
#: the shared memory a block may take (232,448 bytes).
SMEM_BLOCK_MAX = 227 * 1024


def flash_bf16_smem(dm: int) -> int:
    """Dynamic shared memory of ``flash_bf16_kernel<DM>``: Q plus two stages
    of K and V, 64 rows each, of DM + 8 bf16 (csrc/flash_attention.cu);
    168,960 bytes at DM 256, one block an SM."""
    return (64 + 4 * 64) * (dm + 8) * 2


def flash_f32_smem(dm: int) -> int:
    """Dynamic shared memory of ``flash_f32_kernel<DM>``: two stages of K
    (rows of ``pk`` floats, 8 mod 32) and V (``pv``, 4 mod 32), 64 rows each
    at DM 64 and 128, 32 at 80 and above 128, then Q (64 x DM): hi and lo,
    raw at 256; from DM 128 (256 threads) a float a thread
    (csrc/flash_attention.cu)."""
    pk, pv = dm + (40 - dm % 32) % 32, dm + (36 - dm % 32) % 32
    rows = 32 if dm == 80 or dm > 128 else 64
    q_tiles = 2 if dm < 256 else 1
    return (2 * rows * (pk + pv) + q_tiles * 64 * dm
            + (256 if dm >= 128 else 0)) * 4


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
                        if kernel == "flash_attention" else
                        flash_f32_smem(int(dm.group(1)))
                        if kernel == "flash_attention_f32" else 0)
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
               "matmul": 0, "flash_attention": 0, "flash_attention_f32": 0},
    "traditional": {"tap_gemm": 0, "tap_gemm_phased": 0, "tap_wgrad": 0,
                    "matmul": 3, "flash_attention": 0,
                    "flash_attention_f32": 0},
    "bp_im2col": {"tap_gemm": 0, "tap_gemm_phased": 0, "tap_wgrad": 0,
                  "matmul": 3, "flash_attention": 0,
                  "flash_attention_f32": 0},
    "lax": {"tap_gemm": 0, "tap_gemm_phased": 0, "tap_wgrad": 0,
            "matmul": 0, "flash_attention": 0, "flash_attention_f32": 0},
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
            check(fwd == {k: int(k == fwd_kernel) for k in fwd},
                  f"{label} {policy}: forward launches {fwd}")
            check(max(errs) <= LAYER_TOL,
                  f"{label}: {policy} vs the lax materialization {errs}")


def phase_quickstart(smoke, torch, dev) -> None:
    """The ``quickstart`` phase (module docstring, 28):
    ``repro_torch.quickstart`` on the card; its checks raise."""
    import contextlib
    import io

    from repro_torch import quickstart
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        figures = quickstart.run(dev)
    lines = out.getvalue().splitlines()
    smoke.emit("quickstart", device=str(dev), figures=figures,
               printed=lines, seconds=time.perf_counter() - t0)
    check(sum(line.endswith("OK") for line in lines) == 2,
          f"quickstart: {lines}")


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
        # The tuner's outcomes, and the planner's one {role}_pallas a
        # geometry and plan beside each (kernels/ops.py::launch_gap).
        tuner_m, tuner_c = ({k: v for k, v in ev.items() if "_autotune_" in k}
                            for ev in (ev_m, ev_c))
        planned = {f"{r}_pallas": ev_m.get(f"{r}_autotune_miss")
                   for r in ops.PLAN_ROLES}
        check(set(tuner_m) == {f"{r}_autotune_miss" for r in ops.PLAN_ROLES}
              and {k: v for k, v in ev_m.items() if k not in tuner_m}
              == planned, f"measure run: {ev_m}")
        check(set(tuner_c) == {f"{r}_autotune_hit" for r in ops.PLAN_ROLES}
              and sum(tuner_c.values()) == sum(tuner_m.values())
              and {k: v for k, v in ev_c.items() if k not in tuner_c}
              == planned, f"cached run: {ev_c} (measure run: {ev_m})")
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
#: clips of 1,000 frames, 16 heads of 80 on the D-128 instance in bf16 and
#: the D-80 one in float32, full attention) follow the SmolLM cases; then
#: the float32 instances' edges: hubert's D 80 causal, head dims 96 and 100
#: (the D-128 instance; rows of 400 bytes are 16-byte aligned), 250 (rows
#: of 1,000 bytes, not aligned: plain loads), one query row and
#: recurrentgemma's 256 queries against 1,024 keys.  New cases go last, so
#: the earlier ones keep their seeds (``300 + index``).
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
        dt, 80) for dt in ("bfloat16", "float32")]
    + [("hubert P1000 causal f32", 4, 16, 16, 1000, 1000, True, "float32",
        80),
       ("d96 P1024 f32", 1, 16, 8, 1024, 1024, True, "float32", 96),
       ("d100 P1000 f32", 1, 16, 8, 1000, 1000, True, "float32", 100),
       ("d250 P1000 f32", 1, 16, 1, 1000, 1000, True, "float32", 250),
       ("q1 k1024 f32", 1, 15, 5, 1, 1024, True, "float32", 64),
       ("rg q256 k1024 f32", 1, 16, 1, 256, 1024, True, "float32", 256)])
#: the cases of the ``kernels`` line's rows beside the first case's:
#: recurrentgemma-9b's prefill, hubert-xlarge's encoder and SmolLM's
#: prefill in float32.
FLASH_ROW_CASES = {"rg P1024 b16": "flash_attention_d256",
                   "hubert P1000 full b16": "flash_attention_bidir_d80",
                   "serve P1024 f32": "flash_attention_f32"}


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
    ``flash_attention_bidir_d80``, ``flash_attention_f32``).  A bf16 row's
    bound is at the bf16 peak, a float32 row's at its path's
    (``PEAK_3XTF32_FLOPS``), with the float32 bound (``PEAK_F32_FLOPS``)
    beside it."""
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
        before = dict(fa.LAUNCHES)
        got = kern()
        launches = fa.LAUNCHES["flash_attention"] - before["flash_attention"]
        f32_launches = (fa.LAUNCHES["flash_attention_f32"]
                        - before["flash_attention_f32"])
        want = plain()
        torch.cuda.synchronize()
        err, abs_err = rel_err(torch, got, want)
        lib_err, _ = rel_err(torch, lib(), want)
        check(bool(torch.equal(got, kern())),
              f"flash_attention differs run to run at {label}")
        flops = 4.0 * b * h * d * attention_pairs(lq, lk, causal)
        by = nbytes(q, k, v, got)
        peak = (PEAK_BF16_FLOPS if dtype == torch.bfloat16
                else PEAK_3XTF32_FLOPS)
        b_s, b_by = bound(flops, by, peak)
        tol = BF16_TOL if dtype == torch.bfloat16 else FLASH_TOL
        rec = {"kernel": "flash_attention", "case": label,
               "q": [b, h, lq, d], "kv": [b, hk, lk, d], "causal": causal,
               "dtype": dt, "max_rel_err": err, "max_abs_err": abs_err,
               "tol": tol, "library_rel_err": lib_err,
               "launches_per_call": launches,
               "f32_launches_per_call": f32_launches,
               "kernel_ms": time_ms(torch, kern),
               "kernel_host_ms": host_ms(torch, kern),
               "plain_ms": time_ms(torch, plain),
               "library_ms": time_ms(torch, lib),
               "bound_us": b_s * 1e6, "bound_by": b_by,
               "gflop": flops / 1e9, "mbytes": by / 1e6}
        if dtype == torch.float32:
            rec["bound_f32_us"] = bound(flops, by, PEAK_F32_FLOPS)[0] * 1e6
        rec["roofline_share"] = rec["bound_us"] / 1e3 / rec["kernel_ms"]
        smoke.emit("flash", **rec)
        check(launches == 1 and f32_launches == (dtype == torch.float32),
              f"flash_attention: {launches} launches, {f32_launches} of "
              f"the float32 instance")
        check(err <= tol, f"flash_attention at {label}: relative error "
                          f"{err} > {tol}")
        name = "flash_attention" if i == 0 else FLASH_ROW_CASES.get(label)
        if name:
            rows[name] = {"ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
                          "library_ms": rec["library_ms"], "flops": flops,
                          "bytes": by, "max_abs_err": abs_err,
                          "peak": peak}
    return rows


#: the static engine's prompts in every launcher run: its lockstep
#: prefill is one decode step a token (75-330 ms each on the H100's host),
#: so its five runs at 128 tokens took 188 s of the script's time on a
#: slow host (PERF.md, §6), at 1,024 (SmolLM) 158 s alone.
STATIC_PROMPT = "32"
#: SmolLM-360M through the launcher: the continuous engine on 1,024-token
#: prompts, the static engine on ``STATIC_PROMPT``-token prompts.
SERVE_ARGV = {
    "continuous": ["--full", "--requests", "8", "--prompt-len", "1024",
                   "--max-new", "32", "--max-batch", "4"],
    "static": ["--full", "--requests", "8", "--prompt-len", STATIC_PROMPT,
               "--max-new", "8", "--max-batch", "4"]}
#: the bf16 prefill-vs-scan check runs an eighth of SmolLM's 32 layers,
#: every width kept (its 1,024-step scan took 59 s at 32 and 24 s at 8 on
#: a slow host); the device times and the launcher run all 32.
SERVE_BF16_LAYERS = 4


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
    on 4 lanes): ``token_diffs`` of the two, and the kernel launches of the
    two engines' runs (counts set to 0 just before, read just after)."""
    import numpy as np

    from repro_torch import kernels
    kernels.reset_launch_counts()
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
    launches = kernels.launch_counts()
    return {**token_diffs(torch, M, cfg, params, runs["static"],
                          runs["continuous"], dev), "launches": launches}


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
    # lockstep prefill, not two); the continuous one recycles 4 lanes and
    # prefills each request in one pass: the float32 flash instance once a
    # layer a request, the main path of its ``kernels`` row.
    params = serve.init_params(cfg32, 0, dev)
    rec = engines_agree(torch, serve, M, cfg32, params, 1024, 32, dev)
    smoke.emit("serve", check="float32 greedy tokens, static vs continuous",
               **rec)
    check(all(d["margin"] < MARGIN_TOL for d in rec["differing"]),
          f"float32 engines disagree beyond a near-tie: {rec['differing']}")
    n = cfg32.n_layers * rec["requests"]
    check(rec["launches"]["flash_attention_f32"]
          == rec["launches"]["flash_attention"] == n,
          f"float32 engines launched {rec['launches']}, want {n} float32 "
          f"flash launches")
    paths["serve_f32 engines"] = rec["launches"]
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
#: engine on 1,024-token prompts, the static engine on
#: ``STATIC_PROMPT``-token prompts.
SERVE_MOE_ARGV = {
    "continuous": ["--full", "--arch", "moonshot-v1-16b-a3b", "--requests",
                   "8", "--prompt-len", "1024", "--max-new", "32",
                   "--max-batch", "4"],
    "static": ["--full", "--arch", "moonshot-v1-16b-a3b", "--requests", "8",
               "--prompt-len", STATIC_PROMPT, "--max-new", "8",
               "--max-batch", "4"]}
#: prompt of the MoE prefill-vs-scan checks (the scan reads every expert
#: of every layer at each of its steps).
MOE_PROMPT = 512
#: moonshot's bf16 prefill-vs-scan check runs its first 4 of 48 layers
#: (the dense one and 3 MoE layers), every width kept: the 512-step scan
#: of all 48 took 152 s on the H100's host, of 8 layers 27 s on a slow
#: host; the device times and the launcher run all 48.
MOE_SCAN_LAYERS = 4
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
#: a multiple of the SSD chunk, 128: its last chunk is ragged), the bf16
#: check's depth (its 500-step scan of all 48 layers took 49 s on a slow
#: host; the device times and the launcher run all 48) and the float32
#: checks' depth (every width kept).
MAMBA2_PROMPT = 500
SSM_SCAN_LAYERS = 16
SSM_F32_LAYERS = 4
#: the launcher under each conv policy: the continuous engine on 1,024-token
#: prompts (one ``tap_gemm`` launch a layer in each prefill under
#: ``pallas``), the static engine (lockstep prefill through the decode
#: path, which has no conv launch) on ``STATIC_PROMPT``-token prompts.
SERVE_SSM_ARGV = {
    "continuous": ["--full", "--arch", "mamba2-370m", "--requests", "8",
                   "--prompt-len", "1024", "--max-new", "32",
                   "--max-batch", "4"],
    "static": ["--full", "--arch", "mamba2-370m", "--requests", "8",
               "--prompt-len", STATIC_PROMPT, "--max-new", "8",
               "--max-batch", "4"]}


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
    """Mamba2-370M at full width: prefill vs the decode scan in bf16
    (``SSM_SCAN_LAYERS``) and float32 (``SSM_F32_LAYERS``), device times of
    a prefill and
    a decode step, greedy tokens under ``pallas`` and ``auto`` (float32),
    and both engines through the launcher under both policies.  Returns
    each engine's kernel launches."""
    import dataclasses
    full = dataclasses.replace(serve.get_config("mamba2-370m"),
                               conv_policy="pallas")
    cut = dataclasses.replace(full, n_layers=SSM_SCAN_LAYERS)
    params, info = init_timed(torch, serve, M, cut, dev)
    ssm_prefill_check(smoke, torch, M, T, tg, cut, params,
                      prompt_for(cut, MAMBA2_PROMPT), dev, SSM_BF16_TOL,
                      SERVE_BF16_TOL, check="prefill vs decode scan", **info)
    del params
    free_card(torch)
    params, info = init_timed(torch, serve, M, full, dev)
    smoke.emit("serve_ssm", check="init", config=full.name, **info)
    check(info["n_params"] == 368_227_840,
          f"mamba2-370m: {info['n_params']} parameters")
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
#: engine on ``STATIC_PROMPT``-token prompts.
SERVE_HYBRID_ARGV = {
    "continuous": ["--full", "--arch", "recurrentgemma-9b", "--requests",
                   "8", "--prompt-len", "1024", "--max-new", "32",
                   "--max-batch", "4", "--conv-policy", "pallas"],
    "static": ["--full", "--arch", "recurrentgemma-9b", "--requests", "8",
               "--prompt-len", STATIC_PROMPT, "--max-new", "8",
               "--max-batch", "4", "--conv-policy", "pallas"]}
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
    f32 = cfg.param_dtype == "float32"
    want_launches = {k: v for k, v in (("tap_gemm", n_rec * pallas),
                                       ("flash_attention", n_attn * flash),
                                       ("flash_attention_f32",
                                        n_attn * flash * f32))
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


#: moonshot-v1-16b-a3b's training cut: its published widths at 4 layers
#: (the dense one and 3 MoE layers), 2,520,664,064 parameters: bf16
#: parameters and grads with float32 AdamW moments take ~30 GB, where the
#: 48 layers' moments alone take 227 GB (ROADMAP A13).
LM_TRAIN_MOE_LAYERS = 4
LM_TRAIN_MOE_PARAMS = 2_520_664_064
LM_TRAIN_MOE_STEPS = 6
#: the bf16 step's first loss against the same cut's ``loss_fn`` in
#: float32 on the same (bf16-representable) weights and batch, relative.
#: The loss is ~12 (ln 163,840); every activation is rounded to bf16 (2^-8
#: relative) on one side only, and a token whose 6th and 7th router
#: choices are near a tie may take another expert under that rounding.
#: Both should move the mean over 4,096 tokens far less than this (set
#: before the first call on the card; PERF.md, §6, has the reading).
LM_TRAIN_MOE_TOL = 1e-2


def phase_lm_train_moe(smoke, torch, kernels, train, smi, dev) -> dict:
    """moonshot-v1-16b-a3b's train step at its published widths and
    ``LM_TRAIN_MOE_LAYERS`` layers (bf16, seed 0, 8 x 512, the launcher's
    lr, guard and schedule, donated): ``LM_TRAIN_MOE_STEPS`` steps, each
    loss and norm finite and no step dropped, the first loss within
    ``LM_TRAIN_MOE_TOL`` of ``loss_fn`` in float32 on the card (a
    grad-mode forward: dense attention as in training; no backward);
    seconds a step, peak memory and one profiled step's device-busy share.
    No kernel lies on this path: training runs dense attention and
    moonshot has no conv.  Returns the path's launches."""
    import dataclasses

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    from repro_torch.tree import tree_map
    t_phase = time.perf_counter()
    cut = dataclasses.replace(train.get_config("moonshot-v1-16b-a3b"),
                              n_layers=LM_TRAIN_MOE_LAYERS)
    dcfg = DataConfig(seed=0, seq_len=512, global_batch=8, vocab=cut.vocab)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in make_batch(cut, dcfg, step).items()}
               for step in range(LM_TRAIN_MOE_STEPS)]
    params = M.init_params(torch.Generator().manual_seed(0), cut, dev)
    n_params = M.count_params(params)

    # The float32 reference of the first loss, on these weights.
    t0 = time.perf_counter()
    p32 = tree_map(lambda t: t.float().requires_grad_(True), params)
    cfg32 = dataclasses.replace(cut, param_dtype="float32",
                                act_dtype="float32")
    kernels.reset_launch_counts()
    ref_loss = float(TS.loss_fn(p32, batches[0], cfg32)[0])
    ref_launches = kernels.launch_counts()
    del p32
    free_card(torch)
    ref_s = time.perf_counter() - t0

    opt = adamw.init_state(params)
    step_fn = TS.make_train_step(cut, adamw.AdamWConfig(peak_lr=3e-4),
                                 total_steps=LM_TRAIN_MOE_STEPS, warmup=1,
                                 guard=True, donate=True)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    hist = []
    for step, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, b, step)
        loss = float(metrics["loss"])
        hist.append({"loss": loss, "seconds": time.perf_counter() - t0,
                     "grad_norm": float(metrics["grad_norm"]),
                     "moe_lb": float(metrics["moe_lb"]),
                     "guard_bad": float(metrics["guard_bad"])})
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    # One more (donated) step under the profiler, after the counts.
    prof = device_time(torch, lambda: step_fn(params, opt, batches[0], 0))
    del params, opt, metrics
    free_card(torch)
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    secs = [h["seconds"] for h in hist]
    step_s = statistics.median(secs[1:])
    first_err = abs(losses[0] - ref_loss) / abs(ref_loss)
    smoke.emit("lm_train_moe", nvidia_smi=smi, config=cut.name,
               layers=cut.n_layers, n_params=n_params, dtype="bfloat16",
               batch=8, seq=512, steps=len(hist), lr=3e-4,
               median_step_s=step_s, first_step_s=secs[0],
               tokens_per_s=8 * 512 / step_s,
               max_memory_allocated_bytes=peak, history=hist,
               f32_first_loss=ref_loss, f32_seconds=ref_s,
               first_loss_bf16_vs_f32=first_err, tol=LM_TRAIN_MOE_TOL,
               device_time_one_step=prof, launches=launches,
               f32_launches=ref_launches,
               seconds=time.perf_counter() - t_phase)
    check(n_params == LM_TRAIN_MOE_PARAMS,
          f"{n_params} parameters, want {LM_TRAIN_MOE_PARAMS}")
    check(len(hist) == LM_TRAIN_MOE_STEPS
          and all(math.isfinite(x) for x in losses + norms),
          f"non-finite loss or norm: {losses} {norms}")
    check(not any(h["guard_bad"] for h in hist), "the guard dropped a step")
    check(first_err <= LM_TRAIN_MOE_TOL,
          f"first loss {losses[0]} vs float32 {ref_loss}: {first_err} > "
          f"{LM_TRAIN_MOE_TOL}")
    check(not any(launches.values()) and not any(ref_launches.values()),
          f"a kernel launched on the MoE training path: {launches} "
          f"{ref_launches}")
    return {"lm_train_moe": launches}


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


#: ranks of the mesh phase, all on the one card, and their mesh.
MESH_RANKS = 4
MESH_SHAPE = (2, 2)
#: a sharded Table II pass against the same pass unsharded on the card:
#: max |sharded - unsharded| / max |unsharded| (float32; the weight grad
#: sums the shards' partial sums in another order).
MESH_TOL = 1e-5
#: the autoencoder's losses, sharded against unsharded, relative.
MESH_AE_TOL = 1e-4
MESH_AE_STEPS = 5
MESH_LM_STEPS = 3
#: (c) and (d): Mamba2-370M trained on batch blocks against the
#: launcher's unsharded run, relative, at every step: losses, and the
#: gradient norms.  Each rank's masked sum over the global count and its
#: bf16 grads are summed over the batch axes, so the first loss differs
#: only in the order of a float32 sum and the grads by one more bf16
#: rounding.  On the H100 the sound run reads 5.3e-5 on the losses and
#: 1.1e-3 on the norms (the third step's: two bf16 updates apart); a step
#: that keeps each rank's own grads reads 3.5e-4 and 0.30, a conv weight
#: grad counted twice 1.6e-4 and 5.9e-3.  AdamW is scale-free, so the
#: norms are what catch both (PERF.md, §6).
MESH_LM_LOSS_TOL = 5e-4
MESH_LM_GNORM_TOL = 2e-3
#: (d), (f) and (g), the LM runs on ``tp`` blocks (``mesh_lm_blocks``):
#: case -> (arch, the config's cut (``dataclasses.replace`` of the
#: published config; none: whole), global batch of 512-token rows, steps,
#: donated).  (f) is recurrentgemma-9b at its published widths cut to one
#: super-block (rec1, rec2, attn: 2,753,630,208 parameters) at
#: lm_train_hybrid's 4 x 512; (g) DeepSeek-V3 at its published widths cut
#: to one dense MLA layer and its MTP block (3,123,106,816 parameters: an
#: empty MoE stack), at 2 x 512, one row a data rank (at 4 x 512 the 4
#: ranks' peaks would pass ~72 GB of the card's 80); each held to the same
#: cut trained unsharded on the card before the spawn by
#: ``MESH_LM_LOSS_TOL`` / ``MESH_LM_GNORM_TOL``.
MESH_HYBRID_CUT = {"n_layers": 3}
MESH_HYBRID_STEPS = 2
MESH_MLA_CUT = {"n_layers": 1, "first_dense_layers": 1}
MESH_MLA_STEPS = 2
MESH_LM_CASES = {"d": ("mamba2-370m", {}, 8, MESH_LM_STEPS, False),
                 "f": ("recurrentgemma-9b", MESH_HYBRID_CUT, 4,
                       MESH_HYBRID_STEPS, True),
                 "g": ("deepseek-v3-671b", MESH_MLA_CUT, 2, MESH_MLA_STEPS,
                       True)}
#: configs whose plan on an abstract (data 2, model 2) mesh the mesh phase
#: counts on ``meta`` tensors, with no step: arch -> its cut.
MESH_PLAN_COUNTS = {"internvl2-76b": {"n_layers": 8}, "hubert-xlarge": {}}
#: (d)'s and (f)'s depthwise conv channels a rank: Mamba2's 1,024 x
#: channels of its 16 of 32 heads with B and C's 256 whole; the RG-LRU's
#: 2,048 of 4,096.
MESH_LM_CHANNELS = {"d": 1280, "f": 2048}
#: (e): moonshot-v1-16b-a3b at its published widths cut to
#: ``MESH_MOE_LAYERS`` layers (the dense one and one MoE layer,
#: 1,344,940,032 parameters) through ``dist.spmd.sharded_step`` on the 4
#: ranks: policy -> (the sequence of its 8-row batch, its steps).  ``tp``
#: cuts the batch over ``data`` into 2 blocks of 4 x 512 tokens, each 4
#: whole groups of 512 (aligned); ``dp_only`` over (data, model) into 4
#: blocks of 2 x 500, across groups of 800 (partial).  ``dp_only`` gathers
#: every leaf whole, ~30 s a step on 4 ranks sharing the card: one step.
MESH_MOE_LAYERS = 2
MESH_MOE_RUNS = {"tp": (512, 2), "dp_only": (500, 1)}
#: (e) against the unsharded run of the same cut and batch, relative, at
#: every step.  As (d): the first loss differs in the order of float32
#: sums and in bf16 roundings of GEMMs of other row counts; the grads are
#: bf16 partial sums summed over the batch axes (one more rounding), and
#: the second step follows one AdamW update of them.  Beside that, a
#: token whose 6th and 7th router choices are near a tie may take another
#: expert under another rounding, and with it the queue of its group;
#: each such token moves the mean loss by a 4,096th of its own change.
#: The norms get the looser bound: a flip also moves its experts' grads.
MESH_MOE_LOSS_TOL = 5e-4
MESH_MOE_GNORM_TOL = 5e-3
#: (e) step 0: the share of tokens whose expert set, or whose set of kept
#: (slotted) experts, differs from the unsharded run's (near-ties under
#: bf16 roundings only; a queue that read another rank's choices at the
#: wrong offsets would differ on most tokens of its groups).
MESH_MOE_ROUTE_TOL = 0.05
#: (e)'s seconds a step on the H100 when every rank computed with every
#: parameter gathered whole (PERF.md, section 6), beside this run's.
MESH_MOE_WHOLE_STEP_S = "19-35 s a step, both policies, every leaf whole"
#: the conv passes whose batch each rank's dispatch records.
CONV_PASSES = ("forward", "input_grad", "weight_grad")
#: each Table II layer's plan on (data=2, model=2) at batch 2: policy ->
#: per layer (tag, the dropped roles), JAX's planner's outcome.
MESH_TABLE2 = {
    "spatial": (("data", ("h",)), ("data+h", ()), ("data+h", ()),
                ("data+h", ()), ("data", ("h",))),
    "tp": (("data+cout", ()),) * 5,
}


def _mesh_events(conv) -> dict:
    return {k: v for k, v in conv.dispatch_events().items()
            if k.startswith("mesh")}


def _halo_bytes(obs_events) -> int:
    return sum(e["tags"]["bytes"] for e in obs_events.events("halo"))


def mesh_table2(torch, conv, cp, kernels, obs_events, ops, paper_cnn,
                ConvSpec, mesh, dev, rank) -> dict:
    """(a): each Table II layer's three passes sharded against unsharded,
    under ``spatial`` and ``tp``."""
    from repro_torch.dist import tensor_parallel as TP
    out = {}
    launches = {k: 0 for k in kernels.launch_counts()}
    before = dict(TP.COUNTS)
    for policy in MESH_TABLE2:
        for i, (hi, ci, co, k, s, p) in enumerate(paper_cnn.TABLE2_LAYERS):
            gen = torch.Generator().manual_seed(100 + i)
            x = torch.randn(2, ci, hi, hi, generator=gen).to(dev)
            w = (torch.randn(co, ci, k, k, generator=gen)
                 * (ci * k * k) ** -0.5).to(dev)
            spec = ConvSpec.make(stride=s, padding=p)
            ho = (hi + 2 * p - k) // s + 1
            dy = torch.randn(2, co, ho, ho, generator=gen).to(dev)

            def passes():
                xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
                y = conv.conv2d(xg, wg, spec, "pallas")
                dx, dw = torch.autograd.grad(y, (xg, wg), dy)
                return y.detach(), dx, dw
            ref = passes()
            conv.reset_dispatch_events()
            obs_events.reset()
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with cp.conv_mesh(policy, mesh):
                got = passes()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            for name, n in kernels.launch_counts().items():
                launches[name] += n
            errs = {}
            for name, a, b in zip(("y", "dx", "dw"), got, ref):
                check(bool(torch.isfinite(a).all()), f"non-finite {name}")
                errs[name] = ((a - b).abs().max()
                              / b.abs().max().clamp_min(1e-30)).item()
            ev = _mesh_events(conv)
            tags = [key.split(":", 2)[2] for key in ev
                    if key.startswith("mesh:conv2d:")]
            drops = tuple(sorted(key.split(":")[2] for key in ev
                                 if key.startswith("mesh:drop:")))
            (lo, hi_), _ = ops.shard_halo(conv.spec_dims(
                tuple(x.shape), tuple(w.shape), spec))
            want_tag, want_drops = MESH_TABLE2[policy][i]
            rows = max(lo, 0) + max(hi_, 0) if "+h" in want_tag else 0
            want_halo = 3 * rows * (2 // MESH_SHAPE[0]) * ci * hi * 4
            out[f"{policy} {hi}/{ci}/{co}/{k}/{s}/{p}"] = {
                "rel_err": errs, "tag": tags, "drops": drops,
                "halo_bytes": _halo_bytes(obs_events),
                "want_halo_bytes": want_halo, "seconds": secs}
            check(max(errs.values()) <= MESH_TOL,
                  f"rank {rank} {policy} layer {i}: sharded vs unsharded "
                  f"{errs} > {MESH_TOL}")
            check(tags == [want_tag] and drops == want_drops,
                  f"rank {rank} {policy} layer {i}: plan {tags} drops "
                  f"{drops}, want {want_tag} {want_drops}")
            check(_halo_bytes(obs_events) == want_halo,
                  f"rank {rank} {policy} layer {i}: halo bytes "
                  f"{_halo_bytes(obs_events)}, want {want_halo}")
    # No train step: no grad sync, no fold, no model psum (the convs'
    # own psums are the mesh-parallel conv's).
    return {"layers": out, "launches": launches,
            "wire": wire_since(TP, before)}


def mesh_autoencoder(torch, conv, kernels, autoencoder_bp, mesh, dev,
                     rank) -> dict:
    """(b): the autoencoder CLI's loop, sharded under each policy."""
    import hashlib

    from repro_torch.dist import tensor_parallel as TP
    from repro_torch.tree import tree_leaves
    out = {}
    for policy in ("tp", "dp_only", "spatial"):
        conv.reset_dispatch_events()
        kernels.reset_launch_counts()
        before = dict(TP.COUNTS)
        with mesh:
            res = autoencoder_bp.train("pallas", MESH_AE_STEPS, device=dev,
                                       conv_mesh=policy)
        total = wire_since(TP, before)
        # No activation policy: every rank runs the whole batch, and each
        # axis takes coordinate 0's whole grads (``Mesh.broadcast``).
        grad_bytes = sum(t.numel() * t.element_size()
                         for t in tree_leaves(res["params"]))
        want = [0, 0]
        for axis, n in mesh.shape.items():
            if mesh.coordinate(axis) == 0:
                want[0] += (n - 1) * grad_bytes
            else:
                want[1] += grad_bytes
        digest = hashlib.sha256()
        for t in tree_leaves(res["params"]):
            digest.update(t.detach().cpu().numpy().tobytes())
        out[policy] = {"losses": res["mses"], "seconds": res["seconds"],
                       "events": _mesh_events(conv),
                       "launches": kernels.launch_counts(),
                       "params_sha256": digest.hexdigest(),
                       "wire_a_step": {k: v // MESH_AE_STEPS
                                       for k, v in total.items()},
                       "wire_want": {"sync": want, "fold": [0, 0]}}
        check(all(v % MESH_AE_STEPS == 0 for v in total.values()),
              f"rank {rank} autoencoder {policy}: {total} bytes over "
              f"{MESH_AE_STEPS} steps")
    return out


def _conv_rows(conv) -> list[int]:
    """The batch of every conv pass this rank dispatched."""
    return sorted({p["dims"][0] for p in conv.policy_decisions()
                   if p["pass"] in CONV_PASSES})


@contextlib.contextmanager
def dw_calls(torch):
    """Every depthwise causal conv the Mamba2 and RG-LRU layers call in
    the ``with`` body: the channels of each call and the first call's
    operands (input and weight, detached copies)."""
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import recurrent as R
    sound = M2.depthwise_causal_conv1d
    seen = {"channels": set(), "first": None}

    def recorded(x, w, policy=None, **kw):
        seen["channels"].add(int(x.shape[-1]))
        if seen["first"] is None:
            seen["first"] = (x.detach().clone(), w.detach().clone())
        return sound(x, w, policy, **kw)
    M2.depthwise_causal_conv1d = R.depthwise_causal_conv1d = recorded
    try:
        yield seen
    finally:
        M2.depthwise_causal_conv1d = R.depthwise_causal_conv1d = sound


def dw_block_check(torch, x, w, dev) -> dict:
    """One launch of each of the three ``dw`` tap kernels on a rank's own
    conv operands (``x`` (B, L, C) and ``w`` (K, C), its batch and channel
    block; the output grad drawn from a seed), each against its plain
    version (``kernels/ref.py``): max |kernel - plain| / max |plain| and
    max |kernel - plain|, the variant launched, the tolerance
    (``BF16_TOL`` for the bf16 forward and input grad, ``REL_TOL`` for the
    float32 weight grad, as in the kernels phase)."""
    from repro_torch.core.im2col_ref import ConvDims
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tap_gemm as tg
    b, length, c = x.shape
    d = mamba2_conv_dims(ConvDims, b, length)
    x4 = x.transpose(1, 2)[:, :, None, :].contiguous()     # (B, C, 1, L)
    w4 = w.T[:, None, None, :].contiguous()                # (C, 1, 1, K)
    gen = torch.Generator().manual_seed(700)
    dy = torch.randn(b, c, 1, length, generator=gen).to(dev, x.dtype)
    src, wt, taps = ops.forward_operands(x4, w4, d, c)
    gsrc, ws, pp = ops.input_grad_operands(dy, w4, d, c)
    wsrc, dyn, wtaps = ops.weight_grad_operands(x4, dy, d, c)
    calls = {
        "tap_gemm": (lambda: tg.tap_gemm(src, wt, taps, d.H_o, d.W_o),
                     lambda: ref.tap_gemm_ref(src, wt, taps, d.H_o, d.W_o)),
        "tap_gemm_phased": (
            lambda: tg.tap_gemm_phased(gsrc, ws, pp.phase_taps, pp.n_qh,
                                       pp.n_qw),
            lambda: ref.tap_gemm_phased_ref(gsrc, ws, pp.phase_taps,
                                            pp.n_qh, pp.n_qw)),
        "tap_wgrad": (lambda: tg.tap_wgrad(wsrc, dyn, wtaps, d.H_o, d.W_o),
                      lambda: ref.tap_wgrad_ref(wsrc, dyn, wtaps, d.H_o,
                                                d.W_o))}
    out = {"shape": [b, length, c], "dtype": str(x.dtype).split(".")[-1]}
    for name, (kern, plain) in calls.items():
        tg.reset_launch_counts()
        got = kern()
        variants = tg.variant_launch_counts()
        want = plain()
        torch.cuda.synchronize()
        err, abs_err = rel_err(torch, got, want)
        tol = REL_TOL if name == "tap_wgrad" else BF16_TOL
        out[name] = {"max_rel_err": err, "max_abs_err": abs_err, "tol": tol,
                     "variants": variants}
        check(variants == {f"{name}:{tg.DW}": 1},
              f"{name} at the rank's block {out['shape']}: launched "
              f"{variants}")
        check(err <= tol, f"{name} at the rank's block {out['shape']}: "
                          f"relative error {err} > {tol}")
    return out


#: what ``tensor_parallel.COUNTS`` holds of the bytes a rank sends and
#: receives in the grad sync, the model psums and the folds (and the
#: bytes the model psums summed).
WIRE_KEYS = ("scatter_bytes", "scatter_received", "psum_sent",
             "psum_received", "psum_bytes", "fold_bytes", "fold_received")


def wire_since(TP, before: dict) -> dict:
    """The ``WIRE_KEYS`` counts since ``before`` (a copy of ``COUNTS``)."""
    return {k: TP.COUNTS[k] - before[k] for k in WIRE_KEYS}


def _axis_dim(spec, axis: str):
    return next((d for d, e in enumerate(spec) if e == axis), None)


def want_sync_bytes(plan, params, coord: dict, batch_axes) -> list[int]:
    """``[sent, received]`` of one rank's grad sync a step, worked out
    from the plan and the specs (``train_step._sync_blocks``): along each
    batch axis of n ranks a leaf its spec cuts there sends n - 1 of its n
    blocks and receives n - 1 parts of its own, the rest of a dtype go
    through one flat buffer padded to n shares, scattered then gathered;
    along each other axis, coordinate 0 sends each member its block of
    each leaf not kept on its ``model`` block (the whole of one the spec
    does not cut there), which the member receives.  A kept leaf's grad
    enters as its ``model`` block."""
    from repro_torch.tree import tree_leaves
    shape = dict(plan.mesh.shape)
    m = shape.get("model", 1)
    cur = [[p.numel() // (m if k else 1), p.element_size(), p.dtype, s, k]
           for p, s, k in zip(tree_leaves(params),
                              tree_leaves(plan.compute_specs), plan.kept)]
    sent = received = 0
    for axis in batch_axes:
        n, whole = shape[axis], {}
        for c in cur:
            if _axis_dim(c[3], axis) is not None:
                sent += (n - 1) * (c[0] // n) * c[1]
                received += (n - 1) * (c[0] // n) * c[1]
                c[0] //= n
            else:
                whole.setdefault(c[2], [0, c[1]])[0] += c[0]
        for elems, es in whole.values():
            share = -(-elems // n) * es
            sent += 2 * (n - 1) * share
            received += 2 * (n - 1) * share
    for axis, n in shape.items():
        if n == 1 or axis in batch_axes:
            continue
        for c in cur:
            if c[4] and axis == "model":
                continue
            cut = _axis_dim(c[3], axis) is not None
            b = c[0] // (n if cut else 1) * c[1]
            if coord[axis] == 0:
                sent += (n - 1) * b
            else:
                received += b
            if cut:
                c[0] //= n
    return [sent, received]


def want_fold_bytes(plan, params, coord: dict) -> list[int]:
    """``[sent, received]`` of one rank's fold a step, element by element:
    an own range of a taken leaf comes from the ``model`` rank whose units
    it holds, a shared range from coordinate 0, and each element goes to
    the rank whose stored block holds it, when that is another rank."""
    from repro_torch.tree import tree_leaves
    m = dict(plan.mesh.shape).get("model", 1)
    me = coord["model"]
    sent = received = 0
    for p, s, leaf in zip(tree_leaves(params), tree_leaves(plan.specs),
                          tree_leaves(plan.tree)):
        if leaf.take is None:
            continue
        dt, db = leaf.take.dim % p.dim(), _axis_dim(s, "model")
        src = []
        for width, own in leaf.take.parts:
            src += [i * m // width if own else 0 for i in range(width)]
        per = p.numel() // p.shape[dt] * p.element_size()
        if dt == db:
            owner = [x * m // p.shape[dt] for x in range(p.shape[dt])]
            sent += per * sum(a == me != o for a, o in zip(src, owner))
            received += per * sum(o == me != a for a, o in zip(src, owner))
        else:
            mine = sum(a == me for a in src)
            sent += mine * per * (m - 1) // m
            received += (len(src) - mine) * per // m
    return [sent, received]


def check_wire(who: str, wire: list, want: dict) -> None:
    """Each step's grad sync and fold bytes against ``want`` (the plan's
    counts), and its model psums: at ``model`` = 2 a psum sends and
    receives half its tensor in the scatter and half in the gather, so
    each step sends and receives the bytes its psums summed."""
    for step, w in enumerate(wire):
        check([w["scatter_bytes"], w["scatter_received"]] == want["sync"]
              and [w["fold_bytes"], w["fold_received"]] == want["fold"],
              f"{who} step {step}: grad sync {w['scatter_bytes']} / "
              f"{w['scatter_received']}, folds {w['fold_bytes']} / "
              f"{w['fold_received']} bytes sent / received, the plan "
              f"counts {want}")
        check(w["psum_sent"] == w["psum_received"] == w["psum_bytes"],
              f"{who} step {step}: model psums sent {w['psum_sent']} and "
              f"received {w['psum_received']} bytes, summed "
              f"{w['psum_bytes']}")


def mesh_lm_config(case: str):
    """(d)'s, (f)'s or (g)'s config: its published widths, cut as
    ``MESH_LM_CASES`` says."""
    import dataclasses

    from repro_torch.configs import get_config
    arch, cut = MESH_LM_CASES[case][:2]
    return dataclasses.replace(get_config(arch), **cut)


def mesh_lm_blocks(torch, kernels, conv, dev, case: str,
                   mesh=None) -> dict:
    """(d), (f) or (g) (``MESH_LM_CASES``): the model at its published
    widths (cut as the case says), lm_train's batches at the case's batch
    and lr 3e-4, guard on, every conv under ``pallas``, for the case's
    steps.  Unsharded without ``mesh`` (f's and g's reference); else its
    parameters,
    AdamW moments and batch in their ``tp`` blocks on the ranks' mesh
    through ``dist.spmd.sharded_step`` (``conv_mesh="tp"``): the bytes each
    rank holds against the dry run's, the plan of its compute
    (``dist.tensor_parallel``) and its counts of the bytes a step gathers
    and computes with beside each step's, its losses, norms, peak memory
    and seconds a step, its ``dw`` launches and the channels of each conv
    call, the model gathers and psums it made, the gathered parameters'
    digest, and its first conv call's operands (where it has a conv) held
    on the three ``dw`` kernels against their plain versions
    (:func:`dw_block_check`)."""
    import hashlib

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.dist import set_activation_policy
    from repro_torch.dist import sharding as SH
    from repro_torch.dist import tensor_parallel as TP
    from repro_torch.dist.spmd import sharded_step
    from repro_torch.kernels import tap_gemm as tg
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    from repro_torch.tree import tree_leaves, tree_map
    _, _, batch_rows, steps, donate = MESH_LM_CASES[case]
    cfg = mesh_lm_config(case)
    model = M.build_model(cfg)
    dcfg = DataConfig(seed=0, seq_len=512, global_batch=batch_rows,
                      vocab=cfg.vocab)
    step_fn = TS.make_train_step(
        cfg, adamw.AdamWConfig(peak_lr=3e-4), total_steps=steps, warmup=1,
        conv_policy="pallas", conv_mesh=None if mesh is None else "tp",
        guard=TS.GuardConfig(), donate=donate)
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator().manual_seed(0), dev)
    res = {"n_params": M.count_params(params)}
    cut = lambda b: b                                      # noqa: E731
    if mesh is not None:
        # The dry run's count: meta tensors on an abstract mesh.
        meta = model.init(torch.Generator().manual_seed(0), dryrun.META)
        abstract = Mesh(mesh.axis_names, mesh.axis_sizes)
        meta_spec = SH.param_specs(meta, abstract, "tp")
        res["bytes_dryrun"] = {
            "params": dryrun.bytes_per_device(meta, meta_spec, abstract),
            "moments": 2 * dryrun.bytes_per_device(meta, meta_spec,
                                                   abstract, torch.float32)}
        p_spec = SH.param_specs(params, mesh, "tp")
        o_spec = SH.opt_state_specs(params, mesh, "tp")
        params = tree_map(torch.clone, SH.to_local(params, p_spec, mesh))
        free_card(torch)
        set_activation_policy(SH.batch_axes(mesh, "tp"))
        b_spec = SH.batch_specs({k: torch.empty(v.shape) for k, v in
                                 make_batch(cfg, dcfg, 0).items()}, mesh,
                                "tp")
        step_fn = sharded_step(step_fn, mesh, p_spec, o_spec, b_spec)
        cut = lambda b: SH.to_local(b, b_spec, mesh)      # noqa: E731
        plan = step_fn.layout.plan
        res["plan"] = plan.table()
        res["plan_bytes"] = {"computed": plan.held_bytes(meta),
                             "gathered": plan.gathered_bytes(meta)}
        coord = {a: mesh.coordinate(a) for a in mesh.axis_names}
        res["wire_want"] = {
            "sync": want_sync_bytes(plan, meta, coord,
                                    SH.batch_axes(mesh, "tp")),
            "fold": want_fold_bytes(plan, meta, coord)}
    opt = adamw.init_state(params)
    if mesh is not None:
        res["bytes_held"] = {
            "params": sum(t.numel() * t.element_size()
                          for t in tree_leaves(params)),
            "moments": sum(t.numel() * t.element_size()
                           for k in ("m", "v") for t in tree_leaves(opt[k]))}
    init_peak = torch.cuda.max_memory_allocated(dev)
    kernels.reset_launch_counts()
    conv.reset_dispatch_events()
    before = dict(TP.COUNTS)
    hist = {k: [] for k in ("losses", "grad_norms", "step_seconds",
                            "step_peak_bytes", "computed_bytes",
                            "gathered_bytes", "wire")}
    with dw_calls(torch) as seen:
        for step in range(steps):
            torch.cuda.reset_peak_memory_stats(dev)
            step_counts = dict(TP.COUNTS)
            t0 = time.perf_counter()
            batch = {k: v.to(dev) for k, v in cut(
                {k: torch.from_numpy(v)
                 for k, v in make_batch(cfg, dcfg, step).items()}).items()}
            params, opt, metrics = step_fn(params, opt, batch, step)
            hist["losses"].append(float(metrics["loss"]))
            hist["grad_norms"].append(float(metrics["grad_norm"]))
            hist["step_seconds"].append(time.perf_counter() - t0)
            hist["step_peak_bytes"].append(
                torch.cuda.max_memory_allocated(dev))
            if mesh is not None:
                for k in ("computed_bytes", "gathered_bytes"):
                    hist[k].append(step_fn.layout.stats[k])
                hist["wire"].append(wire_since(TP, step_counts))
    res.update(hist, launches=kernels.launch_counts(),
               variants=tg.variant_launch_counts(),
               events=_mesh_events(conv), conv_rows=_conv_rows(conv),
               conv_channels=sorted(seen["channels"]),
               collectives={k: TP.COUNTS[k] - v for k, v in before.items()},
               max_memory_allocated_bytes=max(init_peak,
                                              *hist["step_peak_bytes"]))
    if mesh is not None:
        whole = SH.gather_tree(params, p_spec, mesh)
        digest = hashlib.sha256()
        for t in tree_leaves(whole):
            digest.update(t.detach().cpu().reshape(-1).view(torch.uint8)
                          .numpy().tobytes())
        res["params_sha256"] = digest.hexdigest()
        set_activation_policy(None)
        del whole
    del params, opt, metrics
    free_card(torch)
    if seen["first"] is not None:
        res["dw_block"] = dw_block_check(torch, *seen["first"], dev)
    del seen
    free_card(torch)
    return res


def mesh_moe_run(torch, kernels, dev, seq: int, steps: int, mesh=None,
                 policy=None, out=None) -> dict:
    """(e) one run: moonshot's ``MESH_MOE_LAYERS``-layer cut at 8 x
    ``seq`` (lm_train's batches, lr and schedule; donated, no guard: four
    ranks' blocks, gathered parameters and grads share the card),
    ``steps`` steps: unsharded through ``make_train_step``
    without ``mesh``; else its parameters, AdamW moments and batch in
    their ``policy`` blocks through ``dist.spmd.sharded_step``, with the
    bytes a rank holds against the dry run's and the gathered parameters'
    digest, the plan of its compute (``dist.tensor_parallel``), the bytes
    it computes with in each step against the plan's count, and its peak
    memory over each step.  Step 0's routing (the MoE layer's forward
    call: this rank's first token, its tokens' experts and kept choices,
    the experts its einsums ran) is returned, or saved to ``out`` with its
    path returned."""
    import contextlib
    import dataclasses
    import hashlib

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.dist import set_activation_policy
    from repro_torch.dist import sharding as SH
    from repro_torch.dist import tensor_parallel as TP
    from repro_torch.dist.spmd import sharded_step
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                              n_layers=MESH_MOE_LAYERS)
    dcfg = DataConfig(seed=0, seq_len=seq, global_batch=8, vocab=cfg.vocab)
    model = M.build_model(cfg)
    step_fn = TS.make_train_step(
        cfg, adamw.AdamWConfig(peak_lr=3e-4), total_steps=steps, warmup=1,
        donate=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator().manual_seed(0), dev)
    res = {"n_params": M.count_params(params)}
    cut = lambda b: b                                      # noqa: E731
    if mesh is not None:
        meta = model.init(torch.Generator().manual_seed(0), dryrun.META)
        abstract = Mesh(mesh.axis_names, mesh.axis_sizes)
        meta_spec = SH.param_specs(meta, abstract, policy)
        res["bytes_dryrun"] = {
            "params": dryrun.bytes_per_device(meta, meta_spec, abstract),
            "moments": 2 * dryrun.bytes_per_device(meta, meta_spec,
                                                   abstract, torch.float32)}
        p_spec = SH.param_specs(params, mesh, policy)
        o_spec = SH.opt_state_specs(params, mesh, policy)
        params = tree_map(torch.clone, SH.to_local(params, p_spec, mesh))
        free_card(torch)
        set_activation_policy(SH.batch_axes(mesh, policy))
        b_spec = SH.batch_specs({k: torch.empty(v.shape) for k, v in
                                 make_batch(cfg, dcfg, 0).items()},
                                mesh, policy)
        step_fn = sharded_step(step_fn, mesh, p_spec, o_spec, b_spec)
        cut = lambda b: SH.to_local(b, b_spec, mesh)      # noqa: E731
        plan = step_fn.layout.plan
        res["plan"] = plan.table()
        res["plan_bytes"] = plan.held_bytes(meta)
        coord = {a: mesh.coordinate(a) for a in mesh.axis_names}
        res["wire_want"] = {
            "sync": want_sync_bytes(plan, meta, coord,
                                    SH.batch_axes(mesh, policy)),
            "fold": want_fold_bytes(plan, meta, coord)}
    opt = adamw.init_state(params)
    if mesh is not None:
        res["bytes_held"] = {
            "params": sum(t.numel() * t.element_size()
                          for t in tree_leaves(params)),
            "moments": sum(t.numel() * t.element_size()
                           for k in ("m", "v") for t in tree_leaves(opt[k]))}
    kernels.reset_launch_counts()
    losses, norms, secs, peaks, gathered, wire = [], [], [], [], [], []
    # The peak of the init and cut; then each step's own.
    init_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    for step in range(steps):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        step_counts = dict(TP.COUNTS)
        t0 = time.perf_counter()
        batch = {k: v.to(dev) for k, v in cut(
            {k: torch.from_numpy(v)
             for k, v in make_batch(cfg, dcfg, step).items()}).items()}
        with MOE.recording() if step == 0 else \
                contextlib.nullcontext() as log:
            params, opt, metrics = step_fn(params, opt, batch, step)
        if step == 0:
            route = {k: v.cpu() if torch.is_tensor(v) else v
                     for k, v in log[0].items()}
            res["rows"] = batch["tokens"].shape[0]
            res["experts_computed"] = sorted({r["experts_computed"]
                                              for r in log})
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        secs.append(time.perf_counter() - t0)
        if dev.type == "cuda":
            peaks.append(torch.cuda.max_memory_allocated(dev))
        if mesh is not None:
            gathered.append(step_fn.layout.stats["gathered_bytes"])
            wire.append(wire_since(TP, step_counts))
    res.update(losses=losses, grad_norms=norms, step_seconds=secs,
               step_peak_bytes=peaks, launches=kernels.launch_counts())
    if mesh is not None:
        res["gathered_bytes"] = gathered
        res["wire"] = wire
    if dev.type == "cuda":
        res["max_memory_allocated_bytes"] = max(init_peak, *peaks)
    if mesh is not None:
        whole = SH.gather_tree(params, p_spec, mesh)
        digest = hashlib.sha256()
        for t in tree_leaves(whole):
            digest.update(t.detach().cpu().reshape(-1).view(torch.uint8)
                          .numpy().tobytes())
        res["params_sha256"] = digest.hexdigest()
        set_activation_policy(None)
        del whole
    if out is not None:
        torch.save(route, out)
        res["route"] = str(out)
    else:
        res["route"] = route
    del params, opt, metrics
    free_card(torch)
    return res


def route_diffs(torch, ref: dict, got: dict) -> dict:
    """Of ``got``'s tokens (from its first index on), how many take
    another set of experts than in ``ref`` (the unsharded run's whole
    batch), and how many another set of kept (slotted) experts."""
    first, n = got["first"], got["experts"].shape[0]

    def sets(r, lo):
        e = r["experts"][lo:lo + n]
        kept = torch.where(r["kept"][lo:lo + n], e, -1)
        return e.sort(-1).values, kept.sort(-1).values
    want_e, want_k = sets(ref, first)
    got_e, got_k = sets(got, 0)
    return {"tokens": n,
            "experts_differ": int((want_e != got_e).any(-1).sum()),
            "kept_differ": int((want_k != got_k).any(-1).sum()),
            "dropped": int((~got["kept"]).sum()),
            "dropped_unsharded": int((~ref["kept"][first:first + n]).sum())}


def mesh_rank(rank: int, out_dir: str) -> None:
    """One rank of the mesh phase's (a), (b), (d), (e), (f) and (g)
    (``torch.multiprocessing`` spawn target): writes
    ``out_dir/rank<r>.json`` (and (e)'s routing beside it).  A failed check
    raises, which fails the spawn and the run."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import paper_cnn
    from repro_torch.core import conv
    from repro_torch.core.config import config
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.dist import conv_parallel as cp
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as LM
    from repro_torch.obs import events as obs_events
    from repro_torch.train import autoencoder_bp
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = LM.init_distributed(
        "cuda", init_method="file://" + str(pathlib.Path(out_dir) / "pg"),
        rank=rank, world_size=MESH_RANKS, local_world=MESH_RANKS)
    config.update(autotune="off", plan_cache_dir=None, telemetry=True)
    mesh = LM.make_mesh(MESH_SHAPE, ("data", "model"))
    t0 = time.perf_counter()
    res = {"rank": rank, "backend": mesh.backend, "device": str(dev),
           "coordinate": {a: mesh.coordinate(a) for a in mesh.axis_names}}
    res["table2"] = mesh_table2(torch, conv, cp, kernels, obs_events, ops,
                                paper_cnn, ConvSpec, mesh, dev, rank)
    res["autoencoder"] = mesh_autoencoder(torch, conv, kernels,
                                          autoencoder_bp, mesh, dev, rank)
    t1 = time.perf_counter()
    res["lm_blocks"] = mesh_lm_blocks(torch, kernels, conv, dev, "d", mesh)
    res["lm_blocks"]["seconds"] = time.perf_counter() - t1
    res["moe"] = {}
    for policy, (seq, steps) in MESH_MOE_RUNS.items():
        t1 = time.perf_counter()
        res["moe"][policy] = mesh_moe_run(
            torch, kernels, dev, seq, steps, mesh, policy,
            pathlib.Path(out_dir) / f"route_{policy}_rank{rank}.pt")
        res["moe"][policy]["seconds"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    res["hybrid"] = mesh_lm_blocks(torch, kernels, conv, dev, "f", mesh)
    res["hybrid"]["seconds"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    res["mla"] = mesh_lm_blocks(torch, kernels, conv, dev, "g", mesh)
    res["mla"]["seconds"] = time.perf_counter() - t1
    res["seconds"] = time.perf_counter() - t0
    (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    mesh.barrier()
    LM.shutdown()


def launcher_rank(out_dir: str, argv: list[str]) -> None:
    """One rank of the mesh phase's (c), started by
    ``torch.distributed.run``: the training launcher (which starts the
    process group from the environment), then this rank's losses,
    gradient norms, launches and ``mesh:*`` events into
    ``out_dir/rank<r>.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.core import conv
    from repro_torch.kernels import tap_gemm as tg
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import train
    kernels.reset_launch_counts()
    conv.reset_dispatch_events()
    hist: list = []
    t0 = time.perf_counter()
    losses = train.main(argv, history=hist)
    res = {"rank": LM.rank(), "losses": losses,
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_seconds": [h["seconds"] for h in hist],
           "launches": kernels.launch_counts(),
           "variants": tg.variant_launch_counts(),
           "events": _mesh_events(conv), "conv_rows": _conv_rows(conv),
           "seconds": time.perf_counter() - t0}
    (pathlib.Path(out_dir) / f"rank{res['rank']}.json").write_text(
        json.dumps(res))
    LM.shutdown()


def phase_mesh(smoke, torch, kernels, autoencoder_bp, train, smi, dev):
    """The ``mesh`` phase (module docstring, 26).  Returns each rank's
    launches per part as paths."""
    import os
    import tempfile

    from repro_torch.core import conv

    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    paths = {}
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="mesh_", dir=ROOT / "build"))
    # The unsharded autoencoder runs on this process, the card's kernels
    # built already; the ranks load the same libraries.
    ae_ref = autoencoder_bp.train("pallas", MESH_AE_STEPS, device=dev)["mses"]
    # (e)'s unsharded runs, one a batch shape.
    t0 = time.perf_counter()
    moe_ref = {policy: mesh_moe_run(torch, kernels, dev, seq, steps)
               for policy, (seq, steps) in MESH_MOE_RUNS.items()}
    moe_ref_s = time.perf_counter() - t0
    for policy in MESH_MOE_RUNS:
        paths[f"mesh moe {policy} unsharded"] = moe_ref[policy]["launches"]
    # (f)'s unsharded run.
    t0 = time.perf_counter()
    hybrid_ref = mesh_lm_blocks(torch, kernels, conv, dev, "f")
    hybrid_ref["seconds"] = time.perf_counter() - t0
    paths["mesh hybrid unsharded"] = hybrid_ref["launches"]
    # (g)'s unsharded run.
    t0 = time.perf_counter()
    mla_ref = mesh_lm_blocks(torch, kernels, conv, dev, "g")
    mla_ref["seconds"] = time.perf_counter() - t0
    paths["mesh mla unsharded"] = mla_ref["launches"]
    held = {"allocated": torch.cuda.memory_allocated(dev),
            "reserved": torch.cuda.memory_reserved(dev)}
    # Four processes share the card: each rank's allocator maps segments
    # as it grows, so that blocks one rank caches stay usable by the rest.
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        mp.spawn(mesh_rank, args=(str(work),), nprocs=MESH_RANKS)
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    spawn_s = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(MESH_RANKS)]
    for r in ranks:
        smoke.emit("mesh_rank", rank=r["rank"], backend=r["backend"],
                   device=r["device"], coordinate=r["coordinate"],
                   table2=r["table2"]["layers"],
                   table2_launches=r["table2"]["launches"],
                   table2_wire=r["table2"]["wire"],
                   autoencoder={k: {kk: vv for kk, vv in v.items()
                                    if kk != "params_sha256"}
                                for k, v in r["autoencoder"].items()},
                   lm_blocks=r["lm_blocks"], hybrid=r["hybrid"],
                   mla=r["mla"],
                   moe={p: {k: v for k, v in m.items() if k != "route"}
                        for p, m in r["moe"].items()},
                   seconds=r["seconds"],
                   seconds_note="4 processes sharing one card: not a speed")
        paths[f"mesh table2 rank{r['rank']}"] = r["table2"]["launches"]
        for policy, m in r["moe"].items():
            paths[f"mesh moe {policy} rank{r['rank']}"] = m["launches"]
        for policy, a in r["autoencoder"].items():
            paths[f"mesh autoencoder {policy} rank{r['rank']}"] = \
                a["launches"]
        paths[f"mesh lm_blocks rank{r['rank']}"] = r["lm_blocks"]["launches"]
        paths[f"mesh hybrid rank{r['rank']}"] = r["hybrid"]["launches"]
        paths[f"mesh mla rank{r['rank']}"] = r["mla"]["launches"]
    for r in ranks:
        check(r["backend"] == "gloo", f"rank {r['rank']}: {r['backend']}")
        check(not any(r["table2"]["wire"].values()),
              f"rank {r['rank']} Table II: grad sync, model psum or fold "
              f"bytes {r['table2']['wire']}, want none")
        for policy, a in r["autoencoder"].items():
            check_wire(f"rank {r['rank']} autoencoder {policy}",
                       [a["wire_a_step"]], a["wire_want"])
        check(all(r["table2"]["launches"][k] > 0 for k in TAP_KERNELS),
              f"rank {r['rank']} Table II launches "
              f"{r['table2']['launches']}")
        for policy, a in r["autoencoder"].items():
            err = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                          ae_ref))
            check(len(a["losses"]) == MESH_AE_STEPS
                  and err <= MESH_AE_TOL,
                  f"rank {r['rank']} autoencoder {policy}: losses "
                  f"{a['losses']} vs unsharded {ae_ref} ({err})")
            check(all(a["launches"][k] > 0 for k in TAP_KERNELS),
                  f"rank {r['rank']} autoencoder {policy} launches "
                  f"{a['launches']}")
            check(any(k.startswith("mesh:conv2d") for k in a["events"]),
                  f"rank {r['rank']} autoencoder {policy}: no sharded conv "
                  f"{a['events']}")
    for policy in ("tp", "dp_only", "spatial"):
        digests = {r["autoencoder"][policy]["params_sha256"] for r in ranks}
        check(len(digests) == 1,
              f"autoencoder {policy}: parameters differ across ranks")
    check(ranks[0]["autoencoder"]["tp"]["events"].get("mesh:drop:cout"),
          "tp did not drop the decoder's Cout 3")

    # (c) Mamba2-370M through the launcher on 2 ranks, against unsharded.
    argv = [a for a in LM_TRAIN_SSM_ARGV] + ["--conv-policy", "pallas"]
    argv[argv.index("--steps") + 1] = str(MESH_LM_STEPS)
    kernels.reset_launch_counts()
    hist: list = []
    ref = train.main(argv, history=hist)
    paths["mesh lm unsharded"] = kernels.launch_counts()
    free_card(torch)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(ROOT / "chip_smoke.py"),
         "--launcher-rank", str(work), "--", *argv, "--conv-mesh",
         "dp_only"], capture_output=True, text=True, env=env, timeout=600)
    lm_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"launcher under torch.distributed.run failed "
          f"({proc.returncode}): {proc.stderr[-4000:]}")
    lm = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
    for r in lm:
        smoke.emit("mesh_lm_rank", rank=r["rank"], losses=r["losses"],
                   grad_norms=r["grad_norms"], launches=r["launches"],
                   variants=r["variants"], conv_rows=r["conv_rows"],
                   events=r["events"], step_seconds=r["step_seconds"],
                   seconds=r["seconds"],
                   seconds_note="2 processes sharing one card: not a speed")
        paths[f"mesh lm rank{r['rank']}"] = r["launches"]
    ref_norms = [h["grad_norm"] for h in hist]

    def rel(got, want):
        return max(abs(a - b) / abs(b) for a, b in zip(got, want))
    lm_err = {"loss": rel(lm[0]["losses"], ref),
              "grad_norm": rel(lm[0]["grad_norms"], ref_norms)}
    blk = [r["lm_blocks"] for r in ranks]
    blk_err = {"loss": max(rel(b["losses"], ref) for b in blk),
               "grad_norm": max(rel(b["grad_norms"], ref_norms)
                                for b in blk)}
    smoke.emit("mesh", nvidia_smi=smi, ranks=MESH_RANKS,
               mesh=dict(zip(("data", "model"), MESH_SHAPE)),
               backend="gloo (host-staged)", table2_tol=MESH_TOL,
               table2_max_rel_err=max(
                   max(v["rel_err"].values()) for r in ranks
                   for v in r["table2"]["layers"].values()),
               autoencoder_unsharded=ae_ref, autoencoder_tol=MESH_AE_TOL,
               lm_config="mamba2-370m", lm_losses_unsharded=ref,
               lm_grad_norms_unsharded=[h["grad_norm"] for h in hist],
               lm_losses_sharded=[r["losses"] for r in lm],
               lm_rel_err=lm_err, lm_loss_tol=MESH_LM_LOSS_TOL,
               lm_grad_norm_tol=MESH_LM_GNORM_TOL,
               lm_step_seconds=statistics.median(
                   s for r in lm for s in r["step_seconds"][1:]),
               lm_blocks_losses=[b["losses"] for b in blk],
               lm_blocks_rel_err=blk_err,
               lm_blocks_step_seconds=statistics.median(
                   s for b in blk for s in b["step_seconds"][1:]),
               lm_blocks_bytes=[b["bytes_held"] for b in blk],
               lm_blocks_bytes_dryrun=blk[0]["bytes_dryrun"],
               table2_wire=[r["table2"]["wire"] for r in ranks],
               autoencoder_wire={p: [r["autoencoder"][p]["wire_a_step"]
                                     for r in ranks]
                                 for p in ("tp", "dp_only", "spatial")},
               autoencoder_wire_want={
                   p: [r["autoencoder"][p]["wire_want"] for r in ranks]
                   for p in ("tp", "dp_only", "spatial")},
               lm_stdout_tail=proc.stdout[-1500:], spawn_seconds=spawn_s,
               parent_card_bytes_at_spawn=held,
               lm_seconds=lm_s, seconds=time.perf_counter() - t_phase)
    for who, r in [(f"launcher rank {r['rank']}", r) for r in lm] + [
            (f"blocks rank {r['rank']}", r["lm_blocks"]) for r in ranks]:
        check(len(r["losses"]) == MESH_LM_STEPS
              and all(math.isfinite(x) for x in r["losses"]),
              f"{who}: losses {r['losses']}")
        check(all(r["launches"][k] > 0 for k in TAP_KERNELS)
              and all(k.endswith(":dw") for k in r["variants"]),
              f"{who}: launches {r['launches']} {r['variants']}")
        check(r["conv_rows"] == [4],
              f"{who}: conv passes on batches {r['conv_rows']}, want 4")
    for r in lm:
        check(set(r["events"]) == {"mesh:conv2d:data"},
              f"launcher rank {r['rank']}: events {r['events']}")
    check(lm[0]["losses"] == lm[1]["losses"],
          f"the ranks' losses differ: {lm[0]['losses']} {lm[1]['losses']}")
    phase_mesh_moe(smoke, torch, smi, ranks, moe_ref, moe_ref_s)
    check(lm_err["loss"] <= MESH_LM_LOSS_TOL
          and lm_err["grad_norm"] <= MESH_LM_GNORM_TOL,
          f"launcher vs unsharded: {lm_err} (tol {MESH_LM_LOSS_TOL}, "
          f"{MESH_LM_GNORM_TOL})")
    phase_mesh_lm(smoke, torch, smi, [r["lm_blocks"] for r in ranks], "d",
                  {"losses": ref, "grad_norms": ref_norms})
    phase_mesh_lm(smoke, torch, smi, [r["hybrid"] for r in ranks], "f",
                  hybrid_ref)
    phase_mesh_lm(smoke, torch, smi, [r["mla"] for r in ranks], "g", mla_ref)
    mesh_plan_counts(smoke, torch)
    return paths


#: (d)'s, (f)'s and (g)'s leaves that compute on their ``model`` block
#: (path patterns of ``Plan.table``), and those gathered whole whose spec
#: cuts them over model, by the plan's reason (any other leaf: its spec
#: does not cut it over model).  No leaf's reason may read "not ported".
MESH_LM_PLANS = {
    "d": (("embed.w", "blocks.ssm.*"),
          {"blocks.ln.scale": "no rule"}),
    "f": (("embed.w", "lm_head.w", "*.rec.*", "*.mlp.w?.w",
           "super.attn.attn.wq.w", "super.attn.attn.wo.w"),
          {"super.attn.attn.w[kv].w": "K and V computed whole",
           "*.ln?.scale": "no rule"}),
    "g": (("embed.w", "lm_head.w", "*.attn.wq_b.w", "*.attn.wkv_b.w",
           "*.attn.wo.w", "*.mlp.w?.w", "blocks_moe.moe.w?.w",
           "blocks_moe.moe.shared.w?.w", "mtp.proj.w"),
          {"*.attn.w*_a.w": "a latent's columns, not heads",
           "*.router.w": "the router", "*.attn.*_norm.scale": "no rule",
           "*.ln?.scale": "no rule"})}


def _plan_mismatches(plan: dict, case: str) -> list:
    """The leaves of ``plan`` (``Plan.table``) that ``MESH_LM_PLANS[case]``
    does not expect."""
    import fnmatch
    kept, whole = MESH_LM_PLANS[case]
    bad = []
    for path, (keep, why) in plan.items():
        want_keep = any(fnmatch.fnmatch(path, p) for p in kept)
        want_why = next((v for p, v in whole.items()
                         if fnmatch.fnmatch(path, p)),
                        "its spec does not cut it over model")
        if keep != want_keep or "not ported" in why or not (
                keep or want_why in why):
            bad.append((path, keep, why))
    return bad


def phase_mesh_lm(smoke, torch, smi, runs, case: str, ref: dict) -> None:
    """(d)'s, (f)'s or (g)'s lines and checks: each rank's run on ``tp``
    blocks (``mesh_lm_blocks``) against the unsharded one (``ref``: its
    losses and norms); (d)'s and (f)'s conv passes, and every rank's
    first conv operands on the ``dw`` kernels against their plain
    versions on a line of their own; (g)'s ``model_flops`` a step."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M

    def rel(got, want):
        return max(abs(a - b) / abs(b) for a, b in zip(got, want))
    arch, _, rows, steps, _ = MESH_LM_CASES[case]
    err = {"loss": max(rel(b["losses"], ref["losses"]) for b in runs),
           "grad_norm": max(rel(b["grad_norms"], ref["grad_norms"])
                            for b in runs)}
    cfg = mesh_lm_config(case)
    has_conv = case in MESH_LM_CHANNELS
    # Each conv layer's forward twice a step (remat), its grads once.
    conv_layers = hybrid_layers(cfg)[0] if case == "f" else cfg.n_layers
    per_step = {"tap_gemm": 2, "tap_gemm_phased": 1, "tap_wgrad": 1}
    # The RG-LRU's gathers (each layer's forward twice a step); the MTP
    # head's join (once a step, outside the blocks' remat).
    gathers = {"d": 0, "f": 2 * conv_layers * steps, "g": steps}[case]
    flops = dryrun.model_flops(
        cfg, ShapeCfg(f"mesh_{case}", 512, rows, "train"),
        M.build_model(cfg).init(torch.Generator().manual_seed(0),
                                dryrun.META))
    smoke.emit("mesh_lm_blocks", nvidia_smi=smi, case=case, config=arch,
               cut=MESH_LM_CASES[case][1], layers=cfg.n_layers,
               n_params=runs[0]["n_params"], batch=rows, seq=512,
               rows_a_rank=rows // MESH_SHAPE[0], steps=steps,
               plan=runs[0]["plan"], plan_bytes=runs[0]["plan_bytes"],
               computed_bytes=[b["computed_bytes"] for b in runs],
               gathered_bytes=[b["gathered_bytes"] for b in runs],
               bytes_held=[b["bytes_held"] for b in runs],
               bytes_dryrun=runs[0]["bytes_dryrun"],
               losses_unsharded=ref["losses"],
               grad_norms_unsharded=ref["grad_norms"],
               losses=[b["losses"] for b in runs],
               grad_norms=[b["grad_norms"] for b in runs], rel_err=err,
               loss_tol=MESH_LM_LOSS_TOL, grad_norm_tol=MESH_LM_GNORM_TOL,
               model_flops_a_step=flops,
               step_seconds=[b["step_seconds"] for b in runs],
               step_seconds_unsharded=ref.get("step_seconds"),
               step_peak_bytes=[b["step_peak_bytes"] for b in runs],
               max_memory_allocated_bytes=[
                   b["max_memory_allocated_bytes"] for b in runs],
               max_memory_allocated_unsharded=ref.get(
                   "max_memory_allocated_bytes"),
               launches=[b["launches"] for b in runs],
               variants=[b["variants"] for b in runs],
               conv_channels=[b["conv_channels"] for b in runs],
               conv_rows=[b["conv_rows"] for b in runs],
               events=[b["events"] for b in runs],
               collectives=[b["collectives"] for b in runs],
               wire_a_step=[b["wire"] for b in runs],
               wire_want=[b["wire_want"] for b in runs],
               seconds=[b["seconds"] for b in runs],
               unsharded_seconds=ref.get("seconds"),
               seconds_note="4 processes sharing one card: not a speed")
    if has_conv:
        smoke.emit("mesh_dw_block", nvidia_smi=smi, case=case, config=arch,
                   ranks=[b["dw_block"] for b in runs])
    for rank, b in enumerate(runs):
        who = f"({case}) {arch} rank {rank}"
        check(len(b["losses"]) == steps
              and all(math.isfinite(x) for x in b["losses"]),
              f"{who}: losses {b['losses']}")
        check(b["bytes_held"] == b["bytes_dryrun"],
              f"{who}: holds {b['bytes_held']}, the dry run counts "
              f"{b['bytes_dryrun']}")
        check(b["computed_bytes"] == [b["plan_bytes"]["computed"]] * steps
              and b["gathered_bytes"]
              == [b["plan_bytes"]["gathered"]] * steps,
              f"{who}: computed with {b['computed_bytes']} and gathered "
              f"{b['gathered_bytes']} bytes a step, the plan counts "
              f"{b['plan_bytes']}")
        bad = _plan_mismatches(b["plan"], case)
        check(not bad, f"{who}: plan leaves off their rule: {bad}")
        check_wire(who, b["wire"], b["wire_want"])
        check(b["collectives"]["gathers"] == gathers,
              f"{who}: {b['collectives']}, want {gathers} gathers")
        if not has_conv:
            check(not any(b["launches"].values()),
                  f"{who}: a kernel launched while training: "
                  f"{b['launches']}")
            continue
        want = {k: n * conv_layers * steps for k, n in per_step.items()}
        check({k: b["launches"][k] for k in TAP_KERNELS} == want
              and set(b["variants"]) == {f"{k}:dw" for k in TAP_KERNELS},
              f"{who}: launches {b['launches']} {b['variants']}, want "
              f"{want} on dw")
        check(b["conv_rows"] == [rows // MESH_SHAPE[0]]
              and b["conv_channels"] == [MESH_LM_CHANNELS[case]],
              f"{who}: conv passes on batches {b['conv_rows']} and "
              f"channels {b['conv_channels']}")
        check(set(b["events"]) == {"mesh:conv2d:data", "mesh:drop:cout"},
              f"{who}: events {b['events']}: the conv hook cut the block "
              f"again or fell back")
    check(len({tuple(b["losses"]) for b in runs}) == 1
          and len({b["params_sha256"] for b in runs}) == 1,
          f"({case}) the ranks' losses or gathered parameters differ")
    check(err["loss"] <= MESH_LM_LOSS_TOL
          and err["grad_norm"] <= MESH_LM_GNORM_TOL,
          f"({case}) blocks vs unsharded: {err} (tol {MESH_LM_LOSS_TOL}, "
          f"{MESH_LM_GNORM_TOL})")


def mesh_plan_counts(smoke, torch) -> None:
    """The plans of ``MESH_PLAN_COUNTS``' configs under ``tp`` on an
    abstract (data 2, model 2) mesh, counted on ``meta`` tensors with no
    step: parameters, the bytes a rank computes with and gathers, the dry
    run's bytes a device, and the leaves gathered whole whose spec cuts
    them over model, with their reasons.  ``frontend_proj`` must be kept
    and no reason read "not ported"."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as SH
    from repro_torch.dist import tensor_parallel as TP
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as M
    mesh = Mesh(("data", "model"), MESH_SHAPE)
    for arch, cut in MESH_PLAN_COUNTS.items():
        cfg = dataclasses.replace(get_config(arch), **cut)
        meta = M.build_model(cfg).init(torch.Generator().manual_seed(0),
                                       dryrun.META)
        spec = SH.param_specs(meta, mesh, "tp")
        tp_plan = TP.plan(spec, cfg, mesh)
        plan = tp_plan.table()
        whole = {k: why for k, (keep, why) in plan.items()
                 if not keep and "does not cut" not in why}
        smoke.emit("mesh_plan_counts", config=arch, cut=cut,
                   n_params=M.count_params(meta),
                   computed_bytes=tp_plan.held_bytes(meta),
                   gathered_bytes=tp_plan.gathered_bytes(meta),
                   bytes_dryrun={
                       "params": dryrun.bytes_per_device(meta, spec, mesh),
                       "moments": 2 * dryrun.bytes_per_device(
                           meta, spec, mesh, torch.float32)},
                   frontend_proj=plan["frontend_proj.w"], whole=whole)
        check(plan["frontend_proj.w"][0]
              and not any("not ported" in why for _, why in plan.values()),
              f"{arch}: plan {plan}")


def phase_mesh_moe(smoke, torch, smi, ranks, ref, ref_s) -> None:
    """(e)'s line and checks: each policy's ranks against its unsharded
    run (``MESH_MOE_*``)."""
    def rel(got, want):
        return max(abs(a - b) / abs(b) for a, b in zip(got, want))
    for policy, (seq, steps) in MESH_MOE_RUNS.items():
        runs = [r["moe"][policy] for r in ranks]
        want = ref[policy]
        err = {"loss": max(rel(m["losses"], want["losses"]) for m in runs),
               "grad_norm": max(rel(m["grad_norms"], want["grad_norms"])
                                for m in runs)}
        routes = [route_diffs(torch, want["route"],
                              torch.load(m["route"])) for m in runs]
        for r, m in zip(ranks, runs):
            smoke.emit("mesh_moe_rank", nvidia_smi=smi, policy=policy,
                       rank=r["rank"], coordinate=r["coordinate"],
                       plan=m["plan"], gathered_bytes=m["gathered_bytes"],
                       plan_bytes=m["plan_bytes"],
                       whole_param_bytes=2 * want["n_params"],
                       experts_computed=m["experts_computed"],
                       wire_a_step=m["wire"], wire_want=m["wire_want"],
                       step_peak_bytes=m["step_peak_bytes"],
                       step_seconds=m["step_seconds"],
                       step_seconds_whole=MESH_MOE_WHOLE_STEP_S,
                       seconds_note="4 processes sharing one card: not a "
                                    "speed")
        smoke.emit("mesh_moe", nvidia_smi=smi, policy=policy,
                   config="moonshot-v1-16b-a3b", layers=MESH_MOE_LAYERS,
                   n_params=want["n_params"], batch=8, seq=seq, steps=steps,
                   rows_a_rank=[m["rows"] for m in runs],
                   losses_unsharded=want["losses"],
                   grad_norms_unsharded=want["grad_norms"],
                   losses=[m["losses"] for m in runs],
                   grad_norms=[m["grad_norms"] for m in runs],
                   rel_err=err, loss_tol=MESH_MOE_LOSS_TOL,
                   grad_norm_tol=MESH_MOE_GNORM_TOL,
                   routing_step0=routes, route_tol=MESH_MOE_ROUTE_TOL,
                   bytes_held=[m["bytes_held"] for m in runs],
                   bytes_dryrun=runs[0]["bytes_dryrun"],
                   step_seconds=[m["step_seconds"] for m in runs],
                   step_seconds_unsharded=want["step_seconds"],
                   max_memory_allocated_bytes=[
                       m.get("max_memory_allocated_bytes") for m in runs],
                   max_memory_allocated_unsharded=want.get(
                       "max_memory_allocated_bytes"),
                   seconds=[m["seconds"] for m in runs],
                   unsharded_seconds=ref_s,
                   seconds_note="4 processes sharing one card: not a speed")
        for r, m, route in zip(ranks, runs, routes):
            who = f"(e) {policy} rank {r['rank']}"
            check(len(m["losses"]) == steps
                  and all(math.isfinite(x)
                          for x in m["losses"] + m["grad_norms"]),
                  f"{who}: losses {m['losses']} norms {m['grad_norms']}")
            check(m["bytes_held"] == m["bytes_dryrun"],
                  f"{who}: holds {m['bytes_held']}, the dry run counts "
                  f"{m['bytes_dryrun']}")
            check(not any(m["launches"].values()),
                  f"{who}: launched {m['launches']}")
            check(m["gathered_bytes"] == [m["plan_bytes"]] * steps,
                  f"{who}: computed with {m['gathered_bytes']} bytes a "
                  f"step, the plan counts {m['plan_bytes']}")
            check_wire(who, m["wire"], m["wire_want"])
            kept = sorted(k for k, (keep, _) in m["plan"].items() if keep)
            e = 64 // MESH_SHAPE[1] if policy == "tp" else 64
            check(m["experts_computed"] == [e]
                  and bool(kept) == (policy == "tp"),
                  f"{who}: experts {m['experts_computed']}, want [{e}]; "
                  f"kept {kept}")
            worst = max(route["experts_differ"], route["kept_differ"])
            check(worst <= MESH_MOE_ROUTE_TOL * route["tokens"],
                  f"{who}: routing differs from unsharded at step 0: "
                  f"{route}")
        check(not any(want["launches"].values()),
              f"(e) {policy} unsharded launched {want['launches']}")
        check(len({tuple(m["losses"]) for m in runs}) == 1
              and len({m["params_sha256"] for m in runs}) == 1,
              f"(e) {policy}: the ranks' losses or gathered parameters "
              f"differ")
        check(err["loss"] <= MESH_MOE_LOSS_TOL
              and err["grad_norm"] <= MESH_MOE_GNORM_TOL,
              f"(e) {policy} vs unsharded: {err} (tol {MESH_MOE_LOSS_TOL}, "
              f"{MESH_MOE_GNORM_TOL})")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--launcher-rank"]:
        launcher_rank(argv[1], argv[argv.index("--") + 1:])
        return 0
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
    f32 = [r for r in resources if r["kernel"] == "flash_attention_f32"]
    check(all(r["spill_store_bytes"] == r["spill_load_bytes"] == 0
              and r["dynamic_smem_bytes"] + r["static_smem_bytes"]
              <= SMEM_BLOCK_MAX for r in f32),
          f"float32 flash instances spill or pass 227 KB: {f32}")
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
    phase_quickstart(smoke, torch, dev)
    paths = phase_train(smoke, torch, conv, kernels, cnn_bp, autoencoder_bp,
                        dev)
    paths.update(phase_autotune(
        smoke, torch, ops, tg, ref, autotune, config, kernels, cnn_bp,
        shapes + [row[:4] for row in ae], paths["cnn_bp pallas"], dev))
    paths.update(phase_chaos(smoke, torch, conv, kernels, config, dev))
    paths.update(phase_mesh(smoke, torch, kernels, autoencoder_bp, train,
                            smi, dev))
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
    paths.update(phase_lm_train_moe(smoke, torch, kernels, train, smi, dev))
    paths.update(phase_lm_train_audio(smoke, torch, kernels, train, smi,
                                      dev))
    smoke.emit("summary", launches_by_path=paths)

    main_path = {k: "cnn_bp pallas" for k in TAP_KERNELS}
    main_path["matmul"] = "cnn_bp traditional"
    main_path["flash_attention"] = "serve continuous"
    main_path["flash_attention_d256"] = "serve_hybrid continuous"
    main_path["flash_attention_bidir_d80"] = "encode_audio"
    main_path["flash_attention_f32"] = "serve_f32 engines"
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
                                           "instance",
              "flash_attention_f32": "one float32 prefill's attention: "
                                     "causal (1, 15, 1024, 64) queries "
                                     "against (1, 5, 1024, 64) keys and "
                                     "values, three TF32 products a pair; "
                                     "bound at 165 TFLOP/s"}
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
    # recurrentgemma's head dim 256 and, full, at hubert-xlarge's 80, and
    # its float32 instance at SmolLM's prefill (launches counted apart).
    rows = {**KERNELS, **{f"{k}_bf16{g}": KERNELS[k] for k in TAP_KERNELS
                          for g in ("", "_g4096")},
            "flash_attention_d256": KERNELS["flash_attention"],
            "flash_attention_bidir_d80": KERNELS["flash_attention"],
            "flash_attention_f32": KERNELS["flash_attention"]}
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
