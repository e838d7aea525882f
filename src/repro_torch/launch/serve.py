"""Serving launcher: batched request serving of an LM on the card
(counterpart of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --full --engine continuous \\
        --requests 8 --prompt-len 1024 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --requests 4 --max-new 8

``--engine static`` runs the wave-batched baseline
(``repro_torch.serve.engine``); ``--engine continuous`` (default) the
slotted-cache continuous-batching engine (``repro_torch.serve.continuous``),
whose prefills run the flash-attention kernel.  The model is initialised
from ``--seed`` (no weights are read).  ``--arch`` names a registered
config (``repro_torch.configs``: smollm-360m, moonshot-v1-16b-a3b,
deepseek-v3-671b, whose 61 layers at ``--full`` no one card holds,
mamba2-370m and recurrentgemma-9b).  ``--full`` serves the published
widths (``FULL``) instead of the smoke config the JAX launcher serves;
the prompts are the JAX launcher's (``np.random.RandomState(seed)``).
``--conv-policy`` pins the model's per-pass conv engines, as in the JAX
launcher (Mamba2's depthwise conv and RecurrentGemma's temporal conv:
``pallas`` runs their prefill's conv on the ``tap_gemm`` kernel).
``--device`` defaults to the card and never falls back.

    python -m repro_torch.launch.serve --full --arch mamba2-370m \
        --conv-policy pallas --requests 8 --prompt-len 1024 --max-new 32
    python -m repro_torch.launch.serve --full --arch recurrentgemma-9b \
        --conv-policy pallas --requests 8 --prompt-len 1024 --max-new 32
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.continuous import ContinuousEngine
from repro_torch.serve.engine import Engine
from repro_torch.serve.request import Request

ENGINES = {"static": Engine, "continuous": ContinuousEngine}


def init_params(cfg, seed: int, device):
    """The served model's parameters, drawn from ``seed``."""
    return M.init_params(torch.Generator().manual_seed(seed), cfg, device)


def main(argv=None) -> dict:
    """Serve the requests; returns ``{"requests", "summary", "seconds",
    "tok_s", "p50_latency_s"}`` (``summary`` is the engine's
    ``run_summary()``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--full", action="store_true",
                    help="serve the published widths, not the smoke config")
    ap.add_argument("--engine", choices=sorted(ENGINES), default="continuous",
                    help="wave-batched baseline or slotted continuous "
                         "batching (default)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock budget in seconds; "
                         "overdue requests finalize with partial output "
                         "and status='timed_out'")
    ap.add_argument("--conv-policy", default=None,
                    help="per-pass conv engine policy of the served model "
                         "(e.g. 'auto', 'pallas', or "
                         "'fwd=...,dgrad=...,wgrad=...')")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; never falls back)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    params = init_params(cfg, args.seed, dev)
    eng = ENGINES[args.engine](
        cfg, params, max_batch=args.max_batch,
        max_len=args.prompt_len + args.max_new + 2,
        temperature=args.temperature, seed=args.seed,
        conv_policy=args.conv_policy)
    rng = np.random.RandomState(args.seed)
    for rid in range(args.requests):
        eng.submit(Request(
            rid=rid,
            prompt=rng.randint(0, cfg.vocab, args.prompt_len).tolist(),
            max_new=args.max_new,
            deadline_s=args.deadline_s))
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in done)
    by_status: dict[str, int] = {}
    for r in done:
        by_status[r.status] = by_status.get(r.status, 0) + 1
    lat = sorted(r.t_done - r.t_submit for r in done
                 if r.t_done is not None)
    p50 = lat[len(lat) // 2] if lat else float("nan")
    print(f"[serve] arch={cfg.name} engine={args.engine} device={dev} "
          f"requests={len(done)} tokens={n_tok} "
          f"wall={dt:.2f}s ({n_tok / dt:.1f} tok/s) "
          f"p50_latency={p50:.2f}s status={by_status}")
    for r in done[:3]:
        print(f"  req{r.rid}: {r.out[:10]}... [{r.status}]")
    return {"requests": done, "summary": eng.run_summary(), "seconds": dt,
            "tok_s": n_tok / dt, "p50_latency_s": p50}


if __name__ == "__main__":
    main()
