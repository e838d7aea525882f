"""Train a conv -> conv_transpose autoencoder with a selectable conv-backprop
engine policy -- the transposed-conv-as-forward workload, end to end,
through ``make_train_step`` on the card.

    python -m repro_torch.train.autoencoder_bp --policy pallas
    python -m repro_torch.train.autoencoder_bp --policy traditional
    python -m repro_torch.train.autoencoder_bp --device cpu --steps 20 \\
        --mse-floor 1

Twin of ``examples/train_autoencoder_bp.py``: the same model (3->16->32
stride-2 encoder, two stride-2 transposed-conv decoder layers), the same
numpy ``synthetic_images`` (so the data is bit-identical), AdamW with a
cosine schedule through ``repro_torch.train.train_step.make_train_step``
and its ``loss=autoencoder_loss`` plugin.  Under ``pallas`` each decoder
forward is one ``tap_gemm_phased`` launch (the zero-inserted input is
never built); under ``traditional`` it physically zero-inserts the input
and every lowered GEMM runs the hand-written ``matmul`` kernel.
``--policy`` takes a uniform engine name (lax | traditional | bp_im2col |
bp_phase | pallas), ``auto``, or a per-pass string fwd=...,dgrad=...,
wgrad=...  ``--device`` defaults to the card and never falls back.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import autoencoder as M
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_step


def synthetic_images(rng: np.random.RandomState, n: int, c: int = 3,
                     size: int = 16) -> np.ndarray:
    """Learnable reconstruction task: smooth low-frequency blobs (a few
    random Fourier modes per image).  The same numpy code as the JAX
    example, so the data is bit-identical."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    out = np.zeros((n, c, size, size), np.float32)
    for i in range(n):
        for ch in range(c):
            fy, fx = rng.randint(1, 4, 2)
            py, px = rng.rand(2) * 2 * np.pi
            amp = rng.rand() + 0.5
            out[i, ch] = amp * np.sin(2 * np.pi * fy * yy / size + py) \
                * np.cos(2 * np.pi * fx * xx / size + px)
    return out


def train(policy="auto", steps: int = 200, batch: int = 16, size: int = 16,
          lr: float = 1e-2, device=None, params=None, log=None) -> dict:
    """AdamW on the synthetic images; returns ``{"mses", "seconds",
    "params"}``.  ``params`` defaults to :func:`init_autoencoder` with
    seed 0."""
    dev = resolve_device(device)
    cfg = M.AutoencoderConfig(c_in=3, widths=(16, 32), k=3,
                              conv_policy=str(policy))
    if params is None:
        params = M.init_autoencoder(torch.Generator().manual_seed(0), cfg,
                                    device=dev)
    opt_state = adamw.init_state(params)
    step_fn = make_train_step(
        cfg, adamw.AdamWConfig(peak_lr=lr, weight_decay=0.0),
        total_steps=steps, warmup=max(1, steps // 10),
        loss=M.autoencoder_loss, conv_policy=policy)
    rng = np.random.RandomState(0)
    mses = []
    t0 = time.perf_counter()
    for step in range(steps):
        images = synthetic_images(rng, batch, cfg.c_in, size)
        batch_t = {"image": torch.from_numpy(images).to(dev)}
        params, opt_state, metrics = step_fn(params, opt_state, batch_t,
                                             step)
        mses.append(metrics["mse"])
        if log is not None and (step % 20 == 0 or step == steps - 1):
            log(f"[{policy}] step={step:4d} mse={metrics['mse'].item():.5f}")
    mses = torch.stack(mses).tolist() if mses else []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"mses": mses, "seconds": time.perf_counter() - t0,
            "params": params}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policy", default="auto",
                    help="engine policy: a uniform engine name (lax | "
                         "traditional | bp_im2col | bp_phase | pallas), "
                         "'auto', or a per-pass string "
                         "fwd=...,dgrad=...,wgrad=...")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--mse-floor", type=float, default=0.05,
                    help="final reconstruction MSE must fall below this")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; never falls back)")
    args = ap.parse_args(argv)
    res = train(args.policy, args.steps, args.batch, args.size, args.lr,
                args.device, log=print)
    mse = res["mses"][-1] if res["mses"] else float("nan")
    print(f"[{args.policy}] done in {res['seconds']:.1f}s  "
          f"final_mse={mse:.5f}")
    if not mse < args.mse_floor:
        raise SystemExit(f"autoencoder failed to learn: mse {mse:.5f} >= "
                         f"{args.mse_floor}")
    return res


if __name__ == "__main__":
    main()
