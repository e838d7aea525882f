"""Train a strided CNN classifier with a selectable conv-backprop engine
policy -- the paper's training scenario, end to end, on the card.

    python -m repro_torch.train.cnn_bp --policy pallas
    python -m repro_torch.train.cnn_bp --policy traditional
    python -m repro_torch.train.cnn_bp --policy fwd=lax,dgrad=pallas,wgrad=bp_phase
    python -m repro_torch.train.cnn_bp --policy pallas --autotune measure \
        --plan-cache-dir /tmp/plans

Twin of ``examples/train_cnn_bp.py``: the same model (3->16 stride 2, a
depthwise 16->16 ``groups=16`` layer, 16->32 stride 2, global average pool,
linear head), the same synthetic task made by the same numpy code (so the
data is bit-identical), and plain SGD.  Every conv goes through
``repro_torch.models.layers``, so each backward pass runs the policy's
per-pass engines; under ``pallas`` all three passes of every conv run the
hand-written CUDA tap-GEMM kernels, and under ``traditional`` or
``bp_im2col`` every lowered GEMM runs the hand-written ``matmul`` kernel.
``--policy`` defaults to ``auto``.  ``--autotune measure`` times the tap
kernels' candidate plans on the card and persists the winners under
``--plan-cache-dir``; ``--autotune cached`` serves persisted winners and
never times (``repro_torch.core.config``, ``kernels/autotune.py``).
``params_from_numpy`` turns the JAX example's parameters (as numpy arrays)
into this model's, so both packages can be run from one initialization.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.config import config
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.tree import params_from_numpy, tree_leaves

__all__ = ["make_model", "init_params", "params_from_numpy",
           "synthetic_task", "train", "main"]


def make_model(policy):
    """``(forward, loss_fn)`` over a parameter dict, as in the JAX example."""
    def forward(params, x):
        h = F.relu(L.conv2d_apply(params["c1"], x, stride=2, padding=1,
                                  policy=policy))         # 16x16 -> 8x8
        h = F.relu(L.conv2d_apply(params["dw"], h, stride=1, padding=1,
                                  policy=policy, groups=16))  # depthwise
        h = F.relu(L.conv2d_apply(params["c2"], h, stride=2, padding=1,
                                  policy=policy))         # 8x8 -> 4x4
        return h.mean((2, 3)) @ params["head"]            # GAP + head

    def loss_fn(params, x, y):
        return F.cross_entropy(forward(params, x), y)

    return forward, loss_fn


def init_params(seed: int = 0, device=None):
    """The port's own initialization (a ``torch.Generator`` for the convs,
    numpy for the head, as the JAX example does)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.RandomState(seed)
    return {
        "c1": L.init_conv2d(gen, 3, 16, 3, device=dev),
        "dw": L.init_conv2d(gen, 16, 16, 3, groups=16, device=dev),
        "c2": L.init_conv2d(gen, 16, 32, 3, device=dev),
        "head": torch.as_tensor(rng.randn(32, 4) * 0.1,
                                dtype=torch.float32).to(dev),
    }


def synthetic_task(rng: np.random.RandomState, n: int, classes: int = 4,
                   device=None):
    """Learnable synthetic vision task: class = dominant quadrant pattern.
    The same numpy code as the JAX example, so the data is bit-identical."""
    x = rng.randn(n, 3, 16, 16).astype(np.float32)
    y = rng.randint(0, classes, n)
    for i in range(n):
        q = y[i]
        r0, c0 = (q // 2) * 8, (q % 2) * 8
        x[i, :, r0:r0 + 8, c0:c0 + 8] += 2.0
    dev = resolve_device(device)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).long().to(dev)


def train(policy=None, steps: int = 200, batch: int = 32, lr: float = 0.05,
          device=None, params=None, log=None) -> dict:
    """SGD on the synthetic task; returns ``{"losses", "eval_acc",
    "seconds", "first_step_seconds", "params"}`` (``first_step_seconds``:
    host time to the end of step 0, which includes planning every pass --
    with ``config.autotune="measure"`` a cold plan cache times the
    candidates there).  ``params`` defaults to :func:`init_params` and is
    updated in place."""
    dev = resolve_device(device)
    params = init_params(device=dev) if params is None else params
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    _, loss_fn = make_model(policy)
    rng = np.random.RandomState(0)
    losses = []
    first = None
    t0 = time.perf_counter()
    for step in range(steps):
        x, y = synthetic_task(rng, batch, device=dev)
        loss = loss_fn(params, x, y)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(lr * g)
        losses.append(loss.detach())
        if first is None:
            first = time.perf_counter() - t0
        if log is not None and (step % 20 == 0 or step == steps - 1):
            log(f"[{policy}] step={step:4d} loss={loss.item():.4f}")
    losses = torch.stack(losses).tolist() if losses else []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    xe, ye = synthetic_task(np.random.RandomState(1), 256, device=dev)
    fwd, _ = make_model(policy)
    with torch.no_grad():
        acc = (fwd(params, xe).argmax(-1) == ye).float().mean().item()
    return {"losses": losses, "eval_acc": acc, "seconds": seconds,
            "first_step_seconds": first, "params": params}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policy", default="auto",
                    help="engine policy: a uniform engine name (lax | "
                         "traditional | bp_im2col | bp_phase | pallas), "
                         "'auto', or a per-pass string "
                         "fwd=...,dgrad=...,wgrad=...")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--acc-floor", type=float, default=0.9)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; never falls back)")
    ap.add_argument("--autotune", default=None,
                    choices=["off", "measure", "cached"],
                    help="measured autotuning of the tap kernels' plans "
                         "(config.autotune)")
    ap.add_argument("--plan-cache-dir", default=None,
                    help="persistent plan-cache directory "
                         "(config.plan_cache_dir)")
    args = ap.parse_args(argv)
    config.update(**{k: v for k, v in (("autotune", args.autotune),
                                       ("plan_cache_dir",
                                        args.plan_cache_dir))
                     if v is not None})
    res = train(args.policy, args.steps, args.batch, args.lr, args.device,
                log=print)
    print(f"[{args.policy}] done in {res['seconds']:.1f}s  "
          f"eval_acc={res['eval_acc']:.3f}")
    if not res["eval_acc"] > args.acc_floor:
        raise SystemExit(f"training failed to learn the synthetic task: "
                         f"eval_acc {res['eval_acc']:.3f} <= "
                         f"{args.acc_floor}")
    return res


if __name__ == "__main__":
    main()
