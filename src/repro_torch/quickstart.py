"""Quickstart: the paper's BP-im2col in a minute, on the port (the
counterpart of ``examples/quickstart.py``).

    python -m repro_torch.quickstart [--device cuda|cpu]

Walks through, on one Table II layer scaled down in channels:
  1. a strided conv layer's backprop zero-space problem (sparsities),
  2. Algorithm 1's implicit address mapping == the explicit zero-spaced
     lowering,
  3. the implicit grads (Algorithm 1's input grad, the phase-decomposed
     weight grad) == the library conv's dense grads,
  4. the traffic and bandwidth savings the paper reports.

It runs on the card by default (``--device cpu`` on the host, never as a
fallback), prints the JAX walkthrough's figures, and raises when a check
fails.  The dense reference runs with TF32 off, so float32 stays float32.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from repro_torch.core import bpim2col as bp
from repro_torch.core import im2col_ref as ref
from repro_torch.core import phase_decomp as ph
from repro_torch.core.im2col_ref import ConvDims
from repro_torch.device import resolve_device

#: a conv layer of the paper's Table II, its channels scaled down.
LAYER = ConvDims(B=2, C=8, H_i=28, W_i=28, N=16, K_h=3, K_w=3, S=2, P_h=1,
                 P_w=1)


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
           what: str) -> None:
    """Raise unless ``|got - want| <= atol + rtol |want|`` everywhere."""
    if got.shape != want.shape or not bool(
            ((got - want).abs() <= atol + rtol * want.abs()).all()):
        err = (got - want).abs().max().item() if got.shape == want.shape \
            else f"shapes {tuple(got.shape)} vs {tuple(want.shape)}"
        raise AssertionError(f"{what}: max |diff| {err} (rtol {rtol}, "
                             f"atol {atol})")


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def run(device=None, d: ConvDims = LAYER) -> dict:
    """The four sections on ``device`` (printed as the JAX walkthrough
    prints them); returns the figures."""
    dev = resolve_device(device)
    out = {}
    print(f"layer: H={d.H_i} C={d.C} N={d.N} K={d.K_h} S={d.S} P={d.P_h}"
          f" -> H_o={d.H_o}")

    # 1. the zero-space problem
    out["zero_space_sparsity_loss"] = d.zero_space_sparsity_loss()
    out["lowered_sparsity_loss"] = bp.lowered_sparsity_loss(d)
    out["lowered_sparsity_grad"] = bp.lowered_sparsity_grad(d)
    print(f"\nzero-spaced loss map: {d.H_o}x{d.W_o} -> {d.H_o3}x{d.W_o3} "
          f"({out['zero_space_sparsity_loss']:.1%} zeros)")
    print(f"lowered matrix B sparsity (loss calc):  "
          f"{out['lowered_sparsity_loss']:.1%}  <- paper: 75%..93.91%")
    print(f"zero-inserted dY sparsity (grad calc):  "
          f"{out['lowered_sparsity_grad']:.1%}  <- paper: 74.8%..93.6%")

    # 2. Algorithm 1: implicit gather == explicit zero-spaced lowering
    rng = np.random.RandomState(0)

    def draw(*shape):
        return torch.as_tensor(rng.randn(*shape), dtype=torch.float32,
                               device=dev)
    dy = draw(d.B, d.N, d.H_o, d.W_o)
    implicit = bp.gather_lowered_B_loss(dy, d)
    explicit = ref.im2col(ref.insert_zeros_pad(dy, d), d.K_h, d.K_w, 1).t()
    _close(implicit, explicit, 1e-6, 0.0, "Algorithm 1 lowering")
    print("\nAlgorithm 1 implicit lowering == explicit zero-spaced lowering"
          "  OK")

    # 3. the implicit grads against the library conv's dense ones
    x = draw(d.B, d.C, d.H_i, d.W_i)
    w = draw(d.N, d.C, d.K_h, d.K_w)
    with _no_tf32():
        di_ref, dw_ref = ref.conv_grads_lax(x, w, dy, d)
        _close(bp.input_grad_implicit(dy, w, d), di_ref, 2e-4, 2e-4,
               "Algorithm 1 input grad")
        _close(ph.weight_grad_phase(x, dy, d), dw_ref, 2e-3, 2e-3,
               "phase-decomposed weight grad")
    print("BP-im2col gradients == dense library conv grads"
          "                  OK")

    # 4. traffic savings
    t = ref.reorg_traffic_elems_loss(d)
    o = bp.bp_traffic_elems_loss(d)
    out["traditional"], out["bp_im2col"] = t, o
    print(f"\ntraditional: reorg {t['reorg_read'] + t['reorg_write']:,} "
          f"elems, off-chip stream {t['offchip_stream']:,}, "
          f"buffer stream {t['buffer_stream']:,}")
    print(f"BP-im2col:   reorg 0 elems, off-chip stream "
          f"{o['offchip_stream']:,}, buffer stream {o['buffer_stream']:,}")
    out["buffer_reduction"] = 1 - o["buffer_stream"] / t["buffer_stream"]
    print(f"buffer-bandwidth reduction: {out['buffer_reduction']:.1%} "
          f"(paper: >= 70.6%)")
    print(f"extra backprop storage eliminated: {t['extra_storage']:,} elems "
          f"(paper: >= 74.78% reduction)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
