#!/usr/bin/env python3
"""Device time of the weight grad and ``matmul`` at each split-K count, on one card.

    python3 scripts/split_sweep.py [--out PATH]

For every weight-grad shape and every ``traditional`` / ``bp_im2col`` GEMM
that ``chip_smoke.py`` runs (Table II at batch 2, the example CNN's and
autoencoder's training shapes), times the kernel (``chip_smoke.time_ms``:
CUDA-graph replay) with its plan's split count replaced by each of 1, 2,
3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192 and 256 that leaves every
split at least one step, beside the count the plan picks.  The plans'
rule (``repro_torch.kernels.tap_gemm.split_count``: as many splits as
fill the blocks the card holds at once) was chosen from these times.
One JSON object per line on stdout (and ``--out``); the card's name and
power limit first.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
COUNTS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("split_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.configs import paper_cnn
    from repro_torch.core import conv
    from repro_torch.core.convspec import ConvTransposeSpec
    from repro_torch.core.im2col_ref import ConvDims
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import tap_gemm as tg

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = open(args.out, "w") if args.out else None

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    emit({"nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), "sms": sms})
    shapes = ([("/".join(map(str, layer)), paper_cnn.dims(layer), 1, True)
               for layer in paper_cnn.TABLE2_LAYERS]
              + cs.cnn_shapes(ConvDims))
    ae = cs.ae_shapes(ConvDims, conv, ConvTransposeSpec)

    wgrad_plan = tg.wgrad_plan
    for i, (layer, d, g, _) in enumerate(shapes + [r[:4] for r in ae]):
        gen = torch.Generator().manual_seed(i)
        x = torch.randn(d.B, d.C * g, d.H_i, d.W_i, generator=gen).to(dev)
        dy = torch.randn(d.B, d.N * g, d.H_o, d.W_o, generator=gen).to(dev)
        src, dyn, taps = ops.weight_grad_operands(x, dy, d, g)
        rows = d.B * d.H_o * d.W_o
        variant, plan = wgrad_plan(g, len(taps), d.C, d.N, rows, sms)
        for s in sorted({c for c in COUNTS if c * 16 <= rows} | {1, plan}):
            tg.wgrad_plan = lambda *_, s=s: (variant, s)
            emit({"kernel": "tap_wgrad", "layer": layer, "variant": variant,
                  "plan": plan, "splits": s, "ms": cs.time_ms(
                      torch, lambda: tg.tap_wgrad(src, dyn, taps, d.H_o,
                                                  d.W_o))})
        tg.wgrad_plan = wgrad_plan

    matmul_plan = mm.matmul_plan
    for i, (layer, gemm, (g, m, k, n), dtype, _) in enumerate(
            cs.matmul_cases(torch, conv, shapes, ae)):
        if dtype != torch.float32:
            continue
        gen = torch.Generator(device=dev).manual_seed(i)
        a = torch.randn(g, m, k, device=dev, generator=gen)
        b = torch.randn(g, k, n, device=dev, generator=gen)
        variant, plan = matmul_plan(g, m, k, n, sms)
        step = mm.VARIANTS[variant].step
        for s in sorted({c for c in COUNTS if c * step <= k} | {1, plan}):
            mm.matmul_plan = lambda *_, s=s: (variant, s)
            emit({"kernel": "matmul", "layer": layer, "gemm": gemm,
                  "gmkn": [g, m, k, n], "variant": variant, "plan": plan,
                  "splits": s,
                  "ms": cs.time_ms(torch, lambda: mm.matmul(a, b))})
        mm.matmul_plan = matmul_plan
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
