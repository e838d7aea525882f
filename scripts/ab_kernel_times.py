#!/usr/bin/env python3
"""Kernel times of two checkouts of the PyTorch/CUDA port on one card, in turns.

    python3 scripts/ab_kernel_times.py --parent DIR [--child DIR] \
        [--phases kernels,matmul,flash] [--out PATH]

Runs, in the order parent, child, child, parent, each checkout's own
``chip_smoke.py`` phases ``kernels`` (the three tap-GEMM kernels at the
five Table II layers and at the example CNN's and autoencoder's training
shapes, ``cnn_shapes`` and ``ae_shapes``), ``kernels_bf16`` where the
checkout has it (their bf16 instances at Mamba2-370M's depthwise conv and
a Table II layer, ``kernel_bf16_shapes``), ``matmul`` (every lowered GEMM
of those layers and shapes, and the bf16 case) and ``flash``
(``FLASH_CASES``), or only the ``--phases`` named, one process per turn,
so both sides build their own kernels from their own sources and run on
the same card.  Last in each turn, after every timing (a process that
has run ``torch.profiler`` pays a per-kernel cost from then on), it
times, with the ``kernels`` phase, its checkout's
``input_grad_operands`` (the input grad's operands: padded dY and the
weight stacks) at the same conv shapes and inputs, as the kernel
``input_grad_operands``: the device time of 10 calls under
``torch.profiler`` (the parent's operands copy index lists to the card,
which a CUDA graph does not capture), the median of 3 such windows.
``--child`` defaults to the checkout that holds this script; ``--parent``
is typically ``git archive`` of the parent commit unpacked
into a git-ignored directory.  Every phase line goes to ``--out`` with
``side`` and ``turn`` added; the summary printed last gives, per kernel
and shape, each side's device time (mean of its two turns) and their
ratio.  Exits non-zero without a CUDA device or if a turn fails.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: run inside each turn's process, with the checkout's root as argv[1]
TURN = r"""
import json, pathlib, statistics, sys
root = pathlib.Path(sys.argv[1])
phases = sys.argv[2].split(",")
sys.path[:0] = [str(root), str(root / "src")]
import torch
import torch.nn.functional as F
from torch.nn import grad as nn_grad
import chip_smoke as cs
from repro_torch.configs import paper_cnn
from repro_torch.core import conv
from repro_torch.core.convspec import ConvTransposeSpec
from repro_torch.core.im2col_ref import ConvDims
from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import tap_gemm as tg
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
smoke = cs.Smoke(None)
shapes = ([("/".join(map(str, layer)), paper_cnn.dims(layer), 1, True)
           for layer in paper_cnn.TABLE2_LAYERS] + cs.cnn_shapes(ConvDims))
ae = cs.ae_shapes(ConvDims, conv, ConvTransposeSpec)
if "kernels" in phases:
    cs.phase_kernels(smoke, torch, F, nn_grad, ops, tg, ref,
                     shapes + [row[:4] for row in ae], dev)
if "kernels" in phases and hasattr(cs, "kernel_bf16_shapes"):
    cs.phase_kernels(smoke, torch, F, nn_grad, ops, tg, ref,
                     cs.kernel_bf16_shapes(ConvDims, paper_cnn), dev,
                     torch.bfloat16, "kernels_bf16")
if "matmul" in phases:
    cs.phase_matmul(smoke, torch, mm, ref, tg,
                    cs.matmul_cases(torch, conv, shapes, ae), dev)
if "flash" in phases:
    cs.phase_flash(smoke, torch, F, fa, ref, dev)


def profiled_ms(fn, calls=10):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


for i, (layer, d, g, _) in enumerate(
        shapes + [row[:4] for row in ae] if "kernels" in phases else []):
    gen = torch.Generator().manual_seed(i)     # phase_kernels' inputs
    torch.randn(d.B, d.C * g, d.H_i, d.W_i, generator=gen)
    w = torch.randn(d.N * g, d.C, d.K_h, d.K_w, generator=gen).to(dev)
    dy = torch.randn(d.B, d.N * g, d.H_o, d.W_o, generator=gen).to(dev)
    ms = statistics.median(profiled_ms(
        lambda: ops.input_grad_operands(dy, w, d, g)) for _ in range(3))
    print(json.dumps({"kernel": "input_grad_operands", "layer": layer,
                      "kernel_ms": ms}))
"""


def shape_key(rec: dict) -> str:
    return str(rec.get("layer") or rec.get("case")) + (
        f" {rec['gemm']}" if "gemm" in rec else "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True)
    ap.add_argument("--child", type=pathlib.Path, default=ROOT)
    ap.add_argument("--phases", default="kernels,matmul,flash",
                    help="comma-separated chip_smoke phases to run")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("ab_kernel_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    out = open(args.out, "w") if args.out else None
    times: dict[tuple[str, str], dict[str, list[float]]] = {}
    for turn, side in enumerate(("parent", "child", "child", "parent")):
        root = (args.parent if side == "parent" else args.child).resolve()
        proc = subprocess.run([sys.executable, "-c", TURN, str(root),
                               args.phases],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"ab_kernel_times: {side} turn {turn} failed",
                  file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            rec.update(side=side, turn=turn, nvidia_smi=smi)
            if out:
                out.write(json.dumps(rec) + "\n")
            if "kernel_ms" in rec:
                key = (rec["kernel"], shape_key(rec))
                times.setdefault(key, {}).setdefault(side, []).append(
                    rec["kernel_ms"])
        print(f"turn {turn} ({side}) done", flush=True)
    summary = [{"kernel": k, "shape": s,
                "parent_ms": sum(t["parent"]) / len(t["parent"]),
                "child_ms": sum(t["child"]) / len(t["child"]),
                "parent_turns_ms": t["parent"], "child_turns_ms": t["child"]}
               for (k, s), t in times.items()
               if "parent" in t and "child" in t]
    for row in summary:
        row["child_over_parent"] = row["child_ms"] / row["parent_ms"]
        print(json.dumps(row))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
