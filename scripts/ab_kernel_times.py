#!/usr/bin/env python3
"""Kernel times of two checkouts of the PyTorch/CUDA port on one card, in turns.

    python3 scripts/ab_kernel_times.py --parent DIR [--child DIR] \
        [--out PATH]

Runs, in the order parent, child, child, parent, each checkout's own
``chip_smoke.py`` phases ``kernels`` (the three tap-GEMM kernels at the
five Table II layers and at the example CNN's and autoencoder's training
shapes, ``cnn_shapes`` and ``ae_shapes``), ``matmul`` (every lowered GEMM
of those layers and shapes, and the bf16 case) and ``flash``
(``FLASH_CASES``), one process per turn, so
both sides build their own kernels from their own sources and run on the
same card.  ``--child`` defaults to the checkout that holds this script;
``--parent`` is typically ``git archive`` of the parent commit unpacked
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
import pathlib, sys
root = pathlib.Path(sys.argv[1])
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
cs.phase_kernels(smoke, torch, F, nn_grad, ops, tg, ref,
                 shapes + [row[:4] for row in ae], dev)
cs.phase_matmul(smoke, torch, mm, ref, tg,
                cs.matmul_cases(torch, conv, shapes, ae), dev)
cs.phase_flash(smoke, torch, F, fa, ref, dev)
"""


def shape_key(rec: dict) -> str:
    return str(rec.get("layer") or rec.get("case")) + (
        f" {rec['gemm']}" if "gemm" in rec else "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True)
    ap.add_argument("--child", type=pathlib.Path, default=ROOT)
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
        proc = subprocess.run([sys.executable, "-c", TURN, str(root)],
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
