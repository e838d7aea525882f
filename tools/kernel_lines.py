#!/usr/bin/env python3
"""The per-shape kernel lines of ``chip_smoke.py`` (its ``kernels``,
``kernels_bf16``, ``matmul`` and ``flash`` phases, which make up the final
``kernels`` line) from each of several checkouts in turn, to compare two
commits' kernels on one card in one call.

    python3 tools/kernel_lines.py ROOT [ROOT ...] --out PATH

For example, with the parent commit unpacked under ``build/parent``
(``git archive``), the ROOTs ``build/parent .``.  Each turn runs in a
process of its own from its ROOT (that checkout's ``chip_smoke`` and
``repro_torch``, its kernels built there first) and writes its lines to
``PATH.<turn>`` (its stdout dropped).  Then one JSON line per ROOT after
the first, with the card's name and power limit: how many lines the two
turns share (by phase and order), how many of them carry bit-equal
``max_abs_err`` and ``max_rel_err``, the ones that differ, and the
spread of the kernel times' ratios.  Needs a card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

PHASES = ("kernels", "kernels_bf16", "matmul", "flash")


def turn(root: str, out: str) -> None:
    """The kernel phases of ``root``'s ``chip_smoke.py``, set up as its
    ``main`` sets them up."""
    sys.path[:0] = [root, str(pathlib.Path(root) / "src")]
    import torch
    import torch.nn.functional as F
    from torch.nn import grad as nn_grad

    import chip_smoke as CS
    from repro_torch.configs import paper_cnn
    from repro_torch.core import conv
    from repro_torch.core.config import config
    from repro_torch.core.convspec import ConvTransposeSpec
    from repro_torch.core.im2col_ref import ConvDims
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import tap_gemm as tg
    config.update(autotune="off", plan_cache_dir=None)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    smoke = CS.Smoke(pathlib.Path(out))
    dev = torch.device("cuda")
    table2 = [("/".join(map(str, layer)), paper_cnn.dims(layer))
              for layer in paper_cnn.TABLE2_LAYERS]
    shapes = ([(label, d, 1, True) for label, d in table2]
              + CS.cnn_shapes(ConvDims))
    ae = CS.ae_shapes(ConvDims, conv, ConvTransposeSpec)
    CS.phase_kernels(smoke, torch, F, nn_grad, ops, tg, ref,
                     shapes + [row[:4] for row in ae], dev)
    CS.phase_kernels(smoke, torch, F, nn_grad, ops, tg, ref,
                     CS.kernel_bf16_shapes(ConvDims, paper_cnn), dev,
                     torch.bfloat16, "kernels_bf16")
    CS.phase_kernels(smoke, torch, F, nn_grad, ops, tg, ref,
                     CS.rg_conv_shapes(ConvDims), dev, torch.bfloat16,
                     "kernels_bf16")
    CS.phase_matmul(smoke, torch, mm, ref, tg,
                    CS.matmul_cases(torch, conv, shapes, ae), dev)
    CS.phase_flash(smoke, torch, F, fa, ref, dev)


def _lines(path: str) -> list[dict]:
    return [d for d in map(json.loads, pathlib.Path(path).read_text()
                           .splitlines())
            if d["phase"] in PHASES and "max_abs_err" in d]


def compare(first: list[dict], other: list[dict]) -> dict:
    """``other``'s lines against ``first``'s, pair by pair."""
    pairs = list(zip(first, other))
    differ = [{"phase": a["phase"], "kernel": a.get("kernel"),
               "at": a.get("layer", a.get("case")),
               "max_abs_err": (a["max_abs_err"], b["max_abs_err"])}
              for a, b in pairs
              if (a["max_abs_err"], a["max_rel_err"])
              != (b["max_abs_err"], b["max_rel_err"])]
    ratios = [b["kernel_ms"] / a["kernel_ms"] for a, b in pairs
              if a.get("kernel_ms") and b.get("kernel_ms")]
    return {"lines": (len(first), len(other)), "paired": len(pairs),
            "errors_bit_equal": len(pairs) - len(differ), "differ": differ,
            "time_ratio": {"min": min(ratios), "median":
                           statistics.median(ratios), "max": max(ratios)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out", required=True)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn is not None:
        turn(args.turn, args.out)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_lines: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    outs = []
    for i, root in enumerate(args.roots):
        out = f"{args.out}.{i}"
        subprocess.run([sys.executable, __file__, root, "--turn", root,
                        "--out", out], check=True,
                       stdout=subprocess.DEVNULL)
        outs.append(out)
    first = _lines(outs[0])
    for root, out in zip(args.roots[1:], outs[1:]):
        print(json.dumps({"nvidia_smi": smi, "root": root,
                          "against": args.roots[0],
                          **compare(first, _lines(out))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
