#!/usr/bin/env python3
"""One of ``chip_smoke.py``'s mesh LM cases alone: (d) Mamba2-370M, (f)
recurrentgemma-9b at one super-block or (g) DeepSeek-V3 at one dense MLA
layer and its MTP block (``chip_smoke.MESH_LM_CASES``), trained unsharded
on the card, then in its ``tp`` blocks on 4 ranks of a (data=2, model=2)
mesh sharing the card over gloo, checked and printed as the mesh phase
does it (``chip_smoke.phase_mesh_lm``); after (g), the plan counts of
``chip_smoke.MESH_PLAN_COUNTS`` too.

    python3 tools/mesh_lm_case.py g [--out out/mesh_g.jsonl]

The reference of every case is the cut trained unsharded by
``chip_smoke.mesh_lm_blocks`` (the mesh phase reads (d) against the
launcher's run instead).  The card's name and power limit come first, the
phase lines after, each with its seconds since the start.  The ranks
share the card: a step's seconds are those of processes sharing it, not
a rank's speed.  Needs a card; exits non-zero without one, or when a
check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def rank_main(rank: int, case: str, out_dir: str) -> None:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as CS
    from repro_torch import kernels
    from repro_torch.core import conv
    from repro_torch.core.config import config
    from repro_torch.launch import mesh as LM
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = LM.init_distributed(
        "cuda", init_method="file://" + os.path.join(out_dir, "pg"),
        rank=rank, world_size=CS.MESH_RANKS, local_world=CS.MESH_RANKS)
    config.update(autotune="off", plan_cache_dir=None, telemetry=True)
    mesh = LM.make_mesh(CS.MESH_SHAPE, ("data", "model"))
    t0 = time.perf_counter()
    res = CS.mesh_lm_blocks(torch, kernels, conv, dev, case, mesh)
    res["seconds"] = time.perf_counter() - t0
    pathlib.Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    mesh.barrier()
    LM.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case", choices=("d", "f", "g"))
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the phase lines to this file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mesh_lm_case: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch.multiprocessing as mp

    import chip_smoke as CS
    from repro_torch import kernels
    from repro_torch.core import conv
    from repro_torch.core.config import config
    from repro_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
    smoke = CS.Smoke(args.out)
    config.update(autotune="off", plan_cache_dir=None)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    if args.case in CS.MESH_LM_CHANNELS:
        build.build()
    t0 = time.perf_counter()
    ref = CS.mesh_lm_blocks(torch, kernels, conv, dev, args.case)
    ref["seconds"] = time.perf_counter() - t0
    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="mesh_case_", dir=ROOT / "build")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    mp.spawn(rank_main, args=(args.case, work), nprocs=CS.MESH_RANKS)
    spawn_s = time.perf_counter() - t0
    runs = [json.loads(pathlib.Path(work, f"rank{r}.json").read_text())
            for r in range(CS.MESH_RANKS)]
    CS.phase_mesh_lm(smoke, torch, smi, runs, args.case, ref)
    if args.case == "g":
        CS.mesh_plan_counts(smoke, torch)
    smoke.emit("mesh_lm_case", case=args.case, spawn_seconds=spawn_s,
               unsharded_seconds=ref["seconds"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
