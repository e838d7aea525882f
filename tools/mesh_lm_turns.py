#!/usr/bin/env python3
"""``chip_smoke.py``'s mesh (d) -- Mamba2-370M at full width, parameters,
AdamW moments and an 8 x 512 batch in their ``tp`` blocks on 4 ranks of a
(data=2, model=2) mesh sharing one card over gloo -- or any of its mesh LM
cases ((d), (f), (g): ``chip_smoke.MESH_LM_CASES``), from each of several
checkouts in turn, to compare two commits on one card in one call.

    python3 tools/mesh_lm_turns.py ROOT [ROOT ...] [--cases d f g]
        [--out PATH]

For example, with the parent commit unpacked under ``build/parent``
(``git archive``), the ROOTs ``build/parent . . build/parent``.  Each turn
runs in a process of its own from its ROOT (that checkout's
``chip_smoke.mesh_lm_blocks`` and ``repro_torch``, its kernels built
there first), spawns the 4 ranks, runs each case on them in order and
prints one JSON line: every rank's losses, gradient norms, seconds a
step, peak memory and the model collectives it made
(``dist.tensor_parallel.COUNTS``, empty before it counted any) for each
case.  The
card's name and power limit come first.  The ranks share the card: a
step's seconds are those of processes sharing it, not a rank's speed.
Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time


def rank_main(rank: int, root: str, out_dir: str, cases) -> None:
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    import chip_smoke as CS
    from repro_torch import kernels
    from repro_torch.core import conv
    from repro_torch.core.config import config
    from repro_torch.dist import tensor_parallel as TP
    from repro_torch.launch import mesh as LM
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = LM.init_distributed(
        "cuda", init_method="file://" + os.path.join(out_dir, "pg"),
        rank=rank, world_size=4, local_world=4)
    config.update(autotune="off", plan_cache_dir=None)
    mesh = LM.make_mesh((2, 2), ("data", "model"))
    counts = getattr(TP, "COUNTS", {})
    out = {}
    for case in cases:
        before = dict(counts)
        if "case" in inspect.signature(CS.mesh_lm_blocks).parameters:
            res = CS.mesh_lm_blocks(torch, kernels, conv, dev, case, mesh)
        else:                      # a checkout from before (f) was added
            res = CS.mesh_lm_blocks(torch, kernels, conv, mesh, dev)
        out[case] = {k: res.get(k) for k in (
            "losses", "grad_norms", "step_seconds",
            "max_memory_allocated_bytes", "params_sha256")}
        out[case]["collectives"] = {k: counts[k] - v
                                    for k, v in before.items()}
    pathlib.Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    mesh.barrier()
    LM.shutdown()


def turn(root: str, cases) -> dict:
    """One turn from ``root``: build its kernels, spawn the ranks."""
    import torch.multiprocessing as mp
    sys.path[:0] = [root, os.path.join(root, "src")]
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build()
    built = time.perf_counter() - t0
    work = tempfile.mkdtemp(dir=os.path.join(root, "build"))
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    mp.spawn(rank_main, args=(root, work, cases), nprocs=4)
    return {"root": root, "build_s": built,
            "spawn_s": time.perf_counter() - t0,
            "ranks": [json.loads(pathlib.Path(work, f"rank{r}.json")
                                 .read_text()) for r in range(4)]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkouts, in turn order")
    ap.add_argument("--cases", nargs="+", default=["d"],
                    choices=("d", "f", "g"), help="mesh LM cases, in order")
    ap.add_argument("--out", default=None, help="also append the lines here")
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(os.path.abspath(args.roots[0]), args.cases)),
              flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in args.roots:
        proc = subprocess.run([sys.executable, __file__, "--turn", root,
                               "--cases", *args.cases],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
