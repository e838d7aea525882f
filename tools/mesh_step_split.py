#!/usr/bin/env python3
"""Where a batch-sharded training step of the PyTorch/CUDA port spends
its time: Mamba2-370M at full width on ranks that share one card over
gloo (each collective's tensors staged to the host).

    python3 tools/mesh_step_split.py [--ranks 2] [--reps 3] [--out PATH]

Each rank holds the whole bf16 parameters (the launcher's ``--conv-mesh
dp_only`` layout) and its block of an 8 x 512 batch from the launcher's
pipeline (seed 0), and times, ``--reps`` times each after one warm-up,
on the host clock after ``torch.cuda.synchronize()`` with a barrier
before each window:

  * ``fwd_bwd``: the loss and its grads on the block
    (``train_step._value_and_grad`` under the batch block, every conv on
    the bf16 ``dw`` kernels);
  * ``grad_psum``: the grads summed over the ranks (``Mesh.psum_flat``,
    one bf16 buffer);
  * ``update``: AdamW on the whole parameters (float32 moments).

Rank 0 prints the card's name and power limit first, then one JSON line
with each window's median and every reading; ``--out`` also writes it.
The ranks share the card, so a window is what one rank sees while the
others run theirs, not the speed of a rank that has a card of its own.
Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def rank_main(rank: int, world: int, reps: int, pg: str, out) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.config import config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.dist import constraints
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    from repro_torch.tree import tree_leaves
    config.update(autotune="off", plan_cache_dir=None)
    dev = LM.init_distributed("cuda", init_method="file://" + pg, rank=rank,
                              world_size=world, local_world=world)
    mesh = LM.make_host_mesh()
    constraints.set_activation_policy(SH.batch_axes(mesh, "dp_only"))
    split = constraints.batch_split(mesh)
    cfg = get_config("mamba2-370m")
    cfg = dataclasses.replace(cfg, conv_policy="pallas", conv_mode=None)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, dev)
    opt = adamw.init_state(params)
    dcfg = DataConfig(seed=0, seq_len=512, global_batch=8, vocab=cfg.vocab)
    batch = {k: torch.from_numpy(v) for k, v in
             make_batch(cfg, dcfg, 0).items()}
    batch = {k: v.to(dev) for k, v in SH.to_local(
        batch, SH.batch_specs(batch, mesh, "dp_only"), mesh).items()}
    grads = None

    def fwd_bwd():
        nonlocal grads
        _, _, grads = TS._value_and_grad(TS.loss_fn, params, batch, cfg,
                                         split)

    def grad_psum():
        mesh.psum_flat(tree_leaves(grads), split.axes)

    def update():
        adamw.apply_updates(params, grads, opt, 1e-4, adamw.AdamWConfig())

    times = {}
    for name, fn in (("fwd_bwd", fwd_bwd), ("grad_psum", grad_psum),
                     ("update", update)):
        secs = []
        for i in range(reps + 1):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                secs.append(time.perf_counter() - t0)
        times[name] = {"median_s": statistics.median(secs), "s": secs}
    if rank == 0:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        line = json.dumps({"nvidia_smi": smi, "config": "mamba2-370m",
                           "ranks": world, "rows_a_rank": 8 // world,
                           "grad_bytes": sum(g.numel() * g.element_size()
                                             for g in tree_leaves(grads)),
                           "windows": times})
        print(smi)
        print(line, flush=True)
        if out:
            pathlib.Path(out).write_text(line + "\n")
    dist.barrier()
    LM.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("mesh_step_split: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(rank_main, args=(args.ranks, args.reps,
                                  os.path.join(d, "pg"), args.out),
                 nprocs=args.ranks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
