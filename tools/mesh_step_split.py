#!/usr/bin/env python3
"""Where a batch-sharded training step of the PyTorch/CUDA port spends
its time, on ranks that share one card over gloo (each collective's
tensors staged to the host).

    python3 tools/mesh_step_split.py [--case mamba2] [--ranks 2] \
        [--reps 3] [--out PATH]
    python3 tools/mesh_step_split.py --case moonshot [--reps 3]

``--case mamba2``: Mamba2-370M at full width; each rank holds the whole
bf16 parameters (the launcher's ``--conv-mesh dp_only`` layout) and its
block of an 8 x 512 batch.  ``--case moonshot``: ``chip_smoke.py``'s mesh
(e) under ``tp``: moonshot-v1-16b-a3b at its published widths cut to 2
layers, 4 ranks on a (data=2, model=2) mesh, parameters and AdamW moments
in their ``tp`` blocks (``dist.spmd.Blocks`` and its plan,
``dist.tensor_parallel``), each rank's block of an 8 x 512 batch.  The
batches are the launcher's pipeline's (seed 0).  Each rank times,
``--reps`` times each after one warm-up, on the host clock after
``torch.cuda.synchronize()`` with a barrier before each window:

  * ``gather`` (moonshot): the parameters as the step computes with them
    (``Blocks.gather``: kept leaves over ``data`` only, the rest whole);
  * ``fwd_bwd``: the loss and its grads on the block
    (``train_step._value_and_grad`` under the batch block; mamba2's convs
    on the bf16 ``dw`` kernels; moonshot's under the plan's
    ``model_axis``, with the layers' psums over ``model``, counted, and
    ``Plan.fold``);
  * ``grad_sync``: the step's own sync of the grads
    (``train_step._sync``): mamba2's summed whole over the batch axes
    (``Mesh.psum_flat``, one bf16 buffer); moonshot's synced into each
    parameter's block with its layout (a fixed-order reduce-scatter over
    ``data``, then coordinate 0's block of each replicated leaf over
    ``model``), with the bytes a rank sent and received
    (``tensor_parallel.COUNTS``);
  * ``update``: AdamW (float32 moments) on the whole parameters (mamba2),
    or the norm and AdamW on the blocks (moonshot).

Rank 0 prints the card's name and power limit first, then one JSON line
with each window's median and every reading (moonshot: every rank's);
``--out`` also writes it.
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


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _time(windows, reps: int, barrier) -> dict:
    import torch
    times = {}
    for name, fn in windows:
        secs = []
        for i in range(reps + 1):
            barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                secs.append(time.perf_counter() - t0)
        times[name] = {"median_s": statistics.median(secs), "s": secs}
    return times


def moonshot_main(rank: int, world: int, reps: int, pg: str, out) -> None:
    """``--case moonshot`` (module docstring)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.config import config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.dist import constraints
    from repro_torch.dist import sharding as SH
    from repro_torch.dist import tensor_parallel as TP
    from repro_torch.dist.spmd import Blocks
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    from repro_torch.tree import tree_leaves, tree_map
    config.update(autotune="off", plan_cache_dir=None)
    dev = LM.init_distributed("cuda", init_method="file://" + pg, rank=rank,
                              world_size=world, local_world=world)
    mesh = LM.make_mesh((2, 2), ("data", "model"))
    constraints.set_activation_policy(SH.batch_axes(mesh, "tp"))
    split = constraints.batch_split(mesh)
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), n_layers=2)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, dev)
    specs = SH.param_specs(params, mesh, "tp")
    blocks = tree_map(torch.clone, SH.to_local(params, specs, mesh))
    del params
    torch.cuda.empty_cache()
    layout = Blocks(mesh, specs, TP.plan(specs, cfg, mesh))
    opt = adamw.init_state(blocks)
    dcfg = DataConfig(seed=0, seq_len=512, global_batch=8, vocab=cfg.vocab)
    batch = {k: torch.from_numpy(v) for k, v in
             make_batch(cfg, dcfg, 0).items()}
    batch = {k: v.to(dev) for k, v in SH.to_local(
        batch, SH.batch_specs(batch, mesh, "tp"), mesh).items()}
    state: dict = {}

    def gather():
        state["full"] = layout.gather(blocks)

    def fwd_bwd():
        before = dict(TP.COUNTS)
        with mesh, layout.plan.axis():
            loss, metrics, grads = TS._value_and_grad(
                TS.loss_fn, state["full"], batch, cfg, split)
        state["vals"] = (loss, metrics, layout.plan.fold(grads))
        state["model_psums"] = {k: TP.COUNTS[k] - before[k]
                                for k in before}

    def grad_sync():
        before = dict(TP.COUNTS)
        state["synced"] = TS._sync(mesh, split.axes, *state["vals"],
                                   layout)
        state["sync_bytes"] = {k: TP.COUNTS[k] - before[k] for k in
                               ("scatter_bytes", "scatter_received")}

    def update():
        grads = state["synced"][2]
        gnorm = layout.global_norm(grads)
        adamw.apply_updates(blocks, grads, opt, 1e-4,
                            adamw.AdamWConfig(), in_place=True, gnorm=gnorm)

    times = _time((("gather", gather), ("fwd_bwd", fwd_bwd),
                   ("grad_sync", grad_sync), ("update", update)), reps,
                  dist.barrier)
    res = {"rank": rank, "coordinate": {a: mesh.coordinate(a)
                                        for a in mesh.axis_names},
           "gathered_bytes": layout.stats["gathered_bytes"],
           "grad_bytes": sum(g.numel() * g.element_size()
                             for g in tree_leaves(state["vals"][2])),
           "model_psums_fwd_bwd": state["model_psums"],
           "grad_sync_bytes": state["sync_bytes"], "windows": times}
    parts = [None] * world
    dist.all_gather_object(parts, res)
    if rank == 0:
        smi = _smi()
        line = json.dumps({"nvidia_smi": smi, "config": "moonshot-v1-16b-a3b",
                           "layers": 2, "mesh": {"data": 2, "model": 2},
                           "policy": "tp", "rows_a_rank": 4,
                           "median_s": {k: statistics.median(
                               p["windows"][k]["median_s"] for p in parts)
                               for k in times},
                           "ranks": parts})
        print(smi)
        print(line, flush=True)
        if out:
            pathlib.Path(out).write_text(line + "\n")
    dist.barrier()
    LM.shutdown()


def rank_main(rank: int, world: int, reps: int, pg: str, out) -> None:
    """``--case mamba2`` (module docstring)."""
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
    state: dict = {}

    def fwd_bwd():
        state["vals"] = TS._value_and_grad(TS.loss_fn, params, batch, cfg,
                                           split)

    def grad_sync():
        state["synced"] = TS._sync(mesh, split.axes, *state["vals"])

    def update():
        adamw.apply_updates(params, state["synced"][2], opt, 1e-4,
                            adamw.AdamWConfig())

    times = _time((("fwd_bwd", fwd_bwd), ("grad_sync", grad_sync),
                   ("update", update)), reps, dist.barrier)
    grads = state["vals"][2]
    if rank == 0:
        smi = _smi()
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
    ap.add_argument("--case", choices=("mamba2", "moonshot"),
                    default="mamba2")
    ap.add_argument("--ranks", type=int, default=2,
                    help="mamba2's ranks (moonshot runs 4)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("mesh_step_split: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import torch.multiprocessing as mp
    target, ranks = ((moonshot_main, 4) if args.case == "moonshot"
                     else (rank_main, args.ranks))
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(target, args=(ranks, args.reps, os.path.join(d, "pg"),
                               args.out), nprocs=ranks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
