"""The ranks of ``tests/test_torch_mesh.py``: 8 gloo processes on the CPU.

    python tests/_torch_mesh_worker.py IN_DIR OUT_DIR

``IN_DIR/inputs.npz`` holds the inputs (made from a seed with numpy by the
test, the autoencoder's parameters drawn by the JAX package).  Each rank
runs every case and writes ``OUT_DIR/rank<r>.json``; rank 0 also writes
the global results as ``OUT_DIR/arrays.npz``.  Imports torch and the
port only: the JAX side of each comparison runs in the test.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
POLICIES = ("auto", "pallas")
AE_POLICIES = ("tp", "dp_only", "spatial")
AE_STEPS = 3
#: (name, ConvSpec.make kwargs) of the halo audit: B, Cin, H, W below.
HALO_CASES = (("k3s1", dict(stride=1, padding=1)),
              ("k3s2", dict(stride=2, padding=1)),
              ("k5d2s1", dict(stride=1, padding=2, dilation=2)))
HALO_SHAPE = (2, 3, 64, 64)
HALO_COUT = 5


def matrix_cells(cp):
    """JAX's 9 cells (``tests/test_conv_parallel.py``): (tag, weight key,
    spec kind, spec kwargs, policy, the event the cell must record)."""
    s2 = dict(stride=2, padding=1)
    s1 = dict(stride=1, padding=1)
    ts = dict(stride=2, padding=1, output_padding=1)
    return [
        ("reg s2 data+h+cout", "w", "reg", s2,
         cp.ConvParallel(batch=("data",), h="model", cout="sw"),
         "mesh:conv2d:data+h+cout"),
        ("reg s1 data+h+w", "w", "reg", s1,
         cp.ConvParallel(batch=("data",), h="model", w="sw"),
         "mesh:conv2d:data+h+w"),
        ("reg s2 cin+cout", "w", "reg", s2,
         cp.ConvParallel(cin="data", cout="model"), "mesh:conv2d:cin+cout"),
        ("reg s2 w only", "w", "reg", s2, cp.ConvParallel(w="sw"),
         "mesh:conv2d:w"),
        ("reg dil2 data+h", "w", "reg",
         dict(stride=1, padding=2, dilation=2),
         cp.ConvParallel(batch=("data",), h="model"), "mesh:conv2d:data+h"),
        ("reg s1 policy tp", "w", "reg", s1, "tp", "mesh:conv2d:data+cout"),
        ("tsp data+h+cin", "wt", "tsp", ts,
         cp.ConvParallel(batch=("data",), h="model", cin="sw"),
         "mesh:conv2d_T:data+h+cin"),
        ("tsp h+w", "wt", "tsp", ts, cp.ConvParallel(h="model", w="sw"),
         "mesh:conv2d_T:h+w"),
        ("tsp data+cout", "wt", "tsp", ts,
         cp.ConvParallel(batch=("data",), cout="model"),
         "mesh:conv2d_T:data+cout"),
    ]


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _mesh_events(C) -> dict:
    return {k: v for k, v in C.dispatch_events().items()
            if k.startswith("mesh")}


def run_matrix(inputs, arrays, out, LM, C, cp, ConvSpec, ConvTransposeSpec):
    mesh = LM.make_mesh((2, 2, 2), ("data", "model", "sw"))
    x = torch.from_numpy(inputs["x"])
    for policy in POLICIES:
        for tag, wkey, kind, kw, par, want in matrix_cells(cp):
            w = torch.from_numpy(inputs[wkey])
            if kind == "reg":
                spec, conv = ConvSpec.make(**kw), C.conv2d
            else:
                spec, conv = ConvTransposeSpec.make(**kw), C.conv2d_transpose
            xg = x.clone().requires_grad_(True)
            wg = w.clone().requires_grad_(True)
            C.reset_dispatch_events()
            with cp.conv_mesh(par, mesh):
                y = conv(xg, wg, spec, policy)
                torch.sin(y).sum().backward()
            key = f"{policy}|{tag}"
            out["matrix"][key] = {
                "events": _mesh_events(C), "want_event": want,
                "digest": _digest(y, xg.grad, wg.grad)}
            arrays[key + "|y"] = y.detach().numpy()
            arrays[key + "|dx"] = xg.grad.numpy()
            arrays[key + "|dw"] = wg.grad.numpy()
            # The same pass on one rank, unsharded: what the mesh changes.
            xg = x.clone().requires_grad_(True)
            wg = w.clone().requires_grad_(True)
            y = conv(xg, wg, spec, policy)
            torch.sin(y).sum().backward()
            arrays[key + "|y1"] = y.detach().numpy()
            arrays[key + "|dx1"] = xg.grad.numpy()
            arrays[key + "|dw1"] = wg.grad.numpy()
        # JAX's fallback case: indivisible B and H run replicated, exact.
        x3 = torch.from_numpy(inputs["x3"])
        w = torch.from_numpy(inputs["w"])
        spec = ConvSpec.make(stride=1, padding=1)
        C.reset_dispatch_events()
        with cp.conv_mesh(cp.ConvParallel(batch=("data",), h="model"), mesh):
            y = C.conv2d(x3, w, spec, policy)
        fb = {"events": _mesh_events(C),
              "reasons": [p["reason"] for p in C.policy_decisions()
                          if p["pass"] == "mesh"]}
        y_ref = C.conv2d(x3, w, spec, policy)
        fb["err"] = float((y - y_ref).abs().max())
        out["fallback"][policy] = fb


def run_halo_audit(out, LM, C, cp, ConvSpec, config, obs_events):
    """The ``halo`` events' bytes summed on this rank, per case, for a
    forward sharded over H on 8 ranks."""
    mesh = LM.make_mesh((WORLD,), ("model",))
    x = torch.ones(HALO_SHAPE)
    config.update(telemetry=True)
    try:
        for name, kw in HALO_CASES:
            spec = ConvSpec.make(**kw)
            w = torch.ones(HALO_COUT, HALO_SHAPE[1], 3, 3)
            obs_events.reset()
            with cp.conv_mesh(cp.ConvParallel(h="model"), mesh):
                C.conv2d(x, w, spec, "lax")
            ev = obs_events.events("halo")
            out["halo"][name] = {
                "bytes": sum(e["tags"]["bytes"] for e in ev),
                "sends": len(ev)}
    finally:
        config.update(telemetry=False)


def run_autoencoder(inputs, out, LM, C):
    from repro_torch.models import autoencoder as AE
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    mesh = LM.make_mesh((4, 2), ("data", "model"))
    cfg = AE.AutoencoderConfig(c_in=3, widths=(16, 32), k=3,
                               conv_policy="pallas")
    names = sorted(k for k in inputs.files if k.startswith("ae_"))
    batch = {"image": torch.from_numpy(inputs["image"])}
    for policy in AE_POLICIES:
        params = {"enc": [], "dec": []}
        for k in names:                   # ae_<stage>_<i>
            _, stage, i = k.split("_")
            params[stage].append({"w": torch.from_numpy(inputs[k].copy())})
        opt = adamw.init_state(params)
        step_fn = make_train_step(cfg, adamw.AdamWConfig(peak_lr=1e-3),
                                  total_steps=10, warmup=1,
                                  loss=AE.autoencoder_loss,
                                  conv_mesh=policy)
        C.reset_dispatch_events()
        losses = []
        with mesh:
            for s in range(AE_STEPS):
                params, opt, m = step_fn(params, opt, batch, s)
                losses.append(float(m["loss"]))
        out["autoencoder"][policy] = {
            "losses": losses, "events": _mesh_events(C),
            "params": _digest(*tree_leaves(params)),
            "opt": _digest(*tree_leaves(tree_map(
                lambda t: t.float(), opt)))}


def rank_main(rank: int, in_dir: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "pg"),
        rank=rank, world_size=WORLD)
    from repro_torch.core import conv as C
    from repro_torch.core.config import config
    from repro_torch.core.convspec import ConvSpec, ConvTransposeSpec
    from repro_torch.dist import conv_parallel as cp
    from repro_torch.launch import mesh as LM
    from repro_torch.obs import events as obs_events
    inputs = np.load(os.path.join(in_dir, "inputs.npz"))
    out = {"rank": rank, "matrix": {}, "fallback": {}, "halo": {},
           "autoencoder": {}}
    arrays: dict = {}
    run_matrix(inputs, arrays, out, LM, C, cp, ConvSpec, ConvTransposeSpec)
    run_halo_audit(out, LM, C, cp, ConvSpec, config, obs_events)
    run_autoencoder(inputs, out, LM, C)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    if rank == 0:
        np.savez(os.path.join(out_dir, "arrays.npz"), **arrays)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(sys.argv[1], sys.argv[2]), nprocs=WORLD)
