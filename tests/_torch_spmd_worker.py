"""The ranks of ``tests/test_torch_spmd.py``: 8 gloo processes on the CPU.

    python tests/_torch_spmd_worker.py IN_DIR OUT_DIR

``IN_DIR/inputs.pkl`` holds the inputs the test made (the JAX package's
initial parameters as numpy trees, the batches drawn from a seed).  Each
rank runs every case on a ``(data=4, model=2)`` mesh and writes
``OUT_DIR/rank<r>.json``; the blocked state of the SmolLM run is saved to
``OUT_DIR/ckpt`` after its second step, and rank 0 writes the gathered
parameters of that step as ``OUT_DIR/saved.npz``.  Imports torch and the
port only: the JAX side of each comparison runs in the test.
"""

from __future__ import annotations

import json
import os
import pickle
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from _torch_mesh_worker import _digest, _mesh_events

WORLD = 8
SHAPE = (4, 2)
STEPS = 3
AE_POLICIES = ("tp", "dp_only", "spatial")
#: the MoE cases: name -> (arch, params, tokens of inputs.pkl, policy,
#: accum_steps).  At 8 x 64 one group of 512 tokens spans the 4 data
#: blocks (straddled); at 8 x 500 dp_only cuts 8 blocks of 500 tokens
#: across groups of 800 (partial); "moe_capacity" favours one expert, so
#: its queue overflows within the straddled group at step 0.
MOE_CASES = {
    "moe_tp": ("moonshot", "moe_params", "tokens_64", "tp", 1),
    "moe_dp_only": ("moonshot", "moe_params", "tokens_500", "dp_only", 1),
    "deepseek_tp": ("deepseek", "ds_params", "tokens_64", "tp", 1),
    "moe_capacity": ("moonshot", "cap_params", "tokens_64", "tp", 1),
    "moe_accum": ("moonshot", "moe_params", "tokens_64", "tp", 2),
}
#: SmolLM's smoke config with heads that divide by model = 2 (its 3
#: query heads and 1 KV head do not), on both sides.
HEADS = {"n_heads": 4, "n_kv_heads": 2}
#: the step after which the SmolLM run saves its blocked state.
SAVE_AFTER = 1
LR = 1e-3


def _nbytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def run_sharded(mesh, cfg, params, batch, policy, out_dir=None, **kw):
    """``STEPS`` steps of ``make_train_step(cfg, **kw)`` through
    ``sharded_step`` on blocks under ``policy``; the losses, grad norms
    (and ``moe_lb`` where the model has it), blocks' bytes and the
    gathered parameters' digest; for an MoE model, the (token, choice)
    pairs of this rank's tokens that its MoE layers dropped at step 0."""
    import contextlib

    from repro_torch.ckpt import checkpoint as CKPT
    from repro_torch.dist import set_activation_policy
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.spmd import sharded_step
    from repro_torch.models import moe as MOE
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    from repro_torch.tree import tree_leaves
    p_policy = "tp_rep" if policy == "spatial" else policy
    set_activation_policy(SH.batch_axes(mesh, policy))
    p_spec = SH.param_specs(params, mesh, p_policy)
    o_spec = SH.opt_state_specs(params, mesh, p_policy)
    b_spec = SH.batch_specs(batch, mesh, policy)
    step_fn = sharded_step(make_train_step(
        cfg, adamw.AdamWConfig(peak_lr=LR), total_steps=10, warmup=1, **kw),
        mesh, p_spec, o_spec, b_spec)
    p = SH.to_local(params, p_spec, mesh)
    o = SH.to_local(adamw.init_state(params), o_spec, mesh)
    b = SH.to_local(batch, b_spec, mesh)
    res = {"losses": [], "grad_norms": [],
           "param_bytes": _nbytes(p), "moment_bytes": _nbytes(o["m"])
           + _nbytes(o["v"]), "rows": tree_leaves(b)[0].shape[0]}
    n_moe = sum(map(cfg.is_moe_layer, range(cfg.n_layers))) \
        if getattr(cfg, "family", None) == "moe" else 0
    plan = step_fn.layout.plan
    res["plan"] = plan.table()
    for s in range(STEPS):
        with MOE.recording() if s == 0 and n_moe else \
                contextlib.nullcontext([]) as log:
            p, o, m = step_fn(p, o, b, s)
        if log:
            # The forward's calls come first; remat logs them again.
            res["dropped"] = int(sum((~r["kept"]).sum()
                                     for r in log[:n_moe]))
            res["experts_computed"] = sorted({r["experts_computed"]
                                              for r in log})
            res["routes"] = [{"first": r["first"],
                              "experts": r["experts"].tolist(),
                              "kept": r["kept"].tolist()}
                             for r in log[:n_moe]]
        res.setdefault("gathered_bytes", []).append(
            step_fn.layout.stats["gathered_bytes"])
        res["losses"].append(float(m["loss"]))
        res["grad_norms"].append(float(m["grad_norm"]))
        if "moe_lb" in m:
            res.setdefault("moe_lb", []).append(float(m["moe_lb"]))
        if out_dir is not None and s == SAVE_AFTER:
            CKPT.save(os.path.join(out_dir, "ckpt"), s,
                      {"params": p, "opt": o},
                      specs={"params": p_spec, "opt": o_spec}, mesh=mesh)
            saved = SH.gather_tree(p, p_spec, mesh)
            if dist.get_rank() == 0:
                import numpy as np
                from repro_torch.ckpt.checkpoint import _leaf_paths
                np.savez(os.path.join(out_dir, "saved.npz"),
                         **{".".join(k): v.numpy()
                            for k, v in _leaf_paths(saved)})
    whole = SH.gather_tree(p, p_spec, mesh)
    res["params"] = _digest(*tree_leaves(whole))
    res["replicated"] = _digest(*(t for t, k in zip(tree_leaves(whole),
                                                    plan.kept) if not k))
    set_activation_policy(None)
    return res


def run_replicated(mesh, cfg, params, batch, policy, **kw):
    """Path A: the parameters replicated, the batch this rank's block,
    ``make_train_step`` under ``with mesh:``."""
    from repro_torch.dist import set_activation_policy
    from repro_torch.dist import sharding as SH
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    set_activation_policy(SH.batch_axes(mesh, policy))
    step_fn = make_train_step(cfg, adamw.AdamWConfig(peak_lr=LR),
                              total_steps=10, warmup=1, **kw)
    b = SH.to_local(batch, SH.batch_specs(batch, mesh, policy), mesh)
    p, o = params, adamw.init_state(params)
    res = {"losses": [], "grad_norms": [],
           "mask_count": float(b["loss_mask"].sum())}
    with mesh:
        for s in range(STEPS):
            p, o, m = step_fn(p, o, b, s)
            res["losses"].append(float(m["loss"]))
            res["grad_norms"].append(float(m["grad_norm"]))
    set_activation_policy(None)
    return res


def run_moe(mesh, inputs) -> dict:
    """The MoE family on batch blocks (``MOE_CASES``), then the two
    mutations: each rank's own group arithmetic (its tokens as the whole
    batch: its groups, capacity and queue) on the capacity-binding case,
    and ``moe_lb`` as the mean of each rank's own product."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe as MOE
    from repro_torch.tree import tree_from_numpy
    out = {}
    cfgs = {"moonshot": get_smoke_config("moonshot-v1-16b-a3b"),
            "deepseek": get_smoke_config("deepseek-v3-671b")}

    def run(case, **kw):
        arch, params, batch, policy, accum = MOE_CASES[case]
        toks = tree_from_numpy(inputs[batch], "cpu")
        return run_sharded(mesh, cfgs[arch],
                           tree_from_numpy(inputs[params], "cpu"),
                           {"tokens": toks, "targets": toks}, policy,
                           accum_steps=accum, **kw)
    for case in MOE_CASES:
        out[case] = run(case)

    sound_layout, sound_aux = MOE._layout, MOE._aux_shares

    def own_groups(t, first, t_loc):
        s = t_loc // MOE._group(t_loc)
        return s, first, t_loc // s

    def own_product(logits, probs, top1, t):
        aux = sound_aux(logits, probs, top1, t)
        e, t_loc = probs.shape[-1], probs.shape[0]
        frac = torch.nn.functional.one_hot(probs.argmax(-1), e).float()
        lb = e * torch.sum(frac.mean(0) * probs.mean(0))
        return {**aux, "moe_lb": lb * t_loc / t}
    try:
        MOE._layout = own_groups
        out["moe_groups_mutant"] = run("moe_capacity")
    finally:
        MOE._layout = sound_layout
    try:
        MOE._aux_shares = own_product
        out["moe_lb_mutant"] = run("moe_tp")
    finally:
        MOE._aux_shares = sound_aux
    return out


def run_heads(mesh, cfg, inputs, batch) -> dict:
    """SmolLM with ``HEADS`` under ``tp``: attention on its column and row
    blocks; then the two tensor-parallel mutations: ``wo``'s partial
    outputs not summed over ``model`` (on this case), and a norm that
    counts each replicated leaf once per ``model`` rank (on SmolLM's own
    case, whose attention is replicated)."""
    import dataclasses

    from repro_torch.dist import tensor_parallel as TP
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.tree import tree_from_numpy, tree_leaves
    heads = dataclasses.replace(cfg, **HEADS)
    params = tree_from_numpy(inputs["lm_heads_params"], "cpu")
    out = {"smollm_heads": run_sharded(mesh, heads, params, batch, "tp")}
    sound_out, sound_norm = A._out_proj, TP.global_norm

    def norm_per_rank(grads, plan):
        sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
        total = mesh.psum(torch.stack(sq).sum().reshape(1), (TP.MODEL,))
        return torch.sqrt(total[0])
    try:
        A._out_proj = lambda p, o, cut: L.linear(p, o)
        out["wo_psum_mutant"] = run_sharded(mesh, heads, params, batch,
                                            "tp")
    finally:
        A._out_proj = sound_out
    try:
        TP.global_norm = norm_per_rank
        out["norm_mutant"] = run_sharded(
            mesh, cfg, tree_from_numpy(inputs["lm_params"], "cpu"), batch,
            "tp")
    finally:
        TP.global_norm = sound_norm
    return out


def rank_main(rank: int, in_dir: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "pg"),
        rank=rank, world_size=WORLD)
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import conv as C
    from repro_torch.dist import conv_parallel as cp
    from repro_torch.launch import mesh as LM
    from repro_torch.models import autoencoder as AE
    from repro_torch.train import losses
    from repro_torch.tree import tree_from_numpy
    with open(os.path.join(in_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    mesh = LM.make_mesh(SHAPE, ("data", "model"))
    cfg = get_smoke_config("smollm-360m")
    lm_params = tree_from_numpy(inputs["lm_params"], "cpu")
    lm_batch = tree_from_numpy(inputs["lm_batch"], "cpu")
    out = {"rank": rank, "coordinate": {a: mesh.coordinate(a)
                                        for a in mesh.axis_names}}

    # JAX's own case: SmolLM, tp, parameters, moments and batch in blocks.
    out["smollm_tp"] = run_sharded(mesh, cfg, lm_params, lm_batch, "tp",
                                   out_dir=out_dir)

    # A loss_mask whose count differs between the ranks' blocks (path A),
    # then the same with per-rank means averaged (a mutation).
    masked = {**lm_batch, "loss_mask": tree_from_numpy(
        inputs["loss_mask"], "cpu")}
    out["mask"] = run_replicated(mesh, cfg, lm_params, masked, "tp")
    sound = losses.batch_mean

    def mean_of_means(values, mask=None):
        blk = losses.current_block()
        n = 1
        for a in blk.axes:
            n *= blk.mesh.shape[a]
        if mask is None:
            return values.mean() / n
        return (values * mask).sum() / mask.sum().clamp(min=1.0) / n
    losses.batch_mean = mean_of_means
    try:
        out["mask_mutant"] = run_replicated(mesh, cfg, lm_params, masked,
                                            "tp")
    finally:
        losses.batch_mean = sound

    # The autoencoder's convs on the batch-local boundary, three policies.
    acfg = AE.AutoencoderConfig(c_in=3, widths=(16, 32), k=3,
                                conv_policy="pallas")
    ae_params = tree_from_numpy(inputs["ae_params"], "cpu")
    image = {"image": torch.from_numpy(inputs["image"])}
    for policy in AE_POLICIES:
        C.reset_dispatch_events()
        res = run_sharded(mesh, acfg, ae_params, image, policy,
                          loss=AE.autoencoder_loss, conv_mesh=policy)
        res["events"] = _mesh_events(C)
        out[f"ae_{policy}"] = res

    # A mutation: the conv psums its weight grad over the batch axes on a
    # batch block too, so the step counts it once per batch block again.
    sound_axes = cp._wgrad_axes
    cp._wgrad_axes = lambda plan: plan.batch + tuple(
        a for a in (plan.h, plan.w) if a)
    try:
        out["ae_wgrad_mutant"] = run_sharded(
            mesh, acfg, ae_params, image, "dp_only",
            loss=AE.autoencoder_loss, conv_mesh="dp_only")
    finally:
        cp._wgrad_axes = sound_axes

    out.update(run_moe(mesh, inputs))
    out.update(run_heads(mesh, cfg, inputs, lm_batch))

    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(sys.argv[1], sys.argv[2]), nprocs=WORLD)
