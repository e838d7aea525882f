"""The ranks of ``tests/test_torch_spmd.py``: 8 gloo processes on the CPU.

    python tests/_torch_spmd_worker.py IN_DIR OUT_DIR

``IN_DIR/inputs.pkl`` holds the inputs the test made (the JAX package's
initial parameters as numpy trees, the batches drawn from a seed).  Each
rank runs every case on a ``(data=4, model=2)`` mesh and writes
``OUT_DIR/rank<r>.json``; the blocked state of the SmolLM run is saved to
``OUT_DIR/ckpt`` after its second step, and rank 0 writes the gathered
parameters of that step as ``OUT_DIR/saved.npz``; rank 0 also runs the
whole-tensor paths of ``CONV_FAMILIES`` through the layers and through
``tests/_torch_whole_layers.py``.  Each rank also holds the mesh's
collectives (``Mesh.psum``, ``psum_scatter``, ``psum_scatter_flat``) and
the step's grad sync and fold (``SYNC_CASES``) to copies of the
gather-and-add forms they replace (:func:`old_psum`, :func:`old_fold`,
:func:`old_sync`).  Imports torch and the port only: the JAX side of each
comparison runs in the test.
"""

from __future__ import annotations

import contextlib
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
#: the families whose layers host the paper's conv, under ``tp`` with the
#: depthwise conv on the tap kernels' plain versions and the mesh hook:
#: case -> (arch, params of inputs.pkl).
CONV_FAMILIES = {"mamba2_tp": ("mamba2-370m", "m2_params"),
                 "hybrid_tp": ("recurrentgemma-9b", "rg_params")}
#: the frontends under ``tp`` (``frontend_proj`` on its ``d_model``
#: columns): case -> (arch, params of inputs.pkl, batch of inputs.pkl).
#: internvl2's smoke config has one KV head, so it also runs the MQA rule.
FRONTEND_CASES = {"vlm_tp": ("internvl2-76b", "vlm_params", "vlm_batch"),
                  "audio_tp": ("hubert-xlarge", "audio_params",
                               "audio_batch")}
#: the configs whose whole-tensor paths ``run_whole_paths`` holds to the
#: layers before MLA, the frontends and MTP computed on blocks: case ->
#: (arch, params, batch of inputs.pkl, whether it serves).
BLOCK_FAMILIES = {"deepseek": ("deepseek-v3-671b", "ds_params", "lm_batch",
                               True),
                  "vlm": FRONTEND_CASES["vlm_tp"] + (False,),
                  "audio": FRONTEND_CASES["audio_tp"] + (False,)}
#: the cases whose first step's fold and grad sync are held to the
#: gather-and-add forms (:func:`holding_sync`): case -> (arch, params of
#: inputs.pkl).
SYNC_CASES = {"smollm_tp": ("smollm-360m", "lm_params"),
              "moe_tp": ("moonshot-v1-16b-a3b", "moe_params"),
              "mamba2_tp": ("mamba2-370m", "m2_params"),
              "deepseek_tp": ("deepseek-v3-671b", "ds_params")}
#: the step after which the SmolLM run saves its blocked state.
SAVE_AFTER = 1
LR = 1e-3


def _nbytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def run_sharded(mesh, cfg, params, batch, policy, out_dir=None,
                hold_sync=False, **kw):
    """``STEPS`` steps of ``make_train_step(cfg, **kw)`` through
    ``sharded_step`` on blocks under ``policy``; the losses, grad norms
    (and ``moe_lb`` where the model has it), blocks' bytes and the
    gathered parameters' digest; for an MoE model, the (token, choice)
    pairs of this rank's tokens that its MoE layers dropped at step 0;
    with ``hold_sync``, step 0's fold and grad sync held to the old forms
    (:func:`holding_sync`, under ``"sync_check"``)."""
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
                contextlib.nullcontext([]) as log, \
                holding_sync(res.setdefault("sync_check", {})) \
                if s == 0 and hold_sync else contextlib.nullcontext():
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
        for key in ("gathered_bytes", "computed_bytes"):
            res.setdefault(key, []).append(step_fn.layout.stats[key])
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
        out[case] = _count_collectives(
            lambda: run(case, hold_sync=case in SYNC_CASES))

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
        # Every rank's blocks' squares summed over the mesh, a replicated
        # block's once per rank that holds it.
        sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
        total = mesh.psum(torch.stack(sq).sum().reshape(1),
                          ("data", TP.MODEL))
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


def _count_collectives(run):
    """``run()``'s result with the model collectives it made
    (``tensor_parallel.COUNTS``) under ``"collectives"``."""
    from repro_torch.dist import tensor_parallel as TP
    before = dict(TP.COUNTS)
    res = run()
    res["collectives"] = {k: TP.COUNTS[k] - v for k, v in before.items()}
    return res


def run_conv_families(mesh, inputs, batch) -> dict:
    """Mamba2 and recurrentgemma (``CONV_FAMILIES``) under ``tp``: Mamba2's
    heads, the RG-LRU's channels and the MQA query heads on their blocks,
    the depthwise conv on each rank's channel block (``pallas`` under
    ``conv_mesh="tp"``: its ``mesh:*`` events); then the three mutations:
    Mamba2's gated norm without the ``model`` sum of its squares, B and C
    not entering the heads' block, and a ``gather`` whose backward takes
    its slice of the unsummed grad."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import conv as C
    from repro_torch.dist import tensor_parallel as TP
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M2
    from repro_torch.tree import tree_from_numpy
    out = {}

    def run(case, hold_sync=False):
        arch, params = CONV_FAMILIES[case]
        C.reset_dispatch_events()
        res = _count_collectives(lambda: run_sharded(
            mesh, get_smoke_config(arch),
            tree_from_numpy(inputs[params], "cpu"), batch, "tp",
            hold_sync=hold_sync, conv_policy="pallas", conv_mesh="tp"))
        res["events"] = _mesh_events(C)
        return res
    for case in CONV_FAMILIES:
        out[case] = run(case, hold_sync=case in SYNC_CASES)

    class UnsummedGather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ax = TP.active()
            ctx.start, ctx.n = ax.index * x.shape[-1], x.shape[-1]
            return ax.mesh.all_gather(x, TP.MODEL, x.dim() - 1)

        @staticmethod
        def backward(ctx, g):
            return g.narrow(-1, ctx.start, ctx.n)
    mutants = {
        "ssm_norm_mutant": ("mamba2_tp", M2, "_norm_on_heads",
                            lambda p, y, width: L.rmsnorm(p, y)),
        "ssm_bc_mutant": ("mamba2_tp", M2, "_shared_into_heads",
                          lambda b, c: (b, c)),
        "gather_mutant": ("hybrid_tp", TP, "gather", UnsummedGather.apply)}
    for name, (case, module, attr, mutant) in mutants.items():
        sound = getattr(module, attr)
        setattr(module, attr, mutant)
        try:
            out[name] = run(case)
        finally:
            setattr(module, attr, sound)
    return out


def run_block_families(mesh, inputs) -> dict:
    """internvl2-76b and hubert-xlarge (``FRONTEND_CASES``) under ``tp``:
    ``frontend_proj`` on its ``d_model`` columns, its output gathered over
    ``model`` (``TP.join``); then the two mutations on DeepSeek-V3's
    (``MOE_CASES["deepseek_tp"]``): the rope key not entering MLA's heads,
    and a ``join`` whose backward sums the grad over ``model`` (the MTP
    head's ``mtp.proj``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import tensor_parallel as TP
    from repro_torch.models import attention as A
    from repro_torch.tree import tree_from_numpy
    out = {}
    for case, (arch, params, batch) in FRONTEND_CASES.items():
        out[case] = _count_collectives(lambda: run_sharded(
            mesh, get_smoke_config(arch),
            tree_from_numpy(inputs[params], "cpu"),
            tree_from_numpy(inputs[batch], "cpu"), "tp"))
    arch, params, toks = MOE_CASES["deepseek_tp"][:3]
    toks = tree_from_numpy(inputs[toks], "cpu")
    mutants = {
        "mla_rope_mutant": (A, "_latents_into_heads",
                            lambda cq, c, k: (TP.enter(cq), TP.enter(c), k)),
        "join_mutant": (TP, "join", TP.gather)}
    for name, (module, attr, mutant) in mutants.items():
        sound = getattr(module, attr)
        setattr(module, attr, mutant)
        try:
            out[name] = run_sharded(
                mesh, get_smoke_config("deepseek-v3-671b"),
                tree_from_numpy(inputs[params], "cpu"),
                {"tokens": toks, "targets": toks}, "tp")
        finally:
            setattr(module, attr, sound)
    return out


def run_whole_paths(inputs, batch) -> dict:
    """Serving (a prefill and 3 decode steps) and 2 unsharded steps of
    both ``CONV_FAMILIES`` configs and of ``BLOCK_FAMILIES`` (DeepSeek's
    serving: MLA's prefill and its absorbed decode; internvl2's and
    hubert's steps only) on whole tensors, through the layers as they are
    and through the layers as they were before any of them computed on
    ``model`` blocks (:mod:`_torch_whole_layers`): the logits', losses',
    norms' and parameters' digests of each."""
    import _torch_whole_layers as WL
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attention as A
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import model as M
    from repro_torch.models import recurrent as R
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    from repro_torch.tree import tree_from_numpy, tree_leaves

    def paths(cfg, params, batch, serve=True):
        outs = []
        if serve:
            logits, cache = M.prefill(params, batch["tokens"][:2, :16], cfg,
                                      24)
            outs.append(logits)
            tok = logits.argmax(-1)
            for pos in range(16, 19):
                logits, cache = M.decode_step(params, cache, tok, pos, cfg)
                outs.append(logits)
                tok = logits.argmax(-1)
        step = make_train_step(cfg, adamw.AdamWConfig(peak_lr=LR),
                               total_steps=10, warmup=1,
                               conv_policy="pallas")
        p, o, metrics = params, adamw.init_state(params), []
        for s in range(2):
            p, o, m = step(p, o, batch, s)
            metrics += [m["loss"], m["grad_norm"]]
        return {"serve": _digest(*outs), "train": _digest(*metrics),
                "params": _digest(*tree_leaves(p))}
    cases = {case: (arch, key, batch, True)
             for case, (arch, key) in CONV_FAMILIES.items()}
    cases.update({case: (arch, key, tree_from_numpy(inputs[b], "cpu"), serve)
                  for case, (arch, key, b, serve) in BLOCK_FAMILIES.items()})
    swaps = [(M2, "mamba2_block", WL.mamba2_block),
             (R, "recurrent_block", WL.recurrent_block),
             (A, "gqa_prefill", WL.gqa_prefill),
             (A, "mla_prefill", WL.mla_prefill),
             (M, "_embed_inputs", WL.embed_inputs),
             (M, "_mtp_forward", WL.mtp_forward)]
    out = {}
    for case, (arch, key, b, serve) in cases.items():
        cfg = get_smoke_config(arch)
        params = tree_from_numpy(inputs[key], "cpu")
        now = paths(cfg, params, b, serve)
        sound = [getattr(module, attr) for module, attr, _ in swaps]
        for module, attr, old in swaps:
            setattr(module, attr, old)
        try:
            before = paths(cfg, params, b, serve)
        finally:
            for (module, attr, _), fn in zip(swaps, sound):
                setattr(module, attr, fn)
        out[case] = {"now": now, "before": before}
    return out


def old_psum(mesh, t, axes):
    """The sum over ``axes`` as the mesh made it before the reduce-scatter:
    every rank's whole tensor gathered, then added in coordinate order."""
    for axis in axes:
        parts = mesh._gather(t, axis)
        t = parts[0].clone()
        for p in parts[1:]:
            t.add_(p)
    return t


def _whole(take, slices):
    """The whole leaf from every ``model`` rank's slice (``slices``, stacked
    in coordinate order): each own range from the rank that holds it,
    each shared range from coordinate 0."""
    m = slices.shape[0]
    shape = list(slices.shape[1:])
    dim = take.dim % len(shape)
    shape[dim] = sum(w for w, _ in take.parts)
    out = slices.new_empty(shape)
    for index in range(m):
        at = 0
        for s, n, own in take.ranges(m, index):
            if own or index == 0:
                out.narrow(dim, s, n).copy_(slices[index].narrow(dim, at, n))
            at += n
    return out


def old_fold(plan, grads):
    """``Plan.fold`` as it was: each taken leaf's slices gathered over
    ``model`` whole, put together, then cut to the stored block."""
    from repro_torch.dist import tensor_parallel as TP
    from repro_torch.dist.sharding import local_block
    from repro_torch.tree import tree_leaves, tree_unflatten
    out = []
    for g, s, leaf in zip(tree_leaves(grads), tree_leaves(plan.specs),
                          tree_leaves(plan.tree)):
        if leaf.take is not None:
            whole = _whole(leaf.take, plan.mesh.all_gather(g[None],
                                                           TP.MODEL, 0))
            only = TP.P(*(TP.MODEL if e == TP.MODEL else None for e in s))
            g = local_block(whole, only, plan.mesh).contiguous()
        out.append(g)
    return tree_unflatten(grads, out)


def old_sync(mesh, axes, leaves, plan):
    """The grads' blocks as the step made them before the reduce-scatter:
    every grad summed whole over the batch axes (:func:`old_psum`),
    coordinate 0's replicated grads broadcast over every other axis, then
    cut to the blocks."""
    from repro_torch.dist.sharding import local_block
    from repro_torch.tree import tree_leaves
    leaves = [old_psum(mesh, g, axes) for g in leaves]
    for axis, n in mesh.shape.items():
        if n > 1 and axis not in axes:
            mesh.broadcast([g for g, k in zip(leaves, plan.kept)
                            if not (k and axis == "model")], axis)
    return [local_block(g, s, mesh).contiguous() for g, s in
            zip(leaves, tree_leaves(plan.compute_specs))]


def run_collectives(mesh) -> dict:
    """``Mesh.psum`` over each axis and both, ``psum_scatter`` on each
    axis and ``psum_scatter_flat`` (a dim cut and whole tensors), in
    float32 and bf16, at lengths that divide and that do not: whether
    each is ``torch.equal`` to :func:`old_psum` (cut to this rank's
    block)."""
    from repro_torch.launch import mesh as LM
    gen = torch.Generator().manual_seed(11 + dist.get_rank())
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for shape in ((8, 6), (7, 3), (13,)):
            t = (torch.randn(*shape, generator=gen) * 100).to(dtype)
            key = f"{name} {'x'.join(map(str, shape))}"
            for axes in (("data",), ("model",), ("data", "model")):
                out[f"psum {key} {'+'.join(axes)}"] = torch.equal(
                    mesh.psum(t, axes), old_psum(mesh, t, axes))
            for axis in ("data", "model"):
                n, j = mesh.shape[axis], mesh.coordinate(axis)
                c = -(-shape[0] // n)
                out[f"psum_scatter {key} {axis}"] = torch.equal(
                    mesh.psum_scatter(t, axis),
                    old_psum(mesh, t, (axis,))[j * c:(j + 1) * c])
        ts = [(torch.randn(8, 6, generator=gen) * 10).to(dtype),
              torch.randn(5, generator=gen).to(dtype),
              torch.randn(2, 3, 8, generator=gen).to(dtype)]
        dims = [0, None, -1]
        for axis in ("data", "model"):
            n, j = mesh.shape[axis], mesh.coordinate(axis)
            want = []
            for t, d in zip(ts, dims):
                w = old_psum(mesh, t, (axis,))
                if d is not None:
                    w = w.narrow(d, j * (t.shape[d] // n), t.shape[d] // n)
                want.append(w)
            got = mesh.psum_scatter_flat(ts, axis, dims)
            out[f"psum_scatter_flat {name} {axis}"] = all(
                torch.equal(a, b) for a, b in zip(got, want))
    out["wire"] = dict(LM.WIRE)
    return out


@contextlib.contextmanager
def holding_sync(out: dict):
    """Inside, the step's ``Plan.fold`` and grad sync (``train_step._sync``)
    are each followed by :func:`old_fold` / :func:`old_sync` on copies of
    the same grads (every rank runs both at the same point): ``out`` gets
    whether each result is ``torch.equal`` to the old form's, leaf by
    leaf, and the bytes each sent and received
    (``tensor_parallel.COUNTS``) beside those of the old forms."""
    from repro_torch.dist import tensor_parallel as TP
    from repro_torch.launch import mesh as LM
    from repro_torch.train import train_step as TS
    from repro_torch.tree import tree_leaves
    sound_fold, sound_sync = TP.Plan.fold, TS._sync

    def wire(fn):
        w0 = dict(LM.WIRE)
        res = fn()
        return res, [LM.WIRE[k] - w0[k] for k in ("sent", "received")]

    def fold(plan, grads):
        old, old_bytes = wire(lambda: old_fold(plan, grads))
        before = dict(TP.COUNTS)
        res = sound_fold(plan, grads)
        out.update({k: TP.COUNTS[k] - before[k]
                    for k in ("fold_bytes", "fold_received")},
                   old_fold_sent=old_bytes[0],
                   old_fold_received=old_bytes[1],
                   fold_equal=all(torch.equal(a, b) for a, b in zip(
                       tree_leaves(res), tree_leaves(old))))
        return res

    def sync(mesh, axes, loss, metrics, grads, layout=None):
        copies = [g.clone() for g in tree_leaves(grads)]
        before = dict(TP.COUNTS)
        res = sound_sync(mesh, axes, loss, metrics, grads, layout)
        out.update({k: TP.COUNTS[k] - before[k]
                    for k in ("scatter_bytes", "scatter_received")})
        want, old_bytes = wire(lambda: old_sync(mesh, axes, copies,
                                                layout.plan))
        out.update(old_sync_sent=old_bytes[0],
                   old_sync_received=old_bytes[1], leaves=len(want),
                   sync_equal=all(torch.equal(a, b) for a, b in zip(
                       tree_leaves(res[2]), want)))
        return res
    TP.Plan.fold, TS._sync = fold, sync
    try:
        yield out
    finally:
        TP.Plan.fold, TS._sync = sound_fold, sound_sync


def run_dropping_scatter(mesh, cfg, params, batch) -> dict:
    """A mutation of the grad sync: the owner of each block adds every
    part but the next member's (a reduce-scatter that drops a part)."""
    from repro_torch.launch import mesh as LM
    sound_flat, sound_rows = LM.Mesh.psum_scatter_flat, \
        LM.Mesh._reduce_rows

    def dropping_rows(self, t, axis):
        j = self.coordinate(axis)
        got = self._all_to_all(list(t), [t[0].numel()] * t.shape[0], axis,
                               t)
        parts = [t[j] if i == j else p.view(t.shape[1:])
                 for i, p in enumerate(got)]
        drop = (j + 1) % len(parts)
        keep = [p for i, p in enumerate(parts) if i != drop]
        total = keep[0].clone()
        for p in keep[1:]:
            total.add_(p)
        return total

    def dropping_flat(self, *args, **kw):
        LM.Mesh._reduce_rows = dropping_rows
        try:
            return sound_flat(self, *args, **kw)
        finally:
            LM.Mesh._reduce_rows = sound_rows
    LM.Mesh.psum_scatter_flat = dropping_flat
    try:
        return run_sharded(mesh, cfg, params, batch, "tp")
    finally:
        LM.Mesh.psum_scatter_flat = sound_flat


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
                                   out_dir=out_dir, hold_sync=True)

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
    out.update(run_conv_families(mesh, inputs, lm_batch))
    out.update(run_block_families(mesh, inputs))
    out["collectives_check"] = run_collectives(mesh)
    out["sync_cases"] = {case: out[case].pop("sync_check")
                         for case in SYNC_CASES}
    out["scatter_mutant"] = run_dropping_scatter(mesh, cfg, lm_params,
                                                 lm_batch)
    if rank == 0:
        out["whole_paths"] = run_whole_paths(inputs, lm_batch)

    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(sys.argv[1], sys.argv[2]), nprocs=WORLD)
