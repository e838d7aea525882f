"""Plan-level dry run of the production meshes (counterpart of the plan
checks of ``repro.launch.dryrun``).

For each (architecture x shape x mesh) cell it builds the full-width
model's parameters, AdamW moments, batch and decode cache as SHAPES only
(``meta`` tensors: nothing is allocated), takes their
``repro_torch.dist.sharding`` spec trees on the abstract production mesh
(``launch.mesh.make_production_mesh``), and reports the bytes each device
would hold of each, and the cell's analytic ``model_flops`` (6 · N ·
tokens to train, 2 · N · tokens to prefill, 2 · N a token to decode,
expert weights at top_k / E; :func:`model_flops`).  There is no HLO and
no compile, so the JAX dry run's HLO-derived FLOP, bytes-accessed and
collective counts have no counterpart here; the conv cell's halo bytes
come from its plans (the bytes the ``halo`` events of a sharded run
record).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --conv spatial

The conv cell plans every conv of the autoencoder's training step on the
production mesh under a ``conv_parallel`` policy, records the drops, and
fails when no conv is sharded.  Reports land in
``reports/dryrun/<arch>__<shape>__<mesh>.json``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.configs import (SHAPES, ShapeCfg, all_arch_ids,
                                 applicable_shapes, get_config)
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.tree import tree_leaves

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "dryrun")

META = torch.device("meta")


def _spec_leaves(specs) -> list:
    """The specs of a spec tree in the order ``tree_leaves`` walks the
    tree they mirror (dict keys sorted)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, (list, tuple)):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


def bytes_per_device(tree, specs, mesh, dtype=None) -> int:
    """The bytes one device holds of ``tree`` under ``specs`` (every leaf
    cut into ``shard_count`` equal blocks); ``dtype`` overrides the
    leaves' (AdamW's float32 moments of bf16 parameters)."""
    total = 0
    for leaf, spec in zip(tree_leaves(tree), _spec_leaves(specs)):
        size = (torch.empty((), dtype=dtype).element_size() if dtype
                else leaf.element_size())
        total += leaf.numel() * size // SH.shard_count(spec, mesh)
    return total


def _nbytes(tree, dtype=None) -> int:
    return sum(x.numel() * (torch.empty((), dtype=dtype).element_size()
                            if dtype else x.element_size())
               for x in tree_leaves(tree))


def input_specs(cfg: ArchConfig, shape: ShapeCfg) -> dict:
    """The batch of a shape as ``meta`` tensors (no allocation)."""
    b, seq = shape.global_batch, shape.seq_len

    def sd(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=META)
    f32, i32 = torch.float32, torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            batch = {"frontend": sd((b, seq, cfg.d_frontend), f32),
                     "targets": sd((b, seq), i32)}
        elif cfg.family == "vlm":
            lt = seq - cfg.frontend_tokens
            batch = {"tokens": sd((b, lt), i32), "targets": sd((b, lt), i32),
                     "frontend": sd((b, cfg.frontend_tokens,
                                     cfg.d_frontend), f32)}
        else:
            batch = {"tokens": sd((b, seq), i32),
                     "targets": sd((b, seq), i32)}
        if shape.kind == "prefill":
            batch.pop("targets", None)
        return batch
    return {"tokens": sd((b,), i32)}


def plan_cell(cfg: ArchConfig, shape: ShapeCfg, mesh,
              policy: str = "tp") -> dict:
    """Bytes per device of one cell's state under ``policy``'s specs, and
    the cell's :func:`model_flops`."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    params = M.build_model(cfg).init(torch.Generator().manual_seed(0), META)
    p_spec = SH.param_specs(params, mesh, policy)
    per_dev = {"params": bytes_per_device(params, p_spec, mesh)}
    total = {"params": _nbytes(params)}
    if shape.kind == "train":
        o_spec = SH.opt_state_specs(params, mesh, policy)
        per_dev["adamw_moments"] = 2 * bytes_per_device(
            params, o_spec["m"], mesh, torch.float32)
        total["adamw_moments"] = 2 * _nbytes(params, torch.float32)
    batch = input_specs(cfg, shape)
    per_dev["batch"] = bytes_per_device(
        batch, SH.batch_specs(batch, mesh, policy), mesh)
    total["batch"] = _nbytes(batch)
    if shape.kind in ("decode", "long_decode"):
        cache = T.init_cache(cfg, shape.global_batch, shape.seq_len, META)
        per_dev["cache"] = bytes_per_device(
            cache, SH.cache_specs(cache, mesh, policy), mesh)
        total["cache"] = _nbytes(cache)
    per_dev["total"] = sum(per_dev.values())
    total["total"] = sum(total.values())
    replicated = sum(1 for s in _spec_leaves(p_spec)
                     if SH.shard_count(s, mesh) == 1)
    return {"bytes_per_device": per_dev, "bytes_global": total,
            "param_count": sum(x.numel() for x in tree_leaves(params)),
            "param_leaves": len(tree_leaves(params)),
            "replicated_param_leaves": replicated,
            "model_flops": model_flops(cfg, shape, params)}


def model_flops(cfg: ArchConfig, shape: ShapeCfg, params) -> float:
    """The analytic FLOPs of one cell (JAX's ``model_flops``): 6 · N ·
    tokens to train, 2 · N · tokens to prefill, 2 · N · the batch to
    decode one token a sequence; for an MoE config N counts each leaf
    whose path names ``moe``, of at least 3 dims, whose third-last dim is
    the expert count, at top_k / E of its size.  ``params`` may be ``meta``
    tensors."""
    n_params = sum(x.numel() for x in tree_leaves(params))
    if cfg.n_experts:
        total = 0

        def walk(tree, path):
            nonlocal total
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, path + (k,))
                return
            if "moe" in "/".join(path) and tree.dim() >= 3 \
                    and tree.shape[-3] == cfg.n_experts:
                total += tree.numel() * cfg.moe_top_k // cfg.n_experts
            else:
                total += tree.numel()
        walk(params, ())
        n_params = total
    if shape.kind in ("train", "prefill"):
        tokens = shape.global_batch * shape.seq_len
        mult = 6 if shape.kind == "train" else 2
    else:
        tokens = shape.global_batch
        mult = 2
    return float(mult) * n_params * tokens


def _write(report_dir: str, name: str, result: dict) -> str:
    os.makedirs(report_dir, exist_ok=True)
    path = os.path.join(report_dir, name + ".json")
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return path


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             report_dir: str = REPORT_DIR, policy: str = "tp",
             tag: str = "") -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh.name,
              "policy": policy, "n_devices": mesh.size, "kind": shape.kind,
              **plan_cell(cfg, shape, mesh, policy)}
    suffix = f"__{tag}" if tag else ""
    _write(report_dir, f"{arch}__{shape_name}__{mesh.name}{suffix}", result)
    per = result["bytes_per_device"]
    print(f"[dryrun] {arch} {shape_name} mesh={mesh.name} policy={policy} "
          + " ".join(f"{k}={v / 1e9:.3f}GB" for k, v in per.items())
          + f" per device model_flops={result['model_flops']:.3e}",
          flush=True)
    return result


def _halo_bytes(plan, x_shape, itemsize: int) -> int:
    """The bytes one device sends in one halo exchange of ``plan`` (the
    sum of the ``halo`` events of one gather or scatter) over the plane
    ``x_shape``: the kept taps' rows or columns of this shard's block.
    The exchanged plane carries Cin (a regular conv's input) or Cout (a
    transposed conv's output, its mirror input)."""
    b = x_shape[0] // plan.size(plan.batch)
    c = x_shape[1] // plan.size(plan.cout if plan.transposed else plan.cin)
    h = x_shape[2] // plan.size(plan.h)
    w = x_shape[3] // plan.size(plan.w)
    total = 0
    if plan.h:
        total += (max(plan.halo_h[0], 0) + max(plan.halo_h[1], 0)) * b * c * w
        h += plan.halo_h[0] + plan.halo_h[1]
    if plan.w:
        total += (max(plan.halo_w[0], 0) + max(plan.halo_w[1], 0)) * b * c * h
    return total * itemsize


def run_conv_cell(policy: str = "tp", multi_pod: bool = False,
                  report_dir: str = REPORT_DIR, tag: str = "") -> dict:
    """Plan every conv of the autoencoder's training step on the
    production mesh under the ``conv_parallel`` policy ``policy`` and FAIL
    when none is sharded (silent replication).

    ``tp`` shards batch over "data" and Cout over "model", ``dp_only`` the
    batch over every axis, ``spatial`` batch over "data" and H over
    "model" with the halo exchange (then the cell must exchange halos).
    A conv the mesh cannot shard (the decoder's Cout 3 under ``tp``) drops
    the role with its reason, which lands in the report; so do the halo
    bytes one device sends per exchange, and per step (three passes a
    conv, each one exchange)."""
    from repro_torch.core import conv as C
    from repro_torch.dist import conv_parallel as cp
    from repro_torch.dist.constraints import set_activation_policy
    from repro_torch.models import autoencoder as AE
    mesh = make_production_mesh(multi_pod=multi_pod)
    param_policy = "tp_rep" if policy == "spatial" else policy
    set_activation_policy(SH.batch_axes(mesh, param_policy))
    acfg = AE.AutoencoderConfig(c_in=3, widths=(16, 32), k=3,
                                conv_policy="lax")
    n_batch = 1
    for a in SH.batch_axes(mesh, param_policy):
        n_batch *= mesh.shape[a]
    b, size = 2 * n_batch, 64
    params = AE.init_autoencoder(torch.Generator().manual_seed(0), acfg,
                                 META)
    p_spec = SH.param_specs(params, mesh, param_policy)
    batch = {"image": torch.empty((b, acfg.c_in, size, size), device=META)}
    convs = []

    def record(x, w, spec, conv_policy):
        par = cp.ConvParallel.coerce(policy, mesh)
        plan = cp.plan_conv_sharding(x.shape, w.shape, spec, par, mesh)
        cp._record_plan(plan, policy)
        x_plane = (tuple(x.shape) if not plan.transposed else
                   C.conv_transpose_output_shape(x.shape, w.shape, spec))
        convs.append({"x": list(x.shape), "w": list(w.shape),
                      "transposed": plan.transposed, "tag": plan.tag,
                      "halo": [list(plan.halo_h), list(plan.halo_w)],
                      "halo_bytes_per_exchange": _halo_bytes(
                          plan, x_plane, x.element_size()),
                      "dropped": [list(d) for d in plan.dropped]})
        return NotImplemented

    C.reset_dispatch_events()
    hook, C.MESH_LOWERING = C.MESH_LOWERING, record
    try:
        with torch.no_grad():
            AE.autoencoder_loss(params, batch, acfg)
    finally:
        C.MESH_LOWERING = hook
    events = {k: v for k, v in C.dispatch_events().items()
              if k.startswith("mesh:")}
    sharded = sum(v for k, v in events.items()
                  if k.startswith("mesh:conv2d"))
    fallbacks = [p["reason"] for p in C.policy_decisions()
                 if p["pass"] == "mesh"]
    if sharded == 0:
        raise SystemExit(
            f"[dryrun] conv cell policy={policy}: NO conv took the sharded "
            f"path (silent replication); events={events} "
            f"reasons={fallbacks}")
    halo_step = 3 * sum(c["halo_bytes_per_exchange"] for c in convs)
    if policy == "spatial" and halo_step == 0:
        raise SystemExit(
            f"[dryrun] conv cell policy=spatial plans no halo exchange; "
            f"events={events}")
    result = {"arch": acfg.name, "shape": f"ae_train_{size}",
              "mesh": mesh.name, "policy": policy, "n_devices": mesh.size,
              "kind": "train", "batch": b, "mesh_events": events,
              "sharded_convs": sharded, "fallback_reasons": fallbacks,
              "convs": convs, "halo_bytes_per_step_per_device": halo_step,
              "param_bytes_per_device": bytes_per_device(params, p_spec,
                                                         mesh)}
    suffix = f"__{tag}" if tag else ""
    _write(report_dir, f"{acfg.name}__conv_{policy}__{mesh.name}{suffix}",
           result)
    print(f"[dryrun] conv cell policy={policy} mesh={mesh.name} "
          f"sharded_convs={sharded} halo={halo_step}B/step/device "
          f"events={events}", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--report-dir", default=REPORT_DIR)
    ap.add_argument("--policy", default="tp",
                    choices=["tp", "dp_only", "tp_rep"])
    ap.add_argument("--conv", default=None,
                    choices=["tp", "dp_only", "spatial"],
                    help="plan the mesh-parallel conv autoencoder cell "
                         "under this conv_parallel policy instead of the "
                         "LM cells")
    ap.add_argument("--tag", default="",
                    help="suffix for the report file")
    args = ap.parse_args(argv)

    if args.conv:
        return [run_conv_cell(args.conv, multi_pod=args.multi_pod,
                              report_dir=args.report_dir, tag=args.tag)]
    if args.all:
        cells = [(a, s) for a in all_arch_ids()
                 for s in applicable_shapes(get_config(a))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all, or --conv)")
        cells = [(args.arch, args.shape)]
    out = [run_cell(a, s, args.multi_pod, args.report_dir,
                    policy=args.policy, tag=args.tag) for a, s in cells]
    print(f"[dryrun] all {len(cells)} cells planned")
    return out


if __name__ == "__main__":
    main()
