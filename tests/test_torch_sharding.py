"""The port's mesh planning against the JAX package on the CPU: the halo
export (``tap_span`` / ``shard_halo``), the conv planner
(``plan_conv_sharding``: roles, halos, ``transposed`` and the drop
reasons string for string, over a hypothesis sweep, JAX's fixed cases and
the paper's Table II layers under every policy), the spec trees of every
architecture at full width and of the autoencoder's convs, policy
resolution and the hook's lifecycle, the mesh module and the plan-level
dry run.  Its one process group: the training launcher with
``--conv-mesh dp_only`` on 2 gloo ranks started by
``torch.distributed.run`` (``tests/_torch_launch_ranks.py``), held to the
one-process run, and the elastic checkpoint restore onto ``P("data",
None)`` on that 2-rank mesh and on a 1-rank one.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from functools import partial  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.core import conv as jconv  # noqa: E402
from repro.core.convspec import ConvSpec as JSpec  # noqa: E402
from repro.core.convspec import ConvTransposeSpec as JTSpec  # noqa: E402
from repro.dist import conv_parallel as jcp  # noqa: E402
from repro.dist import sharding as JSH  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch.configs import (all_arch_ids, applicable_shapes,  # noqa: E402
                                 get_config, paper_cnn)
from repro_torch.core import conv as C  # noqa: E402
from repro_torch.core.convspec import ConvSpec, ConvTransposeSpec  # noqa: E402
from repro_torch.dist import conv_parallel as cp  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.dist.sharding import P  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.models import autoencoder as AE  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
META = torch.device("meta")


class StubMesh:
    """Plans only read axis sizes."""

    def __init__(self, **axes):
        self.shape = axes


def _specs(kind, kw):
    if kind == "reg":
        return JSpec.make(**kw), ConvSpec.make(**kw)
    return JTSpec.make(**kw), ConvTransposeSpec.make(**kw)


def _plan_fields(plan):
    return {"batch": tuple(plan.batch), "h": plan.h, "w": plan.w,
            "cin": plan.cin, "cout": plan.cout,
            "halo_h": tuple(plan.halo_h), "halo_w": tuple(plan.halo_w),
            "transposed": plan.transposed,
            "dropped": tuple(tuple(d) for d in plan.dropped),
            "roles": plan.roles, "tag": plan.tag}


def _jpar(par):
    if isinstance(par, cp.ConvParallel):
        return jcp.ConvParallel(batch=par.batch, h=par.h, w=par.w,
                                cin=par.cin, cout=par.cout)
    return par


def _both_plans(x_shape, w_shape, kind, kw, par, mesh):
    jspec, tspec = _specs(kind, kw)
    jp = jcp.plan_conv_sharding(x_shape, w_shape, jspec,
                                jcp.ConvParallel.coerce(_jpar(par), mesh),
                                mesh)
    tp = cp.plan_conv_sharding(x_shape, w_shape, tspec,
                               cp.ConvParallel.coerce(par, mesh), mesh)
    return _plan_fields(jp), _plan_fields(tp)


# ---------------------------------------------------------------------------
# Halo export
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(taps_h=st.integers(min_value=1, max_value=3),
       taps_w=st.integers(min_value=1, max_value=3),
       dil=st.integers(min_value=1, max_value=3),
       s=st.integers(min_value=1, max_value=3),
       p=st.integers(min_value=0, max_value=4))
def test_shard_halo_and_tap_span_match_jax(taps_h, taps_w, dil, s, p):
    kw = dict(stride=s, padding=p, dilation=dil)
    x_shape, w_shape = (2, 3, 48, 48), (4, 3, taps_h, taps_w)
    jd = jconv.spec_dims(x_shape, w_shape, JSpec.make(**kw))
    td = C.spec_dims(x_shape, w_shape, ConvSpec.make(**kw))
    assert ops.tap_span(td) == jops.tap_span(jd)
    assert ops.shard_halo(td) == jops.shard_halo(jd)
    span_h, span_w = ops.tap_span(td)
    (lo_h, hi_h), (lo_w, hi_w) = ops.shard_halo(td)
    assert (span_h, span_w) == ((taps_h - 1) * dil + 1,
                                (taps_w - 1) * dil + 1)
    assert (lo_h, lo_w) == (p, p)
    assert lo_h + hi_h == span_h - s and lo_w + hi_w == span_w - s


def test_shard_halo_negative_hi_means_crop():
    d = C.spec_dims((1, 1, 8, 8), (1, 1, 1, 1), ConvSpec.make(stride=2))
    assert ops.shard_halo(d) == ((0, -1), (0, -1))


# ---------------------------------------------------------------------------
# The planner against JAX's
# ---------------------------------------------------------------------------

#: JAX's fixed plan cases (tests/test_conv_parallel.py): x shape, w shape,
#: spec kind and kwargs, ConvParallel kwargs or a policy, mesh axes.
FIXED = {
    "full assignment": ((4, 8, 16, 16), (6, 8, 3, 3), "reg",
                        dict(stride=2, padding=1),
                        dict(batch=("data",), h="model", cout="sw"),
                        dict(data=2, model=2, sw=2)),
    "indivisible batch": ((3, 8, 16, 16), (6, 8, 3, 3), "reg",
                          dict(stride=2, padding=1),
                          dict(batch=("data",), h="model"),
                          dict(data=2, model=2)),
    "valid padding": ((4, 8, 16, 16), (6, 8, 3, 3), "reg", dict(stride=1),
                      dict(h="model"), dict(data=2, model=2)),
    "halo over the block": ((4, 8, 8, 8), (6, 8, 7, 7), "reg",
                            dict(padding=3), dict(h="model"),
                            dict(model=4)),
    "grouped": ((4, 8, 16, 16), (8, 4, 3, 3), "reg",
                dict(padding=1, groups=2), dict(cin="data", cout="model"),
                dict(data=2, model=2)),
    "claimed and missing": ((4, 8, 16, 16), (6, 8, 3, 3), "reg",
                            dict(stride=2, padding=1),
                            dict(batch=("data",), cin="data", cout="sw"),
                            dict(data=2, model=2)),
    "size one axes": ((4, 8, 16, 16), (6, 8, 3, 3), "reg",
                      dict(stride=2, padding=1),
                      dict(batch=("data",), h="model"),
                      dict(data=1, model=1)),
    "transposed channels": ((4, 8, 8, 8), (8, 6, 3, 3), "tsp",
                            dict(stride=2, padding=1, output_padding=1),
                            dict(cin="data", cout="model"),
                            dict(data=2, model=3)),
    "transposed cout 6 % 4": ((4, 8, 8, 8), (8, 6, 3, 3), "tsp",
                              dict(stride=2, padding=1, output_padding=1),
                              dict(cout="model"), dict(model=4)),
}


@pytest.mark.parametrize("name", sorted(FIXED))
def test_plan_fixed_cases_match_jax(name):
    x_shape, w_shape, kind, kw, par, axes = FIXED[name]
    jp, tp = _both_plans(x_shape, w_shape, kind, kw,
                         cp.ConvParallel(**par), StubMesh(**axes))
    assert tp == jp


def test_plan_fixed_cases_hold_jax_assertions():
    """JAX's own assertions on those cases, on the port's plans."""
    def plan(name):
        x_shape, w_shape, kind, kw, par, axes = FIXED[name]
        spec = _specs(kind, kw)[1]
        return cp.plan_conv_sharding(x_shape, w_shape, spec,
                                     cp.ConvParallel(**par), StubMesh(**axes))
    p = plan("full assignment")
    assert p.roles == ("data", "h", "cout") and p.tag == "data+h+cout"
    assert p.halo_h == (1, 0) and p.dropped == ()
    p = plan("indivisible batch")
    assert p.roles == ("h",)
    assert ("data", "batch 3 % 2 shards != 0") in p.dropped
    (role, why), = plan("valid padding").dropped
    assert role == "h" and "non-uniform geometry" in why
    (role, why), = plan("halo over the block").dropped
    assert role == "h" and "exceeds the 2-row shard block" in why
    p = plan("grouped")
    assert p.roles == () and all("grouped conv" in w for _, w in p.dropped)
    reasons = dict(plan("claimed and missing").dropped)
    assert "already claimed" in reasons["cin"]
    assert "not in mesh" in reasons["cout"]
    p = plan("size one axes")
    assert p.roles == () and p.dropped == ()
    p = plan("transposed channels")
    assert p.transposed and p.roles == ("cin", "cout")
    assert ("cout", "cout 6 % 4 shards != 0") in plan(
        "transposed cout 6 % 4").dropped


@settings(max_examples=80, deadline=None)
@given(b=st.integers(min_value=1, max_value=6),
       c=st.integers(min_value=1, max_value=6),
       n=st.integers(min_value=1, max_value=6),
       h=st.integers(min_value=6, max_value=18),
       s=st.integers(min_value=1, max_value=2),
       nd=st.integers(min_value=1, max_value=4),
       nm=st.integers(min_value=1, max_value=4))
def test_plan_sweep_matches_jax(b, c, n, h, s, nd, nm):
    """Arbitrary (often indivisible) geometry: the same plan as JAX's."""
    kw = dict(stride=s, padding=1)
    try:
        d = jconv.spec_dims((b, c, h, h), (n, c, 3, 3), JSpec.make(**kw))
    except Exception:
        return
    if d.H_o < 1 or d.W_o < 1:
        return
    jp, tp = _both_plans((b, c, h, h), (n, c, 3, 3), "reg", kw,
                         cp.ConvParallel(batch=("data",), h="model",
                                         cin="model", cout="data"),
                         StubMesh(data=nd, model=nm))
    assert tp == jp


#: the Table II layers' outcome on a (data=2, model=2) mesh at batch 2:
#: policy -> per layer (tag, the drops' roles).
TABLE2_WANT = {
    "spatial": [("data", ("h",)), ("data+h", ()), ("data+h", ()),
                ("data+h", ()), ("data", ("h",))],
    "tp": [("data+cout", ())] * 5,
    "dp_only": [("replicated", ("data",))] * 5,
    "tp_rep": [("data", ())] * 5,
}
TABLE2 = [(policy, i) for policy in TABLE2_WANT for i in range(5)]


@pytest.mark.parametrize("policy,i", TABLE2,
                         ids=[f"{p}-{i}" for p, i in TABLE2])
def test_table2_plans_match_jax(policy, i):
    hi, ci, co, k, s, p = paper_cnn.TABLE2_LAYERS[i]
    x_shape, w_shape = (2, ci, hi, hi), (co, ci, k, k)
    mesh = StubMesh(data=2, model=2)
    jp, tp = _both_plans(x_shape, w_shape, "reg",
                         dict(stride=s, padding=p), policy, mesh)
    assert tp == jp
    tag, drops = TABLE2_WANT[policy][i]
    assert tp["tag"] == tag and tuple(r for r, _ in tp["dropped"]) == drops
    if policy == "spatial" and tag == "data+h":
        assert tp["halo_h"] == ((0, -1) if k == 1 else (1, 0))


# ---------------------------------------------------------------------------
# Policy resolution, the hook, the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["tp", "dp_only", "spatial", "tp_rep"])
@pytest.mark.parametrize("axes", [dict(data=4, model=2),
                                  dict(pod=2, data=4, model=2)])
def test_from_policy_matches_jax(policy, axes):
    mesh = StubMesh(**axes)
    got = cp.ConvParallel.from_policy(policy, mesh)
    want = jcp.ConvParallel.from_policy(policy, mesh)
    assert dataclasses_fields(got) == dataclasses_fields(want)


def dataclasses_fields(par):
    return (tuple(par.batch), par.h, par.w, par.cin, par.cout)


def test_from_policy_resolution():
    mesh = StubMesh(data=4, model=2)
    assert cp.ConvParallel.from_policy("tp", mesh) == cp.ConvParallel(
        batch=("data",), cout="model")
    dp = cp.ConvParallel.from_policy("dp_only", mesh)
    assert dp.batch == ("data", "model") and dp.cout is None
    sp = cp.ConvParallel.from_policy("spatial", mesh)
    assert sp.h == "model" and sp.batch == ("data",)
    assert cp.ConvParallel.from_policy("tp_rep", mesh) == cp.ConvParallel(
        batch=("data",))
    with pytest.raises(ValueError, match="unknown conv mesh policy"):
        cp.ConvParallel.from_policy("bogus", mesh)


def test_conv_mesh_context_installs_and_clears_hook():
    assert C.MESH_LOWERING is None
    with cp.conv_mesh("tp"):
        assert C.MESH_LOWERING is cp._maybe_lower
        with cp.conv_mesh("spatial"):
            assert C.MESH_LOWERING is cp._maybe_lower
        assert C.MESH_LOWERING is cp._maybe_lower
    assert C.MESH_LOWERING is None
    with cp.conv_mesh(None):
        assert C.MESH_LOWERING is None
    with pytest.raises(ValueError, match="unknown conv mesh policy"):
        cp.conv_mesh("bogus").__enter__()
    assert C.MESH_LOWERING is None


def test_no_mesh_falls_back_with_event():
    C.reset_dispatch_events()
    x, w = torch.ones(1, 2, 8, 8), torch.ones(3, 2, 3, 3)
    spec = ConvSpec.make(stride=2, padding=1)
    with cp.conv_mesh("tp"):
        y = C.conv2d(x, w, spec, "lax")
    assert y.shape == (1, 3, 4, 4)
    assert C.dispatch_events().get("mesh:no_mesh", 0) >= 1
    assert torch.equal(y, C.conv2d(x, w, spec, "lax"))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_one_rank_mesh_falls_back_exactly(layout):
    """No process group: ``make_host_mesh`` is (1, 1); every role drops
    silently, ``mesh:fallback`` is recorded, the result is the unsharded
    one bit for bit (NHWC and the transposed conv reach the hook too)."""
    mesh = LM.make_host_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 8, 8, generator=gen)
    w = torch.randn(6, 4, 3, 3, generator=gen)
    wt = torch.randn(4, 6, 3, 3, generator=gen)
    if layout == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    spec = ConvSpec.make(stride=2, padding=1, layout=layout)
    tspec = ConvTransposeSpec.make(stride=2, padding=1, output_padding=1,
                                   layout=layout)
    C.reset_dispatch_events()
    with mesh, cp.conv_mesh("tp"):
        y = C.conv2d(x, w, spec, "pallas")
        yt = C.conv2d_transpose(x, wt, tspec, "pallas")
    ev = C.dispatch_events()
    assert ev.get("mesh:fallback") == 1 and ev.get("mesh:fallback_T") == 1
    assert not any(k.startswith("mesh:drop") for k in ev)
    assert torch.equal(y, C.conv2d(x, w, spec, "pallas"))
    assert torch.equal(yt, C.conv2d_transpose(x, wt, tspec, "pallas"))


def test_production_and_host_meshes():
    m = LM.make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.name == "16x16"
    mp_ = LM.make_production_mesh(multi_pod=True)
    assert mp_.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.device_mesh is None and mp_.size == 512
    with pytest.raises(RuntimeError, match="abstract"):
        m.coordinate("data")
    assert LM.make_host_mesh().shape == {"data": 1, "model": 1}


def test_backend_follows_the_layout(monkeypatch):
    assert LM.backend_for("cpu", 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert LM.backend_for("cuda", 1) == "nccl"
    assert LM.backend_for("cuda", 4) == "gloo"     # ranks share the card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert LM.backend_for("cuda", 4) == "nccl"


# ---------------------------------------------------------------------------
# Spec trees against JAX's
# ---------------------------------------------------------------------------

def _jflat(tree):
    """(path, spec as a tuple) of a JAX spec tree."""
    from jax.sharding import PartitionSpec as JP
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, JP))
    return [(jax.tree_util.keystr(k), tuple(v)) for k, v in flat]


def _tflat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _tflat(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _tflat(v, f"{prefix}[{i}]")]
    return [(prefix, tuple(tree))]


PROD = StubMesh(data=16, model=16)
SPEC_CASES = [(a, pol) for a in ARCH_IDS for pol in ("tp", "dp_only",
                                                     "tp_rep")]


@pytest.mark.parametrize("arch,policy", SPEC_CASES,
                         ids=[f"{a}-{p}" for a, p in SPEC_CASES])
def test_spec_trees_match_jax_at_full_width(arch, policy):
    """param_specs, opt_state_specs, batch_specs and cache_specs leaf by
    leaf at the published widths on the (16, 16) mesh: JAX's from
    ``jax.eval_shape``, the port's from ``meta`` tensors."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jp = jax.eval_shape(partial(JM.init_params, cfg=jcfg),
                        jax.random.PRNGKey(0))
    tp = M.build_model(tcfg).init(torch.Generator().manual_seed(0), META)
    assert _tflat(SH.param_specs(tp, PROD, policy)) == _jflat(
        JSH.param_specs(jp, PROD, policy))
    assert _tflat(SH.opt_state_specs(tp, PROD, policy)) == _jflat(
        JSH.opt_state_specs(jp, PROD, policy))
    batch = dryrun.input_specs(tcfg, dryrun.SHAPES["train_4k"])
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
              for k, v in batch.items()}
    assert _tflat(SH.batch_specs(batch, PROD, policy)) == _jflat(
        JSH.batch_specs(jbatch, PROD, policy))
    if not tcfg.is_encoder_only:
        b, seq = 128, 1024
        jc = jax.eval_shape(lambda: JT.init_cache(jcfg, b, seq))
        tc = T.init_cache(tcfg, b, seq, META)
        assert _tflat(SH.cache_specs(tc, PROD, policy)) == _jflat(
            JSH.cache_specs(jc, PROD, policy))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_bytes_per_device_match_jax_specs(arch, tmp_path):
    """The dry run's bytes per device of parameters, AdamW moments and
    batch at ``train_4k`` on (16, 16): the same sums over JAX's spec trees
    and ``eval_shape`` leaves."""
    res = dryrun.run_cell(arch, "train_4k", report_dir=str(tmp_path))
    jcfg = jget_config(arch)
    jp = jax.eval_shape(partial(JM.init_params, cfg=jcfg),
                        jax.random.PRNGKey(0))
    specs = dict(_jflat(JSH.param_specs(jp, PROD, "tp")))
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]

    def shards(spec):
        n = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    n *= PROD.shape[a]
        return n
    want_p = sum(v.size * v.dtype.itemsize //
                 shards(specs[jax.tree_util.keystr(k)]) for k, v in leaves)
    want_m = 2 * sum(v.size * 4 // shards(specs[jax.tree_util.keystr(k)])
                     for k, v in leaves)
    per = res["bytes_per_device"]
    assert per["params"] == want_p and per["adamw_moments"] == want_m
    assert res["param_count"] == sum(v.size for _, v in leaves)
    assert (tmp_path / f"{arch}__train_4k__16x16.json").exists()


def _jax_model_flops():
    """JAX's ``repro.launch.dryrun.model_flops``.  That module sets
    ``XLA_FLAGS`` to 512 host devices when imported, so the backend is
    locked in first and the variable put back after."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun.model_flops


FLOP_CASES = [(a, s) for a in all_arch_ids()
              for s in applicable_shapes(get_config(a))]


@pytest.mark.parametrize("arch,shape", FLOP_CASES,
                         ids=[f"{a}-{s}" for a, s in FLOP_CASES])
def test_dryrun_model_flops_match_jax(arch, shape):
    """The analytic ``model_flops`` of every architecture's every
    applicable shape at its published widths, from ``meta`` parameters:
    exactly JAX's, from ``eval_shape`` leaves (expert stacks at top_k /
    E); ``run_cell`` reports it."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jp = jax.eval_shape(partial(JM.init_params, cfg=jcfg),
                        jax.random.PRNGKey(0))
    tp = M.build_model(tcfg).init(torch.Generator().manual_seed(0), META)
    want = _jax_model_flops()(jcfg, JSHAPES[shape], jp)
    got = dryrun.model_flops(tcfg, dryrun.SHAPES[shape], tp)
    assert got == want and got > 0
    if tcfg.n_experts:
        assert got < dryrun.model_flops(
            dataclasses.replace(tcfg, n_experts=0), dryrun.SHAPES[shape], tp)
    cell = dryrun.plan_cell(tcfg, dryrun.SHAPES[shape], PROD)
    assert cell["model_flops"] == want


def test_autoencoder_param_specs_match_jax():
    """Conv kernels shard Cout only (dim 0 regular, dim 1 under "dec"),
    never their spatial dims, through the per-stage lists."""
    acfg = AE.AutoencoderConfig(c_in=3, widths=(16, 32), k=3)
    tp = AE.init_autoencoder(torch.Generator().manual_seed(0), acfg, META)
    jp = jax.eval_shape(lambda: JM.init_autoencoder(
        jax.random.PRNGKey(0), JM.AutoencoderConfig(c_in=3, widths=(16, 32),
                                                    k=3)))
    for mesh in (StubMesh(data=1, model=1), StubMesh(data=4, model=2)):
        for policy in ("tp", "dp_only", "tp_rep"):
            assert _tflat(SH.param_specs(tp, mesh, policy)) == _jflat(
                JSH.param_specs(jp, mesh, policy))
    specs = SH.param_specs(tp, StubMesh(data=1, model=1), "tp")
    assert isinstance(specs["enc"], list) and len(specs["enc"]) == 2
    assert all(s["w"] == P("model", None, None, None) for s in specs["enc"])
    assert all(s["w"] == P(None, "model", None, None) for s in specs["dec"])
    big = {"enc": [{"w": torch.empty(8, 8, 4, 4, device=META)}]}
    spec = SH.param_specs(big, StubMesh(data=4, model=4), "tp")
    assert spec["enc"][0]["w"] == P("model", None, None, None)


@pytest.mark.parametrize("policy", ["tp", "dp_only", "spatial"])
def test_dryrun_conv_cell_plans_match_jax(policy, tmp_path):
    """Every autoencoder conv planned on (16, 16): the tags and drops are
    JAX's planner's on the same shapes; ``tp`` drops the decoder's Cout
    3; ``spatial`` exchanges halos."""
    res = dryrun.run_conv_cell(policy, report_dir=str(tmp_path))
    assert res["sharded_convs"] >= 1 and len(res["convs"]) == 4
    for conv in res["convs"]:
        kind = "tsp" if conv["transposed"] else "reg"
        kw = (dict(stride=2, padding=1, output_padding=1) if conv[
            "transposed"] else dict(stride=2, padding=1))
        jp, _ = _both_plans(tuple(conv["x"]), tuple(conv["w"]), kind, kw,
                            policy, PROD)
        assert conv["tag"] == jp["tag"]
        assert [tuple(d) for d in conv["dropped"]] == list(jp["dropped"])
    if policy == "tp":
        assert res["mesh_events"].get("mesh:drop:cout") == 1
    if policy == "spatial":
        assert res["halo_bytes_per_step_per_device"] > 0
    else:
        assert res["halo_bytes_per_step_per_device"] == 0


def test_dryrun_conv_cell_fails_on_silent_replication(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(LM, "make_production_mesh",
                        lambda multi_pod=False: LM.Mesh(("data", "model"),
                                                        (1, 1)))
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        LM.make_production_mesh)
    with pytest.raises(SystemExit, match="NO conv took the sharded path"):
        dryrun.run_conv_cell("tp", report_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# The launcher and the elastic restore on 2 ranks (torch.distributed.run)
# ---------------------------------------------------------------------------

TREE = {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
        "b": np.ones(8, np.float32)}
LAUNCH = ["--arch", "mamba2-370m", "--smoke", "--device", "cpu", "--steps",
          "3", "--batch", "4", "--seq", "32", "--conv-policy", "pallas"]


def test_elastic_restore_onto_one_rank(tmp_path):
    from repro_torch.ckpt import checkpoint as CKPT
    CKPT.save(str(tmp_path), 5, TREE)
    mesh = LM.make_host_mesh()
    step, tree = CKPT.restore(str(tmp_path), device="cpu", mesh=mesh,
                              specs={"w": P("data", None), "b": P()})
    assert step == 5
    np.testing.assert_array_equal(tree["w"].numpy(), TREE["w"])
    np.testing.assert_array_equal(tree["b"].numpy(), TREE["b"])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    from repro_torch.ckpt import checkpoint as CKPT
    tmp = tmp_path_factory.mktemp("torchrun")
    ckpt = tmp / "ckpt"
    CKPT.save(str(ckpt), 5, TREE)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2",
         str(ROOT / "tests" / "_torch_launch_ranks.py"), str(tmp), str(ckpt),
         "--", *LAUNCH, "--conv-mesh", "dp_only"],
        capture_output=True, text=True, env=env, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-6000:]
    return proc, [json.loads((tmp / f"rank{r}.json").read_text())
                  for r in range(2)]


def test_launcher_dp_only_on_two_ranks_matches_one_process(two_ranks):
    """``--conv-mesh dp_only`` under ``torch.distributed.run``: every
    depthwise conv of Mamba2 runs batch-sharded over the 2 ranks, and the
    losses and gradient norms are the one-process run's; only rank 0
    prints."""
    from repro_torch.launch import train as launch
    proc, ranks = two_ranks
    hist: list = []
    C.reset_dispatch_events()
    want = launch.main(LAUNCH, history=hist)
    one = {k: v for k, v in C.dispatch_events().items()
           if k.startswith("mesh")}
    assert one == {}                          # no mesh asked for
    for r in ranks:
        assert r["world"] == 2 and r["backend"] == "gloo"
        assert r["mesh"] == {"data": 2, "model": 1}
        np.testing.assert_allclose(r["losses"], want, rtol=1e-5)
        np.testing.assert_allclose(r["grad_norms"],
                                   [h["grad_norm"] for h in hist],
                                   rtol=1e-4)
        assert set(r["events"]) == {"mesh:conv2d:data"}, r["events"]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert proc.stdout.count("[train] done") == 1
    assert "2 ranks on gloo (cpu)" in proc.stdout


def test_elastic_restore_onto_two_ranks(two_ranks):
    """Saved unsharded, restored onto P("data", None) on the (2, 1)
    mesh: each rank holds its half of ``w`` and the whole ``b``."""
    _, ranks = two_ranks
    for r in ranks:
        assert r["restored_step"] == 5
        half = TREE["w"][4 * r["rank"]:4 * (r["rank"] + 1)]
        np.testing.assert_array_equal(np.asarray(r["w"], np.float32), half)
        np.testing.assert_array_equal(np.asarray(r["b"], np.float32),
                                      TREE["b"])
