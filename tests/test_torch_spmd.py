"""The port's batch-sharded train step and its step on blocks
(``repro_torch.dist.spmd.sharded_step``) on 8 gloo ranks on the CPU,
against the JAX package's single-device step.

One process group runs every case (``tests/_torch_spmd_worker.py``, 8
spawned ranks, one thread each, a ``(data=4, model=2)`` mesh); the JAX
side runs here on the same numpy inputs:

  * JAX's own case (``tests/test_distributed.py``): SmolLM's smoke
    config, ``tp``, parameters, AdamW moments and an 8 x 64 batch in
    their blocks, 3 steps: losses and gradient norms within rtol 1e-4 /
    atol 1e-5 of JAX's ``make_train_step`` on one device (that test's
    reference and tolerance), the same on every rank, the gathered
    parameters bit-identical, and each rank's blocks exactly the bytes
    the dry run counts a device;
  * the autoencoder under ``tp``, ``dp_only`` and ``spatial``, every conv
    on this rank's batch block (``mesh:conv2d:data...``), within the same
    tolerance of JAX's step, parameters bit-identical on every rank;
  * a ``loss_mask`` whose count differs between the ranks' blocks: within
    the tolerance, where averaging per-rank means reads outside it;
  * a conv that psums its weight grad over the batch axes on a batch
    block too (counted twice): outside the tolerance on the norms;
  * the MoE family (ROADMAP A14) on batch blocks through
    ``sharded_step``, held to JAX's single-device step on the global batch
    within the same tolerance: moonshot's smoke config under ``tp`` at 8
    x 64 (one group of 512 tokens across the 4 data blocks: straddled),
    under ``dp_only`` at 8 x 500 (8 blocks of 500 tokens across groups of
    800: partial), with ``accum_steps=2`` (JAX's microbatches), and
    DeepSeek-V3's (MLA, MTP) under ``tp`` at 8 x 64; a router that favours
    one expert so that its queue overflows across the ranks at step 0 (the
    dropped choices counted per rank); two mutations that read outside the
    tolerance: each rank's own group arithmetic, and ``moe_lb`` as the mean
    of each rank's own product;
  * the training launcher on moonshot's smoke config under
    ``torch.distributed.run`` on 2 ranks (``--conv-mesh dp_only``): its
    losses within the tolerance of one process's;
  * the blocked state saved after step 2 as global arrays and restored
    onto one rank: the gathered parameters bit for bit, and its third
    step, run unsharded, within the tolerance of JAX's;
  * tensor- and expert-parallel compute on the ``tp`` blocks
    (``repro_torch.dist.tensor_parallel``): every case above runs under
    its plan, and SmolLM's smoke config with 4 query and 2 KV heads (on
    both sides) runs its attention on column and row blocks, within the
    tolerance of JAX's step; each rank's plan is the rule's, the bytes it
    computes with in a step are the plan's count, the expert einsums run
    4 of 8 experts, the replicated parameters are bit-identical on every
    rank, and two mutations read outside the tolerance: ``wo``'s partial
    outputs not summed over ``model``, and a norm that counts each
    replicated leaf once per ``model`` rank;
  * the smoke configs of Mamba2-370M (each rank its heads) and
    recurrentgemma-9b (its RG-LRU channels, its query heads against the
    one KV head) under ``tp``, the depthwise conv under ``pallas`` on
    each rank's batch and channel block through the ``tp`` conv hook,
    within the tolerance of JAX's step: plans, the bytes a rank gathers
    and computes with, replicated bits, the conv hook's ``mesh:*`` events
    and the RG-LRU's gathers; three mutations read outside the tolerance
    (Mamba2's gated norm without the ``model`` sum of its squares, B and
    C not entering the heads' block, a ``gather`` whose backward skips
    the sum); serving and the unsharded step of both bit-equal through
    the layers and through their whole-tensor versions;
  * the collectives of the grad sync (``launch.mesh``): ``Mesh.psum``,
    ``psum_scatter`` and ``psum_scatter_flat`` ``torch.equal`` to the
    gather-and-add they replace, in float32 and bf16, on each axis and at
    lengths that do not divide; the first step's ``Plan.fold`` and grad
    sync of SmolLM, moonshot, Mamba2 and DeepSeek ``torch.equal`` to the
    old fold and the old whole sums cut to blocks, the bytes each rank
    sends and receives in them the plan's counts, below the old forms';
    a reduce-scatter that drops a part reads outside the tolerance.
"""

import dataclasses
import fnmatch
import json
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402

from repro_torch.ckpt import checkpoint as CKPT  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.tree import tree_from_numpy  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _torch_spmd_worker as W  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
#: the 8 ranks' start and 22 runs of 3 steps take ~90 s on 8 threads.
TIMEOUT_S = 240
JCFG = jget_smoke("smollm-360m")
ACFG = JM.AutoencoderConfig(c_in=3, widths=(16, 32), k=3, conv_policy="lax")
JCFG_HEADS = dataclasses.replace(JCFG, **W.HEADS)
MOE_CFGS = {"moonshot": jget_smoke("moonshot-v1-16b-a3b"),
            "deepseek": jget_smoke("deepseek-v3-671b")}
#: the JAX configs of the worker's ``CONV_FAMILIES``.
CONV_CFGS = {case: jget_smoke(arch)
             for case, (arch, _) in W.CONV_FAMILIES.items()}
#: the JAX configs of the worker's ``FRONTEND_CASES``.
FRONTEND_CFGS = {case: jget_smoke(arch)
                 for case, (arch, _, _) in W.FRONTEND_CASES.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _favour_one_expert(params) -> dict:
    """``params`` with a direction ``u`` added to every embedding row and
    to the router's column of expert 0 in every MoE layer: most tokens
    then take expert 0 first, past its capacity."""
    u = np.random.RandomState(2).randn(params["embed"]["w"].shape[1])
    u = (u / np.linalg.norm(u)).astype(np.float32)
    emb = params["embed"]["w"]
    out = jax.tree.map(np.copy, params)
    out["embed"]["w"] = emb + 2 * np.linalg.norm(emb, axis=1).mean() * u
    out["blocks_moe"]["moe"]["router"]["w"][..., 0] += u
    return out


def _mask() -> np.ndarray:
    """1s on a share of each row's positions that grows with the row, so
    every data block of 2 rows keeps another count."""
    mask = np.zeros((8, 64), np.float32)
    for r in range(8):
        mask[r, :8 * (r + 1)] = 1.0
    return mask


def _frontend_batch(cfg, toks) -> dict:
    """internvl2's batch: ``frontend_tokens`` (8) image embeddings a row
    ahead of 56 text tokens; hubert's: 64 frames a row and their
    targets; embeddings drawn from a seed."""
    rng = np.random.RandomState(4)
    if cfg.family == "vlm":
        text = toks[:, :toks.shape[1] - cfg.frontend_tokens]
        return {"tokens": text, "targets": np.roll(text, -1, axis=1),
                "frontend": rng.randn(toks.shape[0], cfg.frontend_tokens,
                                      cfg.d_frontend).astype(np.float32)}
    return {"frontend": rng.randn(*toks.shape, cfg.d_frontend).astype(
        np.float32), "targets": toks % cfg.vocab}


#: the fixture's numpy inputs, for the plan counts worked out here.
_SPMD_INPUTS: dict = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 64), 0,
                                         JCFG.vocab), np.int32)
    inputs = {
        "lm_params": _np(JM.init_params(jax.random.PRNGKey(0), JCFG)),
        "lm_heads_params": _np(JM.init_params(jax.random.PRNGKey(0),
                                              JCFG_HEADS)),
        "lm_batch": {"tokens": toks, "targets": toks},
        "loss_mask": _mask(),
        "ae_params": _np(JM.init_autoencoder(jax.random.PRNGKey(0), ACFG)),
        "image": np.random.RandomState(0).randn(8, 3, 16, 16).astype(
            np.float32),
        "moe_params": _np(JM.init_params(jax.random.PRNGKey(0),
                                         MOE_CFGS["moonshot"])),
        "ds_params": _np(JM.init_params(jax.random.PRNGKey(0),
                                        MOE_CFGS["deepseek"])),
        **{key: _np(JM.init_params(jax.random.PRNGKey(0), CONV_CFGS[case]))
           for case, (_, key) in W.CONV_FAMILIES.items()},
        **{key: _np(JM.init_params(jax.random.PRNGKey(0),
                                   FRONTEND_CFGS[case]))
           for case, (_, key, _) in W.FRONTEND_CASES.items()},
        "vlm_batch": _frontend_batch(FRONTEND_CFGS["vlm_tp"], toks),
        "audio_batch": _frontend_batch(FRONTEND_CFGS["audio_tp"], toks),
        "tokens_64": toks,
        "tokens_500": np.random.RandomState(3).randint(
            0, MOE_CFGS["moonshot"].vocab, (8, 500)).astype(np.int32)}
    inputs["cap_params"] = _favour_one_expert(inputs["moe_params"])
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    _SPMD_INPUTS.update(inputs)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_spmd_worker.py"),
         str(tmp), str(tmp)], capture_output=True, text=True, env=env,
        timeout=TIMEOUT_S, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-6000:]
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(W.WORLD)]
    return {"dir": tmp, "inputs": inputs, "ranks": ranks}


_JAX_STEPS: dict = {}


def _jax_run(cfg, params, batch, loss=None, steps=W.STEPS, accum=1):
    key = (cfg, loss, accum)
    if key not in _JAX_STEPS:
        kw = {} if loss is None else {"loss": loss}
        _JAX_STEPS[key] = jax.jit(JTS.make_train_step(
            cfg, jadamw.AdamWConfig(peak_lr=W.LR), total_steps=10,
            warmup=1, accum_steps=accum, **kw))
    step = _JAX_STEPS[key]
    p = jax.tree.map(jnp.asarray, params)
    o = jadamw.init_state(p)
    b = jax.tree.map(jnp.asarray, batch)
    out = {"losses": [], "grad_norms": []}
    for s in range(steps):
        p, o, m = step(p, o, b, jnp.int32(s))
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        if "moe_lb" in m:
            out.setdefault("moe_lb", []).append(float(m["moe_lb"]))
    return out


def _jax_moe(runs, case):
    arch, params, toks, _, accum = W.MOE_CASES[case]
    i = runs["inputs"]
    return _jax_run(MOE_CFGS[arch], i[params],
                    {"tokens": i[toks], "targets": i[toks]}, accum=accum)


def _close(got, want) -> bool:
    return np.allclose(got, want, rtol=RTOL, atol=ATOL)


def _assert_matches(per_rank, want):
    for r in per_rank:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(r["grad_norms"], want["grad_norms"],
                                   rtol=RTOL, atol=ATOL)
        assert r["losses"] == per_rank[0]["losses"]


def test_smollm_tp_blocks_match_jax_single_device(runs):
    i = runs["inputs"]
    want = _jax_run(JCFG, i["lm_params"], i["lm_batch"])
    per_rank = [r["smollm_tp"] for r in runs["ranks"]]
    _assert_matches(per_rank, want)
    assert len({r["params"] for r in per_rank}) == 1
    assert {r["rows"] for r in per_rank} == {2}


def test_blocks_hold_the_dry_runs_bytes_a_device(runs):
    """Each rank's parameter and moment blocks are exactly what
    ``dryrun.bytes_per_device`` counts for one device of an abstract
    (4, 2) mesh under ``tp``; ``tp`` cuts them below the whole."""
    params = tree_from_numpy(runs["inputs"]["lm_params"], "cpu")
    mesh = Mesh(("data", "model"), W.SHAPE)
    spec = SH.param_specs(params, mesh, "tp")
    p_bytes = dryrun.bytes_per_device(params, spec, mesh)
    m_bytes = 2 * dryrun.bytes_per_device(params, spec, mesh, torch.float32)
    assert p_bytes < sum(t.nbytes for t in
                         jax.tree.leaves(runs["inputs"]["lm_params"]))
    for r in runs["ranks"]:
        assert r["smollm_tp"]["param_bytes"] == p_bytes
        assert r["smollm_tp"]["moment_bytes"] == m_bytes


@pytest.mark.parametrize("policy", W.AE_POLICIES)
def test_autoencoder_on_batch_blocks_matches_jax(runs, policy):
    i = runs["inputs"]
    want = _jax_run(ACFG, i["ae_params"], {"image": i["image"]},
                    loss=JM.autoencoder_loss)
    per_rank = [r[f"ae_{policy}"] for r in runs["ranks"]]
    _assert_matches(per_rank, want)
    assert len({r["params"] for r in per_rank}) == 1
    ev = per_rank[0]["events"]
    assert "mesh:fallback" not in ev and "mesh:fallback_T" not in ev, ev
    want_tag = {"tp": "data+cout", "dp_only": "data",
                "spatial": "data+h"}[policy]
    assert ev.get(f"mesh:conv2d:{want_tag}"), ev
    if policy == "tp":                 # the decoder's Cout 3 over model=2
        assert ev.get("mesh:drop:cout") and ev.get("mesh:conv2d_T:data"), ev
    assert {r["rows"] for r in per_rank} == {8 // (8 if policy == "dp_only"
                                                   else 4)}


def test_loss_mask_counts_differ_between_ranks(runs):
    """The ranks' blocks keep different counts; the step sums each rank's
    masked sum over the global count, so its losses are JAX's; averaging
    the per-rank means reads outside the tolerance."""
    i = runs["inputs"]
    want = _jax_run(JCFG, i["lm_params"],
                    {**i["lm_batch"], "loss_mask": i["loss_mask"]})
    per_rank = [r["mask"] for r in runs["ranks"]]
    assert len({r["mask_count"] for r in per_rank}) == 4
    _assert_matches(per_rank, want)
    mutant = runs["ranks"][0]["mask_mutant"]
    assert not _close(mutant["losses"], want["losses"]), mutant


def test_double_counted_conv_weight_grad_fails_the_check(runs):
    """A conv that psums its weight grad over the batch axes on a batch
    block, before the step sums every grad over them, reads 8x the grad
    norm; the losses cannot tell (AdamW is scale-free), the norms can."""
    i = runs["inputs"]
    want = _jax_run(ACFG, i["ae_params"], {"image": i["image"]},
                    loss=JM.autoencoder_loss)
    mutant = runs["ranks"][0]["ae_wgrad_mutant"]
    assert not _close(mutant["grad_norms"], want["grad_norms"]), mutant
    np.testing.assert_allclose(np.array(mutant["grad_norms"][:1]),
                               8 * np.array(want["grad_norms"][:1]),
                               rtol=1e-4)


@pytest.mark.parametrize("case", list(W.MOE_CASES))
def test_moe_on_batch_blocks_matches_jax_single_device(runs, case):
    """The groups, capacity queues and aux terms of the global batch:
    losses, grad norms and the ``moe_lb`` metric (the ranks' shares
    summed) within the tolerance of JAX's step at each of 3 steps, the
    gathered parameters bit-identical on every rank."""
    want = _jax_moe(runs, case)
    per_rank = [r[case] for r in runs["ranks"]]
    _assert_matches(per_rank, want)
    for r in per_rank:
        np.testing.assert_allclose(r["moe_lb"], want["moe_lb"], rtol=RTOL,
                                   atol=ATOL)
    assert len({r["params"] for r in per_rank}) == 1
    policy, accum = W.MOE_CASES[case][3:]
    rows = 8 // (8 if policy == "dp_only" else 4)
    assert {r["rows"] for r in per_rank} == {rows}
    assert accum == 1 or rows % accum == 0


def test_moe_blocks_hold_the_dry_runs_bytes_a_device(runs):
    """moonshot's expert tensors in their ``tp`` blocks (E over model, d_in
    over data): each rank holds exactly the dry run's bytes a device."""
    params = tree_from_numpy(runs["inputs"]["moe_params"], "cpu")
    mesh = Mesh(("data", "model"), W.SHAPE)
    spec = SH.param_specs(params, mesh, "tp")
    assert spec["blocks_moe"]["moe"]["wi"]["w"] == SH.P(None, "model",
                                                        "data", None)
    p_bytes = dryrun.bytes_per_device(params, spec, mesh)
    m_bytes = 2 * dryrun.bytes_per_device(params, spec, mesh, torch.float32)
    for r in runs["ranks"]:
        assert r["moe_tp"]["param_bytes"] == p_bytes
        assert r["moe_tp"]["moment_bytes"] == m_bytes


def test_capacity_binds_across_the_ranks(runs):
    """With the router favouring expert 0, the one group of 512 tokens
    overflows its queue at step 0: the ranks drop (token, choice) pairs,
    and which ones the queue over every rank's tokens decided (the losses
    are JAX's, above; the same tokens queued per rank read outside the
    tolerance, below).  The earlier data blocks come first in the queue,
    so each drops no more than the next."""
    drops = {c: [r[c]["dropped"] for r in runs["ranks"]]
             for c in ("moe_tp", "moe_capacity")}
    assert sum(drops["moe_capacity"]) > sum(drops["moe_tp"]), drops
    by_data = [r["moe_capacity"]["dropped"] for r in sorted(
        runs["ranks"], key=lambda r: r["coordinate"]["data"])]
    assert by_data == sorted(by_data) and by_data[-1] > by_data[0], by_data


@pytest.mark.parametrize("mutant,case,key", [
    ("moe_groups_mutant", "moe_capacity", "losses"),
    ("moe_lb_mutant", "moe_tp", "moe_lb")])
def test_moe_mutations_read_outside_the_tolerance(runs, mutant, case, key):
    """Each rank's own group arithmetic (its tokens as the batch: its
    groups, capacity and queue) reads outside the tolerance on the losses;
    ``moe_lb`` as the mean of each rank's own product on the metric."""
    want = _jax_moe(runs, case)
    got = runs["ranks"][0][mutant][key]
    assert _close(runs["ranks"][0][case][key], want[key])
    assert not _close(got, want[key]), (got, want[key])


# ---------------------------------------------------------------------------
# The launcher on moonshot under torch.distributed.run, 2 ranks
# ---------------------------------------------------------------------------

MOE_LAUNCH = ["--arch", "moonshot-v1-16b-a3b", "--smoke", "--device", "cpu",
              "--steps", "3", "--batch", "4", "--seq", "64"]


def test_moe_launcher_dp_only_on_two_ranks_matches_one_process(tmp_path):
    """``--conv-mesh dp_only`` sets the activation policy for any
    architecture: each rank trains its 2 x 64 block of one straddled
    group, and the losses and grad norms are the one-process run's."""
    from repro_torch.launch import train as launch
    ckpt = tmp_path / "ckpt"
    CKPT.save(str(ckpt), 0, {"w": np.zeros((2, 2), np.float32),
                             "b": np.zeros(2, np.float32)})
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2",
         str(ROOT / "tests" / "_torch_launch_ranks.py"), str(tmp_path),
         str(ckpt), "--", *MOE_LAUNCH, "--conv-mesh", "dp_only"],
        capture_output=True, text=True, env=env, timeout=TIMEOUT_S,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-6000:]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]
    hist: list = []
    want = launch.main(MOE_LAUNCH, history=hist)
    for r in ranks:
        assert r["world"] == 2 and r["mesh"] == {"data": 2, "model": 1}
        np.testing.assert_allclose(r["losses"], want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r["grad_norms"],
                                   [h["grad_norm"] for h in hist],
                                   rtol=RTOL, atol=ATOL)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert "conv mesh dp_only" in proc.stdout


def test_blocked_checkpoint_restores_onto_one_rank(runs):
    """Saved after step 2 as global arrays (every rank gathered, rank 0
    wrote); restored without a mesh it is the gathered state bit for bit,
    and its third step, unsharded, is JAX's third."""
    step, tree = CKPT.restore(str(runs["dir"] / "ckpt"), device="cpu")
    assert step == W.SAVE_AFTER
    saved = np.load(runs["dir"] / "saved.npz")
    got = {".".join(k): v for k, v in CKPT._leaf_paths(tree["params"])}
    assert sorted(got) == sorted(saved.files)
    for k in saved.files:
        np.testing.assert_array_equal(got[k].numpy(), saved[k])
    assert int(tree["opt"]["step"]) == W.SAVE_AFTER + 1
    i = runs["inputs"]
    cfg = get_smoke_config("smollm-360m")
    step_fn = TS.make_train_step(cfg, adamw.AdamWConfig(peak_lr=W.LR),
                                 total_steps=10, warmup=1)
    _, _, m = step_fn(tree["params"], tree["opt"],
                      tree_from_numpy(i["lm_batch"], "cpu"), W.SAVE_AFTER + 1)
    want = _jax_run(JCFG, i["lm_params"], i["lm_batch"])
    np.testing.assert_allclose(float(m["loss"]), want["losses"][-1],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(m["loss"]),
                               runs["ranks"][0]["smollm_tp"]["losses"][-1],
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Tensor- and expert-parallel compute on the tp blocks
# ---------------------------------------------------------------------------

_SWIGLU = ("*.wi.w", "*.wg.w", "*.wo.w")
_MOE_KEPT = ("embed.w", "lm_head.w", "blocks_dense.mlp.w?.w",
             "blocks_moe.moe.w?.w", "blocks_moe.moe.shared.w?.w")
#: each case's plan on (data=4, model=2): the leaves it computes with on
#: their model block (path patterns), and for the leaves gathered whole
#: whose spec cuts them over model, a pattern -> a phrase of the reason
#: (any other leaf: its spec does not cut it over model).
PLAN_RULES = {
    "smollm_tp": (("embed.w", "blocks.mlp.w?.w"), {
        "blocks.attn.w?.w": "3 query heads and 1 KV heads do not both "
                            "divide by model=2",
        "blocks.ln?.scale": "no rule"}),
    "smollm_heads": (("embed.w", "blocks.mlp.w?.w", "blocks.attn.w?.w"),
                     {"blocks.ln?.scale": "no rule"}),
    "moe_tp": (_MOE_KEPT + ("blocks_*.attn.w?.w",), {
        "*.router.w": "the router: every rank routes every token",
        "*.ln?.scale": "no rule"}),
    "moe_dp_only": ((), {}),
    "deepseek_tp": (_MOE_KEPT + (
        "*.attn.wq_b.w", "*.attn.wkv_b.w", "*.attn.wo.w",
        "mtp.block.mlp.w?.w", "mtp.proj.w"), {
        "*.attn.w*_a.w": "a latent's columns, not heads",
        "*.router.w": "the router: every rank routes every token",
        "*.attn.*_norm.scale": "no rule",
        "*.ln?.scale": "no rule"}),
    "mamba2_tp": (("embed.w", "blocks.ssm.*"), {"blocks.ln.scale": "no rule"}),
    "vlm_tp": (("embed.w", "lm_head.w", "frontend_proj.w", "blocks.mlp.w?.w",
                "blocks.attn.wq.w", "blocks.attn.wo.w"), {
        "blocks.attn.w[kv].w": "1 KV heads do not divide by model=2: K "
                               "and V computed whole",
        "*.ln?.scale": "no rule"}),
    "audio_tp": (("embed.w", "lm_head.w", "frontend_proj.w",
                  "blocks.mlp.w?.w", "blocks.attn.w?.w"),
                 {"*.ln?.scale": "no rule"}),
    "hybrid_tp": (("embed.w", "lm_head.w", "*.rec.*", "*.mlp.w?.w",
                   "super.attn.attn.wq.w", "super.attn.attn.wo.w"), {
        "super.attn.attn.w[kv].w": "1 KV heads do not divide by model=2: "
                                   "K and V computed whole",
        "*.ln?.scale": "no rule"}),
}
#: case -> the numpy parameters it starts from.
CASE_PARAMS = {"smollm_tp": "lm_params", "smollm_heads": "lm_heads_params",
               "moe_tp": "moe_params", "moe_dp_only": "moe_params",
               "deepseek_tp": "ds_params",
               **{case: key for case, (_, key) in W.CONV_FAMILIES.items()},
               **{case: key for case, (_, key, _) in
                  W.FRONTEND_CASES.items()}}
#: the taken leaves (gathered whole, computed with on a slice): pattern ->
#: (the dim sliced, its width every rank computes with whole: Mamba2's B
#: and C); the rest of the dim is cut into this rank's half.
TAKEN = {"blocks.ssm.in_proj.w": (-1, 2 * CONV_CFGS["mamba2_tp"].ssm_state),
         "blocks.ssm.conv_w.w": (-1, 2 * CONV_CFGS["mamba2_tp"].ssm_state),
         "blocks.ssm.out_proj.w": (-2, 0), "*.rec.wout.w": (-2, 0)}


def _paths(tree, path=()):
    """``{"a.b.w": array}`` in the order the port's trees walk."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_paths(tree[k], path + (str(k),)))
        return out
    return {".".join(path): tree}


def _kept(case, path) -> bool:
    return any(fnmatch.fnmatch(path, pat) for pat in PLAN_RULES[case][0])


@pytest.mark.parametrize("case", list(PLAN_RULES))
def test_each_ranks_plan_is_the_rule(runs, case):
    """Kept on its model block, or gathered whole with the rule's reason,
    leaf by leaf, on every rank."""
    whole = _paths(runs["inputs"][CASE_PARAMS[case]])
    reasons = PLAN_RULES[case][1]
    for r in runs["ranks"]:
        plan = r[case]["plan"]
        assert sorted(plan) == sorted(whole)
        for path, (keep, why) in plan.items():
            assert keep == _kept(case, path), (path, keep, why)
            if not keep:
                want = next((v for pat, v in reasons.items()
                             if fnmatch.fnmatch(path, pat)),
                            "its spec does not cut it over model")
                assert want in why, (path, why)


def _taken(path):
    return next((v for pat, v in TAKEN.items()
                 if fnmatch.fnmatch(path, pat)), None)


@pytest.mark.parametrize("case", list(PLAN_RULES))
def test_bytes_a_rank_gathers_are_the_plans_count(runs, case):
    """Each step gathers a kept leaf's model block (half of it) and every
    other leaf whole, a taken one too, and computes with a kept leaf's
    block, a taken leaf's slice (its own half, B and C whole) and every
    other leaf whole: the plan's counts, below the whole under tp."""
    whole = _paths(runs["inputs"][CASE_PARAMS[case]])
    gathered = computed = 0
    for p, a in whole.items():
        take, kept = _taken(p), _kept(case, p)
        gathered += a.nbytes // (2 if kept and take is None else 1)
        if take is None:
            computed += a.nbytes // (2 if kept else 1)
        else:
            dim, shared = take
            computed += a.nbytes // a.shape[dim] * (
                (a.shape[dim] - shared) // 2 + shared)
    for r in runs["ranks"]:
        assert r[case]["gathered_bytes"] == [gathered] * W.STEPS
        assert r[case]["computed_bytes"] == [computed] * W.STEPS
    total = sum(a.nbytes for a in whole.values())
    assert computed == total if case == "moe_dp_only" else computed < total
    assert computed <= gathered <= total


@pytest.mark.parametrize("case,want", [
    ("moe_tp", 4), ("moe_capacity", 4), ("moe_accum", 4),
    ("deepseek_tp", 4), ("moe_dp_only", 8)])
def test_expert_einsums_run_this_ranks_experts(runs, case, want):
    """Under tp each rank's expert einsums run its 4 of the 8 experts;
    under dp_only (no model blocks) all 8."""
    for r in runs["ranks"]:
        assert r[case]["experts_computed"] == [want]


@pytest.mark.parametrize("case", ["moe_tp", "moe_dp_only", "moe_capacity",
                                  "deepseek_tp"])
def test_no_token_is_routed_otherwise(runs, case):
    """Step 0's experts and kept choices of every rank's tokens in every
    MoE layer are those of the port's unsharded step on the global batch:
    the router, whole on every rank, routes as it does unsharded."""
    from repro_torch.models import moe as MOE
    arch, params, toks = W.MOE_CASES[case][:3]
    cfg = get_smoke_config({"moonshot": "moonshot-v1-16b-a3b",
                            "deepseek": "deepseek-v3-671b"}[arch])
    batch = tree_from_numpy({"tokens": runs["inputs"][toks],
                             "targets": runs["inputs"][toks]}, "cpu")
    with MOE.recording() as log:
        TS._value_and_grad(TS.loss_fn, tree_from_numpy(
            runs["inputs"][params], "cpu"), batch, cfg)
    want = log[:len(runs["ranks"][0][case]["routes"])]
    for r in runs["ranks"]:
        for got, ref in zip(r[case]["routes"], want):
            lo, n = got["first"], len(got["experts"])
            assert got["experts"] == ref["experts"][lo:lo + n].tolist()
            assert got["kept"] == ref["kept"][lo:lo + n].tolist()


@pytest.mark.parametrize("case", ["smollm_tp", "smollm_heads", "moe_tp",
                                  "moe_accum", "deepseek_tp",
                                  *W.CONV_FAMILIES, *W.FRONTEND_CASES])
def test_replicated_parameters_are_bit_identical(runs, case):
    """After 3 steps every leaf the plan gathers whole is the same bits
    on every rank (a kept leaf's blocks differ by construction)."""
    assert len({r[case]["replicated"] for r in runs["ranks"]}) == 1


def test_heads_on_blocks_match_jax_single_device(runs):
    """SmolLM with 4 query and 2 KV heads: each rank attends over its 2
    heads and their KV head, ``wo``'s partial outputs summed over model,
    within the tolerance of JAX's step on the same config."""
    i = runs["inputs"]
    want = _jax_run(JCFG_HEADS, i["lm_heads_params"], i["lm_batch"])
    per_rank = [r["smollm_heads"] for r in runs["ranks"]]
    _assert_matches(per_rank, want)
    assert len({r["params"] for r in per_rank}) == 1


@pytest.mark.parametrize("case", list(W.CONV_FAMILIES))
def test_conv_families_on_model_blocks_match_jax_single_device(runs, case):
    """Mamba2 (each rank its 2 of 4 heads) and recurrentgemma (its 32 of
    64 RG-LRU channels, 2 of 4 query heads against the one KV head) under
    tp, the depthwise conv under pallas on this rank's batch and channel
    block: within the tolerance of JAX's step, the same on every rank.
    The conv hook takes the block as the whole conv: it cuts the batch
    block no further and drops the channel cut of a grouped conv, so no
    weight grad is summed over model (``mesh:*`` events).  The RG-LRU's
    gates read the conv output gathered once a layer a pass (3 layers,
    remat), Mamba2 gathers nothing."""
    i = runs["inputs"]
    want = _jax_run(CONV_CFGS[case], i[W.CONV_FAMILIES[case][1]],
                    i["lm_batch"])
    per_rank = [r[case] for r in runs["ranks"]]
    _assert_matches(per_rank, want)
    assert len({r["params"] for r in per_rank}) == 1
    for r in per_rank:
        ev = r["events"]
        assert set(ev) == {"mesh:conv2d:data", "mesh:drop:cout"}, ev
        assert ev["mesh:conv2d:data"] == ev["mesh:drop:cout"], ev
        gathers = 3 * 2 * W.STEPS if case == "hybrid_tp" else 0
        assert r["collectives"]["gathers"] == gathers, r["collectives"]


@pytest.mark.parametrize("case", [*W.CONV_FAMILIES, *W.BLOCK_FAMILIES])
def test_whole_tensor_paths_are_unchanged(runs, case):
    """Serving (a prefill and 3 decode steps: DeepSeek's absorbed MLA
    decode; none for internvl2 and hubert) and 2 unsharded steps on whole
    tensors give the same bits through the layers as through their
    versions that know no Mamba2, RG-LRU, MQA or MLA blocks and no
    ``d_model`` columns of the frontends or the MTP head
    (``tests/_torch_whole_layers.py``)."""
    got = runs["ranks"][0]["whole_paths"][case]
    assert got["now"] == got["before"], got


@pytest.mark.parametrize("case", list(W.FRONTEND_CASES))
def test_frontends_on_blocks_match_jax_single_device(runs, case):
    """internvl2 (8 images a row ahead of its text; 2 of 4 query heads
    against its one KV head) and hubert (64 frames a row, bidirectional)
    under tp, ``frontend_proj`` on this rank's 32 of 64 ``d_model``
    columns, its output gathered over model once a step: within the
    tolerance of JAX's step, the same on every rank."""
    i = runs["inputs"]
    arch, params, batch = W.FRONTEND_CASES[case]
    want = _jax_run(FRONTEND_CFGS[case], i[params], i[batch])
    per_rank = [r[case] for r in runs["ranks"]]
    _assert_matches(per_rank, want)
    assert len({r["params"] for r in per_rank}) == 1
    assert {r["rows"] for r in per_rank} == {2}
    for r in per_rank:
        assert r["collectives"]["gathers"] == W.STEPS, r["collectives"]


def test_mla_and_mtp_run_on_their_blocks(runs):
    """DeepSeek-V3 under tp (held to JAX above, with the MoE cases): no
    leaf is gathered whole for want of a rule, and ``mtp.proj``'s output
    is gathered over model once a step (the only ``join``; MLA gathers
    nothing)."""
    for r in runs["ranks"]:
        plan = r["deepseek_tp"]["plan"]
        assert not any("not ported" in why for _, why in plan.values())
        assert plan["mtp.proj.w"][0] and plan["mtp.block.attn.wq_b.w"][0]
        assert r["deepseek_tp"]["collectives"]["gathers"] == W.STEPS


def _jax_case(runs, case) -> dict:
    """JAX's single-device step on the inputs of a tp case."""
    i = runs["inputs"]
    if case in W.CONV_FAMILIES:
        return _jax_run(CONV_CFGS[case], i[W.CONV_FAMILIES[case][1]],
                        i["lm_batch"])
    if case in W.FRONTEND_CASES:
        _, params, batch = W.FRONTEND_CASES[case]
        return _jax_run(FRONTEND_CFGS[case], i[params], i[batch])
    if case in W.MOE_CASES:
        return _jax_moe(runs, case)
    if case == "smollm_heads":
        return _jax_run(JCFG_HEADS, i["lm_heads_params"], i["lm_batch"])
    return _jax_run(JCFG, i["lm_params"], i["lm_batch"])


@pytest.mark.parametrize("mutant,case,key", [
    ("wo_psum_mutant", "smollm_heads", "losses"),
    ("norm_mutant", "smollm_tp", "grad_norms"),
    ("ssm_norm_mutant", "mamba2_tp", "losses"),
    ("ssm_bc_mutant", "mamba2_tp", "grad_norms"),
    ("gather_mutant", "hybrid_tp", "grad_norms"),
    ("mla_rope_mutant", "deepseek_tp", "grad_norms"),
    ("join_mutant", "deepseek_tp", "grad_norms")])
def test_tp_mutations_read_outside_the_tolerance(runs, mutant, case, key):
    """``wo``'s partial outputs left unsummed read outside the tolerance
    on the losses; a norm that counts each replicated leaf once per model
    rank on the norms; Mamba2's gated norm over this rank's channels only
    on the losses; B and C not entering the heads' block (their grads
    this rank's heads' only), a gather whose backward skips the sum over
    model, MLA's rope key not entering its heads, and the MTP head's
    ``join`` summing its grad over model (a grad already whole counted
    twice) on the norms."""
    want = _jax_case(runs, case)
    got = runs["ranks"][0][mutant][key]
    assert _close(runs["ranks"][0][case][key], want[key])
    assert not _close(got, want[key]), (got, want[key])


# ---------------------------------------------------------------------------
# The grad sync's reduce-scatter and the fold sent to owners only
# ---------------------------------------------------------------------------

def test_collectives_are_bit_equal_to_gather_and_add(runs):
    """``Mesh.psum`` (over data, model and both), ``psum_scatter`` (each
    axis; 7 and 13 rows do not divide by 4 or 2) and
    ``psum_scatter_flat`` (a cut dim and whole tensors in one buffer), in
    float32 and bf16, are ``torch.equal`` to every rank's whole tensor
    gathered and added in coordinate order, cut to this rank's block."""
    for r in runs["ranks"]:
        got = {k: v for k, v in r["collectives_check"].items()
               if k != "wire"}
        assert len(got) == 2 * (3 * 5 + 2) and all(got.values()), \
            [k for k, v in got.items() if not v]
        assert any(" 7x3 " in k for k in got) and any(" 13 " in k
                                                      for k in got)


@pytest.mark.parametrize("case", list(W.SYNC_CASES))
def test_grad_blocks_equal_the_old_sync_cut(runs, case):
    """The first step's fold and grad sync leave every grad as its
    parameter's block, ``torch.equal`` to the old fold and to the old
    whole sums cut to the same blocks, on every rank."""
    for r in runs["ranks"]:
        res = r["sync_cases"][case]
        assert res["fold_equal"] and res["sync_equal"], res
        assert res["leaves"] > 0


def _sync_plan(case):
    """The parameters of ``case`` and the port's plan of them on an
    abstract (data=4, model=2) mesh."""
    from repro_torch.dist import tensor_parallel as TP
    arch, key = W.SYNC_CASES[case]
    params = tree_from_numpy(_SPMD_INPUTS[key], "cpu")
    mesh = Mesh(("data", "model"), W.SHAPE)
    specs = SH.param_specs(params, mesh, "tp")
    return params, TP.plan(specs, get_smoke_config(arch), mesh)


def _axis_dim(spec, axis):
    return next((d for d, e in enumerate(spec) if e == axis), None)


def _want_sync_bytes(case, coord) -> tuple[int, int]:
    """What a rank at ``coord`` sends and receives in the grad sync,
    worked out from the plan and the specs: over ``data`` (4), a leaf cut
    on it sends 3 of its 4 blocks and receives 3 parts of its own, the
    rest go through one flat buffer padded to 4 shares, scattered and
    gathered; over ``model`` (2), coordinate 0 sends the other its block
    of each leaf not kept on its model block (the whole of one the spec
    does not cut on ``model``), which receives it."""
    from repro_torch.tree import tree_leaves
    params, plan = _sync_plan(case)
    n, m = W.SHAPE
    cut = whole = 0
    cur = []
    for p, s, k in zip(tree_leaves(params), tree_leaves(plan.compute_specs),
                       plan.kept):
        es = p.element_size()
        x = p.numel() // (m if k else 1)
        if _axis_dim(s, "data") is not None:
            cut += x * es // n
            x //= n
        else:
            whole += x
        cur.append((x * es, s, k))
    sent = received = (n - 1) * cut
    if whole:
        share = -(-whole // n) * es
        sent += 2 * (n - 1) * share
        received += 2 * (n - 1) * share
    for b, s, k in cur:
        if k:
            continue
        b //= m if _axis_dim(s, "model") is not None else 1
        if coord["model"] == 0:
            sent += (m - 1) * b
        else:
            received += b
    return sent, received


def _want_fold_bytes(case, coord) -> tuple[int, int]:
    """What a rank sends and receives in the fold, element by element: an
    own range of a taken leaf comes from the rank whose units it holds, a
    shared range from coordinate 0; each element goes to the rank whose
    stored block holds it, if that is another rank."""
    from repro_torch.tree import tree_leaves
    params, plan = _sync_plan(case)
    m, me = W.SHAPE[1], coord["model"]
    sent = received = 0
    for p, s, leaf in zip(tree_leaves(params), tree_leaves(plan.specs),
                          tree_leaves(plan.tree)):
        if leaf.take is None:
            continue
        dt = leaf.take.dim % p.dim()
        db = _axis_dim(s, "model")
        src = []
        for width, own in leaf.take.parts:
            src += [i * m // width if own else 0 for i in range(width)]
        per = p.numel() // p.shape[dt] * p.element_size()
        if dt == db:
            owner = [x * m // p.shape[dt] for x in range(p.shape[dt])]
            sent += per * sum(a == me != o for a, o in zip(src, owner))
            received += per * sum(o == me != a for a, o in zip(src, owner))
        else:
            mine = sum(a == me for a in src)
            sent += mine * per * (m - 1) // m
            received += (len(src) - mine) * per // m
    return sent, received


@pytest.mark.parametrize("case", list(W.SYNC_CASES))
def test_sync_and_fold_bytes_are_the_plans_counts(runs, case):
    """``COUNTS["scatter_bytes"]`` / ``scatter_received`` and
    ``fold_bytes`` / ``fold_received`` of each rank's step are the counts
    worked out from the plan and the specs, and below what the
    gather-and-add forms send and receive (the data axis has 4 ranks)."""
    for r in runs["ranks"]:
        res = r["sync_cases"][case]
        sent, received = _want_sync_bytes(case, r["coordinate"])
        assert (res["scatter_bytes"], res["scatter_received"]) == (
            sent, received), (res, sent, received)
        assert sent < res["old_sync_sent"]
        assert received < res["old_sync_received"]
        fsent, freceived = _want_fold_bytes(case, r["coordinate"])
        assert (res["fold_bytes"], res["fold_received"]) == (
            fsent, freceived), (res, fsent, freceived)
        if case == "mamba2_tp":
            assert 0 < fsent < res["old_fold_sent"]
            assert 0 < freceived < res["old_fold_received"]
        else:
            assert fsent == freceived == res["old_fold_sent"] == 0


def test_dropping_scatter_reads_outside_the_tolerance(runs):
    """A reduce-scatter whose owner drops the next member's part: the
    grads miss a batch block, and the norms read outside the tolerance of
    JAX's step."""
    i = runs["inputs"]
    want = _jax_run(JCFG, i["lm_params"], i["lm_batch"])
    got = runs["ranks"][0]["scatter_mutant"]
    assert _close(runs["ranks"][0]["smollm_tp"]["grad_norms"],
                  want["grad_norms"])
    assert not _close(got["grad_norms"], want["grad_norms"]), (
        got["grad_norms"], want["grad_norms"])
