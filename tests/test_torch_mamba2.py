"""The port's SSM family (Mamba2) against the JAX package on the CPU, at
mamba2-370m's smoke config in float32 with the JAX model's parameters
carried across by ``params_from_numpy``:

* ``depthwise_causal_conv1d`` forward, dx and dw under every policy
  (``lax``, ``bp_phase``, ``auto``, ``traditional``, ``bp_im2col`` and
  ``pallas`` -- the port's plain kernel versions here; JAX's ``pallas``
  falls back on this jax), 1e-5;
* ``_ssd_chunked`` against JAX's at a length the chunk divides, and the
  port's ragged last chunk against the naive O(L) recurrence (the oracle
  of ``tests/test_models.py``), 1e-5;
* ``mamba2_block``, ``mamba2_decode`` and ``forward`` logits, 1e-5;
* the port's one-pass ``prefill`` against JAX's scan of decode steps at a
  prompt length a small ``ssd_chunk`` does not divide: logits and every
  cache leaf, 1e-5;
* greedy tokens through both port engines (under ``auto`` and ``pallas``)
  against the JAX engines (identical); ``lane_insert`` of an SSM cache;
* 10 ``make_train_step`` losses within 1e-4 of JAX's, under ``lax`` and
  ``pallas``;
* the config, registry, ``conv_policy`` plumbing and the tap kernels'
  plans keyed by operand type (the grid-z limit at Mamba2's 2,304
  groups).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import depthwise_causal_conv1d as jdwconv  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import mamba2 as jM2  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serve import cache as jC  # noqa: E402
from repro.train import train_step as jTS  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import depthwise_causal_conv1d  # noqa: E402
from repro_torch.core.config import config  # noqa: E402
from repro_torch.core.im2col_ref import ConvDims  # noqa: E402
from repro_torch.data import pipeline as pipe  # noqa: E402
from repro_torch.kernels import autotune, ops  # noqa: E402
from repro_torch.kernels import tap_gemm as tg  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import cache as C  # noqa: E402
from repro_torch.serve.continuous import ContinuousEngine  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.tree import (params_from_numpy,  # noqa: E402
                              tree_from_numpy)

ARCH = "mamba2-370m"
CFG = get_smoke_config(ARCH)
JCFG = jget_smoke(ARCH)
POLICIES = ("lax", "bp_phase", "auto", "traditional", "bp_im2col", "pallas")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _toks(seed, shape):
    return np.random.RandomState(seed).randint(0, CFG.vocab, shape)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jM.init_params(jax.random.PRNGKey(0),
                                                   JCFG))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jparams, device="cpu")


def test_config_and_registry_match_jax():
    for mine, theirs in ((CFG, JCFG), (get_config(ARCH), jget_config(ARCH))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
        assert mine.is_attention_free == theirs.is_attention_free is True
        assert mine.supports_long_context == theirs.supports_long_context
        assert [mine.layer_kind(i) for i in range(3)] == \
            [theirs.layer_kind(i) for i in range(3)] == ["ssm"] * 3
    assert configs.get_config("mamba2_370m") is configs.get_config(ARCH)
    assert (M2.d_inner(CFG), M2.n_heads(CFG)) == (jM2.d_inner(JCFG),
                                                  jM2.n_heads(JCFG))
    full = get_config(ARCH)
    assert M2.d_inner(full) + 2 * full.ssm_state == 2304


def test_conv_engine_policy_and_deprecated_mode():
    cfg = dataclasses.replace(CFG, conv_policy="fwd=pallas,dgrad=lax,"
                                               "wgrad=bp_phase")
    assert cfg.conv_engine_policy == cfg.conv_policy
    old = dataclasses.replace(cfg, conv_mode="traditional")
    with pytest.deprecated_call():
        assert old.conv_engine_policy == "traditional"
    for cls in (Engine, ContinuousEngine):
        eng = cls(old, {"embed": {"w": torch.zeros(1)}}, max_len=8,
                  conv_policy="pallas")
        assert (eng.cfg.conv_policy, eng.cfg.conv_mode) == ("pallas", None)


@pytest.mark.parametrize("policy", POLICIES)
def test_depthwise_causal_conv1d_matches_jax(policy):
    r = np.random.RandomState(POLICIES.index(policy))
    x = r.randn(2, 19, 40).astype(np.float32)
    w = r.randn(4, 40).astype(np.float32)
    dy = r.randn(2, 19, 40).astype(np.float32)

    def jloss(x_, w_):
        return jnp.sum(jdwconv(x_, w_, policy=policy) * dy)
    want = jdwconv(jnp.asarray(x), jnp.asarray(w), policy=policy)
    jdx, jdw = jax.grad(jloss, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    got = depthwise_causal_conv1d(tx, tw, policy)
    got.backward(torch.tensor(dy))
    _close(got.detach(), want, 1e-5)
    _close(tx.grad, jdx, 1e-5)
    _close(tw.grad, jdw, 1e-5)


def _ssd_inputs(l, seed=0, b=1, h=2, p=8, s=4):
    r = np.random.RandomState(seed)
    return (r.randn(b, l, h, p).astype(np.float32),
            (np.abs(r.randn(b, l, h)) * 0.1).astype(np.float32),
            (r.randn(h) * 0.1).astype(np.float32),
            r.randn(b, l, s).astype(np.float32),
            r.randn(b, l, s).astype(np.float32))


def _naive_ssd(xh, dt, a_log, B, C):
    """The O(L) recurrence of ``tests/test_models.py``: outputs and the
    final state."""
    b, l, h, p = xh.shape
    a = np.exp(dt * (-np.exp(a_log))[None, None])
    state = np.zeros((b, h, p, B.shape[-1]))
    ys = []
    for t in range(l):
        upd = np.einsum("bh,bhp,bs->bhps", dt[:, t], xh[:, t], B[:, t])
        state = state * a[:, t][:, :, None, None] + upd
        ys.append(np.einsum("bhps,bs->bhp", state, C[:, t]))
    return np.stack(ys, axis=1), state


def test_ssd_chunked_matches_jax_where_the_chunk_divides():
    ins = _ssd_inputs(256)
    with config.override(ssd_chunk=64):
        got, _ = M2._ssd_chunked(*map(torch.from_numpy, ins))
    want = jM2._ssd_chunked(*map(jnp.asarray, ins))   # JAX's default 128
    _close(got, want, 1e-5)


@pytest.mark.parametrize("l,chunk", [(100, 32), (37, 16), (5, 8), (130, 128)])
def test_ssd_ragged_chunk_matches_the_naive_recurrence(l, chunk):
    """A length the chunk does not divide: outputs and final state equal
    the O(L) recurrence (the padded positions change nothing)."""
    ins = _ssd_inputs(l, seed=l)
    with config.override(ssd_chunk=chunk):
        got, state = M2._ssd_chunked(*map(torch.from_numpy, ins))
    want, want_state = _naive_ssd(*ins)
    _close(got, want, 1e-5)
    _close(state, want_state, 1e-5)


def test_mamba2_block_and_decode_match_jax(jparams, params):
    r = np.random.RandomState(5)
    x = r.randn(2, 24, CFG.d_model).astype(np.float32)
    p = _layer(params["blocks"]["ssm"], 1)
    jp = _layer(jparams["blocks"]["ssm"], 1)
    _close(M2.mamba2_block(p, torch.from_numpy(x), CFG),
           jM2.mamba2_block(jp, jnp.asarray(x), JCFG), 1e-5)
    state = jM2.mamba2_init_state(JCFG, 2, 1)
    ssm = r.randn(*state["ssm"].shape[1:]).astype(np.float32)
    conv = r.randn(*state["conv"].shape[1:]).astype(np.float32)
    got = M2.mamba2_decode(p, torch.from_numpy(x[:, :1]),
                           torch.from_numpy(ssm), torch.from_numpy(conv),
                           CFG)
    want = jM2.mamba2_decode(jp, jnp.asarray(x[:, :1]), jnp.asarray(ssm),
                             jnp.asarray(conv), JCFG)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-5)


def test_forward_logits_and_counts_match_jax(jparams, params):
    toks = _toks(3, (2, 40))
    got, aux = M.forward(params, {"tokens": torch.from_numpy(toks)}, CFG)
    want, jaux = jM.forward(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                            JCFG)
    assert got.shape == (2, 40, CFG.vocab) and aux == jaux == {}
    _close(got, want, 1e-5)
    assert M.count_params(params) == jM.count_params(jparams)
    assert M.count_active_params(params, CFG) == \
        jM.count_active_params(jparams, JCFG)


@pytest.mark.parametrize("plen", [37, 2])
def test_prefill_matches_jax_scan(jparams, params, plen):
    """The one-pass prefill (SSD chunk 16: a ragged last chunk at 37; a
    prompt shorter than the conv state at 2) against JAX's scan of decode
    steps: logits and every cache leaf."""
    toks = _toks(7, (2, plen))
    with config.override(ssd_chunk=16):
        logits, cache = M.prefill(params, torch.from_numpy(toks), CFG,
                                  plen + 4)
    want, jcache = jM.prefill(jparams, jnp.asarray(toks, jnp.int32), JCFG,
                              plen + 4)
    _close(logits, want, 1e-5)
    assert sorted(cache["blocks"]) == sorted(jcache["blocks"]) == \
        ["conv", "ssm"]
    for key in ("ssm", "conv"):
        assert tuple(cache["blocks"][key].shape) == \
            jcache["blocks"][key].shape
        _close(cache["blocks"][key], jcache["blocks"][key], 1e-5)
    # The decode step after it agrees too.
    nxt = toks[:, -1]
    got, _ = M.decode_step(params, cache, torch.from_numpy(nxt), plen, CFG)
    wnt, _ = jM.decode_step(jparams, jcache, jnp.asarray(nxt, jnp.int32),
                            jnp.int32(plen), JCFG)
    _close(got, wnt, 1e-5)


def test_lane_insert_of_an_ssm_cache_matches_jax():
    r = np.random.RandomState(0)
    cache = jax.tree.map(np.asarray, jM2.mamba2_init_state(JCFG, 3, 4))
    cache = {"blocks": {k: r.randn(*v.shape).astype(np.float32)
                        for k, v in cache.items()}}
    src = {"blocks": {k: r.randn(v.shape[0], 1, *v.shape[2:])
                      .astype(np.float32)
                      for k, v in cache["blocks"].items()}}
    tcache = T.init_cache(CFG, 3, 16, "cpu")
    assert {k: tuple(v.shape) for k, v in tcache["blocks"].items()} == \
        {k: v.shape for k, v in cache["blocks"].items()}
    got = C.lane_insert(jax.tree.map(torch.tensor, cache),
                        jax.tree.map(torch.tensor, src), 1)
    want = jC.lane_insert(jax.tree.map(jnp.asarray, cache),
                          jax.tree.map(jnp.asarray, src), jnp.int32(1))
    for key in ("ssm", "conv"):
        np.testing.assert_array_equal(got["blocks"][key].numpy(),
                                      np.asarray(want["blocks"][key]))


ARGV = ["--arch", ARCH, "--requests", "5", "--max-new", "6",
        "--prompt-len", "21", "--max-batch", "2"]


@pytest.mark.parametrize("policy", ["auto", "pallas"])
@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_greedy_tokens_match_the_jax_engines(engine, policy, jparams,
                                             monkeypatch):
    """Both engines through the launcher (SSD chunk 8: each 21-token
    prefill ends in a ragged chunk) give JAX's greedy tokens."""
    want = jserve.main(ARGV + ["--engine", engine])
    monkeypatch.setattr(tserve, "init_params", lambda cfg, seed, dev:
                        params_from_numpy(jparams, dev))
    with config.override(ssd_chunk=8):
        res = tserve.main(ARGV + ["--engine", engine, "--device", "cpu",
                                  "--conv-policy", policy])
    got = res["requests"]
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert g.status == w.status == "ok"
        assert g.out == w.out, (g.rid, g.out, w.out)
    assert res["summary"]["completed"] == 5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("policy", ["lax", "pallas"])
def test_ten_train_step_losses_match_jax(jparams, policy):
    """10 guarded steps from JAX's init under one conv policy: losses and
    grad norms within 1e-4 of JAX's step."""
    opt_cfg = dict(peak_lr=5e-3)
    kw = dict(total_steps=10, warmup=2, guard=True, conv_policy=policy)
    jstep = jax.jit(jTS.make_train_step(JCFG, jadamw.AdamWConfig(**opt_cfg),
                                        **kw))
    tstep = TS.make_train_step(CFG, adamw.AdamWConfig(**opt_cfg), **kw)
    jp = jax.tree.map(jnp.asarray, jparams)
    jo = jadamw.init_state(jp)
    tp = tree_from_numpy(jparams, "cpu")
    to = tree_from_numpy(_np(jo), "cpu")
    dcfg = pipe.DataConfig(seed=3, seq_len=32, global_batch=4,
                           vocab=CFG.vocab)
    for s in range(10):
        b = pipe.make_batch(CFG, dcfg, s)
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b),
                           jnp.int32(s))
        tp, to, tm = tstep(tp, to, tree_from_numpy(b, "cpu"), s)
        for k in ("loss", "grad_norm", "guard_bad"):
            _close(tm[k], jm[k], 1e-4)


def test_tap_plans_are_keyed_by_operand_type():
    """The tuner keys a plan by the operands' type as well: a float32
    timing is never served to the bf16 instance."""
    d = ConvDims(B=8, C=1, H_i=1, W_i=512, N=1, K_h=1, K_w=4, P_w=3,
                 P_h_hi=0, P_w_hi=0)
    card = autotune.Card("NVIDIA H100 80GB HBM3", (9, 0), 132)
    keys = {autotune.plan_key(r, d, 2304, card, dt)
            for r in ops.PLAN_ROLES for dt in (torch.float32,
                                               torch.bfloat16)}
    assert len(keys) == 6
    assert ops.problem("forward", d, 2304, torch.bfloat16).dtype == "bf16"
    assert ops.problem("forward", d, 2304).dtype == "f32"
    with pytest.raises(TypeError, match="no tap kernel takes"):
        ops.problem("forward", d, 2304, torch.float16)


def test_a_plan_past_the_grid_z_limit_is_refused_at_mamba2_width():
    """Mamba2-370M's conv is 2,304 groups: a weight-grad plan of 32 splits
    would put 73,728 blocks on the grid's z; ``plan_gap`` refuses it, and
    no candidate of any role breaches the limit: a tile's groups x splits
    (or x work rows) on the grid's z, a dw plan's threads on the grid's
    x."""
    d = ConvDims(B=8, C=1, H_i=1, W_i=512, N=1, K_h=1, K_w=4, P_w=3,
                 P_h_hi=0, P_w_hi=0)
    g = 2304
    prob = ops.problem("weight_grad", d, g, torch.bfloat16)
    assert "grid z = 73728" in tg.plan_gap(
        prob, tg.Plan("weight_grad", "64x16", 32))
    for role in ops.PLAN_ROLES:
        prob = ops.problem(role, d, g, torch.bfloat16)
        plans = tg.candidate_plans(prob, 132)
        assert plans and plans[0] == tg.analytic_plan(prob, 132)
        assert plans[0].variant == "dw"
        for plan in plans:
            assert tg.plan_gap(prob, plan) is None
            if plan.variant == "dw":
                blocks = (g * plan.splits if role == "weight_grad" else
                          tg._cdiv(g * len(prob.counts) * tg.dw_units(prob),
                                   tg.DW_THREADS))
                assert blocks <= tg.INT32_MAX, (role, plan)
                continue
            z = plan.splits if role != "input_grad" else len(tg.phased_work(
                prob.counts, prob.cin, plan.splits,
                tg.PHASED_TILES[plan.variant].step)[0])
            assert z * g <= tg.GRID_YZ_MAX, (role, plan)
