"""The port's LM training stack against the JAX package on the CPU, at
SmolLM-360M's smoke config in float32 and on the same numpy inputs:

* attention under autograd: ``gqa_train``'s weight gradients against
  ``jax.grad`` (1e-5), dense and blockwise, and the flash wrapper's
  refusal of a tensor that requires grad;
* the data pipeline (identical batches), losses and schedules (1e-6),
  int8 compression fed JAX's noise (identical ``q`` and scale) and top-k;
* ``make_train_step`` from carried JAX state: accumulation 1 and 2 with
  the guard on (1e-4), a NaN loss at steps 1-3 (the guard's metrics equal,
  params held), remat on and off;
* the fault-tolerance bookkeeping on a scripted sequence;
* the launcher: 12 steps against ``repro.launch.train.main`` (1e-4), and
  the port's own loss-decrease, resume and flag checks.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core.config import config as jconfig  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.ft import failures as jft  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro.train import losses as jlosses  # noqa: E402
from repro.train import train_step as jTS  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.config import config  # noqa: E402
from repro_torch.data import pipeline as pipe  # noqa: E402
from repro_torch.ft import failures as ft  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw, compression, schedule  # noqa: E402
from repro_torch.train import losses  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.tree import (tree_from_numpy,  # noqa: E402,E501
                              tree_leaves)

CFG = get_smoke_config("smollm-360m")
JCFG = jget_smoke("smollm-360m")


@pytest.fixture(autouse=True)
def _one_thread():
    """torch's intra-op threads set to one for each test, restored after:
    beside other test processes, the smoke configs' small ops cost far
    more in waking a pool of threads than in the ops themselves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_trees(got, want, tol):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _close(a.detach().numpy(), b, tol)


@pytest.fixture(scope="module")
def jparams():
    return _np(jM.init_params(jax.random.PRNGKey(0), JCFG))


# ---------------------------------------------------------------------------
# Attention under autograd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,threshold", [(32, None), (40, 16)],
                         ids=["dense", "blockwise"])
def test_gqa_train_weight_grads_match_jax_grad(jparams, monkeypatch, seq,
                                               threshold):
    """The gradients of ``gqa_train`` with respect to wq, wk, wv and wo
    equal ``jax.grad``'s (1e-5): dense at 32 keys, and blockwise (16-key
    blocks, three of them) above a lowered threshold.  The flash wrapper
    is never called under autograd."""
    p = jax.tree.map(lambda a: a[0], jparams["blocks"]["attn"])
    r = np.random.RandomState(seq)
    x = r.randn(2, seq, CFG.d_model).astype(np.float32)
    ct = r.randn(2, seq, CFG.d_model).astype(np.float32)
    monkeypatch.setattr(A, "flash_attention", None)   # must not be called
    if threshold:
        monkeypatch.setattr(jA, "BLOCK_K", 16)
        monkeypatch.setattr(A, "BLOCK_K", 16)
        calls = []
        spy = A._sdpa_blockwise
        monkeypatch.setattr(A, "_sdpa_blockwise",
                            lambda *a, **k: calls.append(1) or spy(*a, **k))
    with jconfig.override(blockwise_kv_threshold=threshold or 1024), \
            config.override(blockwise_kv_threshold=threshold or 1024):
        want = jax.grad(lambda q: jnp.sum(jA.gqa_train(q, jnp.asarray(x),
                                                       JCFG) * ct))(p)
        tp = {k: {"w": torch.from_numpy(np.array(v["w"]))
                  .requires_grad_(True)} for k, v in p.items()}
        out = A.gqa_train(tp, torch.from_numpy(x), CFG)
        (out * torch.from_numpy(ct)).sum().backward()
    assert not threshold or calls == [1]
    for name in ("wq", "wk", "wv", "wo"):
        _close(tp[name]["w"].grad, want[name]["w"], 1e-5)


def test_flash_wrapper_refuses_a_tensor_that_requires_grad():
    """The fault: the kernel has no backward, so on the card its output
    had no grad_fn and the q, k, v projections lost their gradients.  The
    repair: the wrapper raises under autograd (here on the CPU too), and
    ``_sdpa`` sends a grad-carrying call to the plain attention."""
    q = torch.randn(1, 3, 8, 16, requires_grad=True)
    kv = torch.randn(1, 1, 8, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, kv, kv)
    with torch.no_grad():
        assert fa.flash_attention(q, kv, kv).shape == q.shape
    fa.flash_attention(q.detach(), kv, kv)
    o = A._sdpa(q.transpose(1, 2), kv.transpose(1, 2), kv.transpose(1, 2),
                causal=True)
    assert o.grad_fn is not None


# ---------------------------------------------------------------------------
# Data pipeline, losses, schedules, compression
# ---------------------------------------------------------------------------

ARCHS = {
    "dense": types.SimpleNamespace(family="dense", vocab=300),
    "vlm": types.SimpleNamespace(family="vlm", vocab=300, frontend_tokens=5,
                                 d_frontend=12),
    "audio": types.SimpleNamespace(family="audio", vocab=300, d_frontend=12),
}


def _equal_batches(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_pipeline_batches_are_identical(family):
    arch = ARCHS[family]
    for seed in (0, 7):
        for worker in (0, 1):
            kw = dict(seed=seed, seq_len=24, global_batch=4, worker=worker,
                      n_workers=2)
            for step in (0, 3, 11):
                _equal_batches(
                    pipe.make_batch(arch, pipe.DataConfig(**kw), step),
                    jpipe.make_batch(arch, jpipe.DataConfig(**kw), step))
    it, jit_ = (pipe.batches(arch, pipe.DataConfig(), 5),
                jpipe.batches(arch, jpipe.DataConfig(), 5))
    for _ in range(2):
        _equal_batches(next(it), next(jit_))


def test_pipeline_corpus_batches_are_identical(tmp_path):
    path = tmp_path / "corpus.npy"
    np.save(path, np.random.RandomState(0).randint(0, 300, 5000)
            .astype(np.uint16))
    for step in (0, 9):
        _equal_batches(
            pipe.make_batch(ARCHS["dense"], pipe.DataConfig(
                seq_len=32, corpus_path=str(path)), step),
            jpipe.make_batch(ARCHS["dense"], jpipe.DataConfig(
                seq_len=32, corpus_path=str(path)), step))


def test_losses_match_jax():
    r = np.random.RandomState(1)
    logits = (3 * r.randn(2, 7, 50)).astype(np.float32)
    targets = r.randint(0, 50, (2, 7)).astype(np.int32)
    mask = (r.rand(2, 7) > 0.3).astype(np.float32)
    t = torch.from_numpy
    for m in (None, mask):
        _close(losses.softmax_xent(t(logits), t(targets),
                                   None if m is None else t(m)),
               jlosses.softmax_xent(jnp.asarray(logits), jnp.asarray(targets),
                                    None if m is None else jnp.asarray(m)),
               1e-6)
    aux = {"moe_lb": np.float32(0.7), "moe_z": np.float32(2.5),
           "mtp_logits": (2 * r.randn(2, 7, 50)).astype(np.float32)}
    for keys in ((), ("moe_lb", "moe_z"), ("mtp_logits",)):
        batch = {"targets": targets, "loss_mask": mask}
        got_l, got_m = losses.train_loss(
            t(logits), {k: torch.as_tensor(aux[k]) for k in keys},
            {k: t(v) for k, v in batch.items()})
        want_l, want_m = jlosses.train_loss(
            jnp.asarray(logits), {k: jnp.asarray(aux[k]) for k in keys},
            {k: jnp.asarray(v) for k, v in batch.items()})
        _close(got_l, want_l, 1e-6)
        assert sorted(got_m) == sorted(want_m)
        for k in want_m:
            _close(got_m[k], want_m[k], 1e-6)


def test_schedules_and_default_schedule_match_jax():
    for name in ("smollm-360m", "minicpm-2b", "conv_autoencoder"):
        assert schedule.default_schedule_for(name) == \
            jschedule.default_schedule_for(name)
    for name in ("cosine", "wsd", "constant"):
        for step in (0, 3, 10, 50, 89, 90, 95, 100, 120):
            got = schedule.SCHEDULES[name](step, peak_lr=2e-3, warmup=10,
                                           total=100)
            want = float(jschedule.SCHEDULES[name](step, peak_lr=2e-3,
                                                   warmup=10, total=100))
            assert abs(got - want) <= 1e-6 * 2e-3, (name, step, got, want)


def test_int8_compression_with_jax_noise():
    """The same noise gives identical ``q`` and scale in both packages,
    and dequantized + residual gives the gradient back."""
    r = np.random.RandomState(2)
    grads = {"a": r.randn(16, 24).astype(np.float32),
             "b": [(1e-3 * r.randn(40)).astype(np.float32)]}
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    noise = {"a": np.asarray(jax.random.uniform(
        keys[0], (16, 24), jnp.float32, -0.5, 0.5)),
        "b": [np.asarray(jax.random.uniform(keys[1], (40,), jnp.float32,
                                            -0.5, 0.5))]}
    tg = tree_from_numpy(grads, "cpu")
    q, residual = compression.compress_tree_int8_with_noise(
        tg, tree_from_numpy(noise, "cpu"))
    jq, _ = jcomp.compress_tree_int8(jax.tree.map(jnp.asarray, grads),
                                     jax.random.PRNGKey(5))
    for got, (wq, ws) in zip(tree_leaves(q), [jq["a"], jq["b"][0]]):
        assert np.array_equal(got.q.numpy(), np.asarray(wq))
        assert got.scale.item() == float(ws)
    deq = compression.decompress_tree_int8(q)
    for d, res, g in zip(tree_leaves(deq), tree_leaves(residual),
                         tree_leaves(tg)):
        _close(d + res, g, 1e-7)
    gen = torch.Generator().manual_seed(0)
    q2, _ = compression.int8_quantize(tg["a"], gen)
    assert q2.dtype == torch.int8 and q2.abs().max() <= 127


def test_topk_sparsify_matches_jax():
    r = np.random.RandomState(3)              # distinct magnitudes
    x = ((r.permutation(600) + 1) * r.choice([-1, 1], 600)).reshape(
        20, 30).astype(np.float32)
    vals, idx, res = compression.topk_sparsify(torch.from_numpy(x), 0.05)
    jvals, jidx, jres = jcomp.topk_sparsify(jnp.asarray(x), 0.05)
    assert np.array_equal(vals.numpy(), np.asarray(jvals))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(res.numpy(), np.asarray(jres))
    dense = compression.topk_densify(vals, idx, x.shape)
    assert np.array_equal(dense.numpy(), np.asarray(
        jcomp.topk_densify(jvals, jidx, x.shape)))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _batches(n, batch=4, seq=32, seed=3):
    dcfg = pipe.DataConfig(seed=seed, seq_len=seq, global_batch=batch,
                           vocab=CFG.vocab)
    return [pipe.make_batch(CFG, dcfg, s) for s in range(n)]


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax_from_carried_state(jparams, accum):
    """5 guarded steps from JAX's init: losses, grad norms and params
    within 1e-4 of JAX's step at accumulation 1 and 2."""
    opt_cfg = dict(peak_lr=5e-3)
    kw = dict(total_steps=10, warmup=2, accum_steps=accum, guard=True)
    jstep = jax.jit(jTS.make_train_step(JCFG, jadamw.AdamWConfig(**opt_cfg),
                                        **kw))
    tstep = TS.make_train_step(CFG, adamw.AdamWConfig(**opt_cfg), **kw)
    jp = jax.tree.map(jnp.asarray, jparams)
    jo = jadamw.init_state(jp)
    tp = tree_from_numpy(jparams, "cpu")
    to = tree_from_numpy(_np(jo), "cpu")
    for s, b in enumerate(_batches(5)):
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b),
                           jnp.int32(s))
        tp, to, tm = tstep(tp, to, tree_from_numpy(b, "cpu"), s)
        for k in ("loss", "grad_norm", "guard_bad", "guard_streak"):
            _close(tm[k], jm[k], 1e-4)
    _close_trees(tp, jp, 1e-4)
    _close_trees(to["m"], jo["m"], 1e-4)
    assert int(to["step"]) == int(jo["step"]) == 5


def test_grad_accumulation_equivalence():
    """accum_steps=2 over a batch == accum_steps=1 over the same batch
    (the port's mirror of the JAX package's test)."""
    m = M.build_model(CFG)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    opt = adamw.init_state(params)
    toks = torch.randint(0, CFG.vocab, (4, 32),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "targets": toks}
    p1, _, m1 = TS.make_train_step(CFG, adamw.AdamWConfig(), accum_steps=1)(
        params, opt, batch, 0)
    p2, _, m2 = TS.make_train_step(CFG, adamw.AdamWConfig(), accum_steps=2)(
        params, opt, batch, 0)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def _poisoned(loss):
    """The LM loss times ``batch["poison"]`` (1 or NaN): a loss plugin that
    goes non-finite on the steps whose batch says so."""
    def plugin(params, batch, cfg):
        val, metrics = loss(params, {k: v for k, v in batch.items()
                                     if k != "poison"}, cfg)
        return val * batch["poison"], metrics
    return plugin


def test_guard_drops_nan_steps_like_jax(jparams):
    """A loss that is NaN at steps 1-3: both packages drop those steps
    (params equal to the last good step's), engage the clip at step 4 and
    report the same guard metrics; params stay within 1e-4 after."""
    kw = dict(total_steps=10, warmup=2,
              guard=TS.GuardConfig(clip_after=2, clip_norm=0.5))
    opt_cfg = dict(peak_lr=5e-3)
    jstep = jax.jit(jTS.make_train_step(
        JCFG, jadamw.AdamWConfig(**opt_cfg), loss=_poisoned(jTS.loss_fn),
        **{**kw, "guard": jTS.GuardConfig(clip_after=2, clip_norm=0.5)}))
    tstep = TS.make_train_step(CFG, adamw.AdamWConfig(**opt_cfg),
                               loss=_poisoned(TS.loss_fn), **kw)
    jp = jax.tree.map(jnp.asarray, jparams)
    jo = jadamw.init_state(jp)
    tp = tree_from_numpy(jparams, "cpu")
    to = tree_from_numpy(_np(jo), "cpu")
    seen = []
    for s, b in enumerate(_batches(6)):
        b = {**b, "poison": np.float32(np.nan if 1 <= s <= 3 else 1.0)}
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b),
                           jnp.int32(s))
        tp, to, tm = tstep(tp, to, tree_from_numpy(b, "cpu"), s)
        got = [float(tm[k]) for k in ("guard_bad", "guard_streak",
                                      "guard_clipped")]
        assert got == [float(jm[k]) for k in ("guard_bad", "guard_streak",
                                              "guard_clipped")]
        seen.append(got)
        if s == 0:
            good = [t.clone() for t in tree_leaves(tp)]
        elif s <= 3:
            assert all(torch.equal(a, b)
                       for a, b in zip(tree_leaves(tp), good))
            assert int(to["step"]) == 1
    assert seen == [[0, 0, 0], [1, 1, 0], [1, 2, 0], [1, 3, 0], [0, 0, 1],
                    [0, 0, 0]]
    _close_trees(tp, jp, 1e-4)
    assert int(to["step"]) == int(jo["step"]) == 3


@pytest.mark.parametrize("guard", [False, True])
def test_a_donated_step_equals_the_functional_step(guard, monkeypatch):
    """``make_train_step(..., donate=True)`` writes into the parameters and
    moments it is given (here in chunks of 1,000 elements, so chunks
    straddle every leaf's end): the same values as the functional step
    bit for bit, steps 2-3 poisoned with NaN (dropped by the guard) and
    the clip engaged after them; the returned trees are the tensors that
    went in."""
    monkeypatch.setattr(adamw, "UPDATE_CHUNK", 1000)
    kw = dict(total_steps=10, warmup=2, loss=_poisoned(TS.loss_fn),
              guard=TS.GuardConfig(clip_after=1) if guard else None)
    runs = {}
    for donate in (False, True):
        params = M.init_params(torch.Generator().manual_seed(0), CFG, "cpu")
        opt = adamw.init_state(params)
        step = TS.make_train_step(CFG, adamw.AdamWConfig(peak_lr=5e-3),
                                  donate=donate, **kw)
        hist = []
        for s, b in enumerate(_batches(5)):
            poison = np.nan if guard and s in (2, 3) else 1.0
            b = tree_from_numpy({**b, "poison": np.float32(poison)}, "cpu")
            ins = tree_leaves(params) + tree_leaves(opt["m"])
            params, opt, metrics = step(params, opt, b, s)
            if donate:
                assert all(a is b for a, b in zip(
                    ins, tree_leaves(params) + tree_leaves(opt["m"])))
            hist.append({k: float(v) for k, v in metrics.items()})
        runs[donate] = (hist, params, opt)
    (h0, p0, o0), (h1, p1, o1) = runs[False], runs[True]
    np.testing.assert_equal(h0, h1)         # NaN grad norms equal too
    if guard:
        assert [h["guard_bad"] for h in h0] == [0, 0, 1, 1, 0]
        assert h0[4]["guard_clipped"] == 1
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(p0) + tree_leaves(o0), tree_leaves(p1) + tree_leaves(o1)))


def test_compressed_gradients_still_train():
    """int8 compression with error feedback (the port's mirror of the JAX
    package's test): training descends and tracks the uncompressed
    trajectory; the residual rides in ``opt_state["ef"]``, and a rerun
    repeats the run bit for bit (the noise is seeded from the step)."""
    dcfg = pipe.DataConfig(seed=3, seq_len=64, global_batch=4,
                           vocab=CFG.vocab)

    def run(compress):
        params = M.init_params(torch.Generator().manual_seed(0), CFG, "cpu")
        opt = adamw.init_state(params)
        step = TS.make_train_step(CFG, adamw.AdamWConfig(peak_lr=5e-3),
                                  total_steps=20, warmup=2,
                                  compress_grads=compress)
        hist = []
        for s in range(15):
            batch = tree_from_numpy(pipe.make_batch(CFG, dcfg, s), "cpu")
            params, opt, metrics = step(params, opt, batch, s)
            hist.append(float(metrics["loss"]))
        return hist, params, opt

    plain, _, _ = run(False)
    comp, params, opt = run(True)
    assert comp[-1] < comp[0]                         # still descends
    assert abs(comp[-1] - plain[-1]) < 0.15           # tracks closely
    assert [t.shape for t in tree_leaves(opt["ef"])] == \
        [t.shape for t in tree_leaves(params)]
    again, params2, _ = run(True)
    assert again == comp and all(torch.equal(a, b) for a, b in
                                 zip(tree_leaves(params),
                                     tree_leaves(params2)))


def test_remat_gives_the_same_numbers(monkeypatch):
    """``config.remat`` "block" rematerializes each block (one checkpoint a
    layer) and "none" none; loss and grads are equal either way."""
    params = M.init_params(torch.Generator().manual_seed(0), CFG, "cpu")
    batch = tree_from_numpy(_batches(1)[0], "cpu")
    calls = []
    spy = T.checkpoint
    monkeypatch.setattr(T, "checkpoint",
                        lambda *a, **k: calls.append(1) or spy(*a, **k))
    out = {}
    for policy in ("block", "none"):
        with config.override(remat=policy):
            loss, _, grads = TS._value_and_grad(TS.loss_fn, params, batch,
                                                CFG)
        out[policy] = (loss, tree_leaves(grads))
        assert len(calls) == CFG.n_layers      # only under "block"
    assert CFG.remat == "block" and T.remat_policy(CFG) == "block"
    assert torch.equal(out["block"][0], out["none"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["block"][1],
                                                 out["none"][1]))


def test_model_counts_match_jax(jparams):
    model = M.build_model(CFG)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    jmodel = jM.build_model(JCFG)
    assert model.param_count(params) == jmodel.param_count(jparams) \
        == model.active_param_count(params) \
        == jmodel.active_param_count(jparams)


# ---------------------------------------------------------------------------
# Fault-tolerance bookkeeping
# ---------------------------------------------------------------------------

def test_failures_bookkeeping_matches_jax():
    """GuardState, HeartbeatTable, StragglerDetector, elastic_mesh and both
    restart plans give equal outputs on one scripted sequence."""
    def script(m):
        out = []
        gs = m.GuardState(clip_after=2, rollback_after=4)
        out += [gs.observe(b) for b in (False, True, True, True, True)]
        out.append(dataclasses.asdict(
            m.make_guard_restart_plan(gs, [10, 20, 30])))
        gs.rolled_back()
        out += [gs.observe(False), dataclasses.asdict(gs),
                dataclasses.asdict(m.make_guard_restart_plan(gs, []))]
        hb = m.HeartbeatTable(n_workers=4, timeout_s=10.0, t0=100.0)
        for w, t in ((0, 101.0), (1, 104.0), (3, 95.0)):
            hb.beat(w, t=t)
        out += [hb.dead(now=109.0), hb.dead(now=112.0)]
        plan = m.make_restart_plan(hb, [5, 9], model_dim=4, heads=6,
                                   now=112.0)
        out += [dataclasses.asdict(plan),
                m.make_restart_plan(hb, [], 4, 6, now=100.0)]
        sd = m.StragglerDetector(n_workers=3, threshold=1.5, patience=2)
        out += [sd.observe(t) for t in ([1.0, 1.0, 1.0], [1.0, 1.1, 3.0],
                                        [1.0, 1.0, 3.0], [1.0, 1.0, 3.0])]
        out += [m.elastic_mesh(s, md, h) for s, md, h in
                ((8, 4, 32), (6, 4, 6), (3, 8, 12), (1, 2, 2))]
        return out
    assert script(ft) == script(jft)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

SLICE_ARGV = ["--arch", "smollm-360m", "--smoke", "--steps", "12",
              "--batch", "4", "--seq", "32", "--ckpt-every", "6"]


def test_launcher_matches_jax_from_carried_state(jparams, tmp_path):
    """The slice as a whole: 12 steps of the port's launcher (guard on,
    checkpoints every 6 steps) from JAX's init give JAX's losses (1e-4)."""
    want = jlaunch.main(SLICE_ARGV + ["--ckpt-dir", str(tmp_path / "j")])
    hist = []
    got = launch.main(SLICE_ARGV + ["--ckpt-dir", str(tmp_path / "t"),
                                    "--device", "cpu"],
                      params=tree_from_numpy(jparams, "cpu"), history=hist)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert [h["step"] for h in hist] == list(range(12))
    assert not any(h["guard_bad"] for h in hist)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        ["step_00000005", "step_00000011"]


def test_train_launcher_loss_decreases(tmp_path):
    losses_ = launch.main([
        "--arch", "smollm-360m", "--smoke", "--steps", "30",
        "--batch", "4", "--seq", "64", "--lr", "1e-2", "--device", "cpu",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "10"])
    assert losses_[-1] < losses_[0]


def test_train_resume_is_exact(tmp_path):
    """Preempted at step 6 and resumed from its checkpoint, the run repeats
    the uninterrupted run's losses, bit for bit."""
    base = ["--arch", "smollm-360m", "--smoke", "--steps", "12", "--batch",
            "4", "--seq", "32", "--ckpt-every", "6", "--device", "cpu"]
    full = launch.main(base + ["--ckpt-dir", str(tmp_path / "a")])
    first = launch.main(base + ["--stop-after", "6",
                                "--ckpt-dir", str(tmp_path / "b")])
    resumed = launch.main(base + ["--ckpt-dir", str(tmp_path / "b")])
    assert len(first) == len(resumed) == 6
    np.testing.assert_allclose(full, first + resumed, rtol=1e-4, atol=1e-5)
    assert full == first + resumed


def test_resumed_run_with_no_steps_left_trains_nothing(tmp_path):
    """Run again on a finished run's directory, the launcher resumes at its
    end, trains nothing and returns no losses; its checkpoints stay."""
    argv = ["--arch", "smollm-360m", "--smoke", "--steps", "3", "--batch",
            "2", "--seq", "16", "--ckpt-every", "3", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    assert len(launch.main(argv)) == 3
    assert launch.main(argv) == []
    assert launch.main(argv + ["--stop-after", "2"]) == []
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000002"]


def test_launcher_flags(tmp_path):
    """--conv-mesh runs (A13): one process has a (1, 1) mesh, so each of
    Mamba2's depthwise convs records ``mesh:fallback`` and the losses are
    the run's without the flag, bit for bit; --fault-spec, --trace and
    --metrics run (A12): ``grad.values:nan@step1`` drops step 1 and no other, the
    trace passes ``scripts/validate_trace.py`` with a ``train:step`` span a
    step, the metrics hold one ``train_step`` line a step; --conv-mode is
    deprecated and exclusive with --conv-policy; --accum and --autotune
    run."""
    import json
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    try:
        from scripts.validate_trace import validate_trace
    finally:
        sys.path.pop(0)
    from repro_torch import obs
    base = ["--arch", "smollm-360m", "--smoke", "--steps", "2", "--batch",
            "2", "--seq", "16", "--device", "cpu"]
    from repro_torch.core import conv as tconv
    ssm = ["--arch", "mamba2-370m", "--smoke", "--steps", "2", "--batch",
           "2", "--seq", "16", "--device", "cpu", "--conv-policy", "pallas"]
    tconv.reset_dispatch_events()
    meshed = launch.main(ssm + ["--conv-mesh", "tp"])
    ev = {k: v for k, v in tconv.dispatch_events().items()
          if k.startswith("mesh")}
    assert set(ev) == {"mesh:fallback"} and ev["mesh:fallback"] > 0, ev
    assert meshed == launch.main(ssm)
    saved = config.snapshot()
    t, m = tmp_path / "t.json", tmp_path / "m.jsonl"
    hist = []
    # A dispatch counted before the traced run starts: the run's window
    # (bus and legacy counters alike) begins at its start.
    tconv.conv2d(torch.ones(1, 1, 4, 4), torch.ones(1, 1, 3, 3), None, "lax")
    try:
        launch.main(["--arch", "smollm-360m", "--smoke", "--steps", "4",
                     "--batch", "2", "--seq", "16", "--device", "cpu",
                     "--fault-spec", "grad.values:nan@step1",
                     "--trace", str(t), "--metrics", str(m)], history=hist)
        assert config.fault_spec == "grad.values:nan@step1"
        assert config.telemetry and not obs.metrics.active()  # closed
    finally:
        config.update(**saved)
        obs.reset_all()
    assert [h["guard_bad"] for h in hist] == [0, 1, 0, 0]
    problems, stats = validate_trace(json.loads(t.read_text()))
    assert problems == []
    assert stats["b_names"].count("train:step") == 4
    lines = [json.loads(ln) for ln in m.read_text().splitlines()]
    assert [(ln["kind"], ln["step"], ln["guard_bad"]) for ln in lines] == \
        [("train_step", s, float(s == 1)) for s in range(4)]
    with pytest.deprecated_call():
        assert launch.resolve_conv_policy_args(None, "lax") == "lax"
    with pytest.raises(SystemExit):
        launch.resolve_conv_policy_args("lax", "pallas")
    saved = config.snapshot()
    try:
        losses_ = launch.main(base + ["--accum", "2", "--no-guard",
                                      "--autotune", "cached",
                                      "--conv-policy", "lax"])
        assert config.autotune == "cached" and len(losses_) == 2
    finally:
        config.update(**saved)
