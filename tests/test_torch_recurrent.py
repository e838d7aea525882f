"""The port's hybrid family (recurrentgemma-9b: RG-LRU blocks and
local-window attention) against the JAX package on the CPU, at its smoke
config (4 layers: one (rec, rec, attn) super-block and one extra RG-LRU
block; window 32, ``rglru_width`` 64) in float32, with the JAX model's
parameters carried across by ``params_from_numpy``:

* the configs field for field, the registry and ``layer_kind``;
* ``_rglru_scan`` (a doubling scan here, ``lax.associative_scan`` there:
  float32 sums in another order) at lengths 1, 7, 64 and 300, 1e-5, and
  against a step-by-step loop where the decay reaches ``exp(-8.6)`` a step;
* ``recurrent_block`` (with the cache it returns) and
  ``recurrent_decode``, 1e-5;
* ``_sdpa_dense`` and ``_sdpa_blockwise`` under windows of 1, 5 and 32,
  at scalar and per-lane query offsets, and ``_sdpa``'s routing (the
  flash wrapper only where the window spans every query), 1e-5;
* ``forward`` logits under ``lax`` and ``pallas`` (the tap kernels' plain
  versions here), 1e-5;
* the one-pass ``prefill`` against JAX's scan of decode steps at prompt
  lengths 1, 2, 3, 20 and 40 (the last past the window): every cache leaf
  and the last logits, 1e-5; 50 decode steps past the window on lanes at
  different depths, against JAX's logits; ``lane_insert``;
* greedy tokens of both engines against the JAX engines (identical);
* 5 ``make_train_step`` losses and grad norms within 1e-4 of JAX's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core.config import config as jconfig  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models import recurrent as jR  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serve import cache as jC  # noqa: E402
from repro.train import train_step as jTS  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import recurrentgemma_9b as trg  # noqa: E402
from repro_torch.core.config import config  # noqa: E402
from repro_torch.data import pipeline as pipe  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import recurrent as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import cache as C  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.tree import (params_from_numpy,  # noqa: E402
                              tree_from_numpy, tree_leaves)

ARCH = "recurrentgemma-9b"
CFG = configs.get_smoke_config(ARCH)
JCFG = jget_smoke(ARCH)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """torch's intra-op threads set to one for each test, restored after:
    beside other test processes, the smoke config's small ops cost far
    more in waking a pool of threads than in the ops themselves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _toks(seed, shape):
    return np.random.RandomState(seed).randint(0, CFG.vocab, shape)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{"super/rec1/h": leaf, ...} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def jparams():
    return _np(jM.init_params(jax.random.PRNGKey(0), JCFG))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jparams, device="cpu")


def test_config_registry_and_layer_kinds_match_jax(jparams):
    for mine, theirs in ((CFG, JCFG), (configs.get_config(ARCH),
                                       jget_config(ARCH))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
        assert [mine.layer_kind(i) for i in range(mine.n_layers)] == \
            [theirs.layer_kind(i) for i in range(theirs.n_layers)]
        assert mine.supports_long_context and not mine.is_attention_free
    assert configs.get_config("recurrentgemma_9b") is trg.FULL \
        is configs.get_config(ARCH)
    assert configs.get_smoke_config(ARCH) is trg.SMOKE
    assert (CFG.local_window, R.rec_width(CFG)) == (32, 64)
    assert [n for n, _, _ in T._stacks(CFG)] == ["super", "extra"]
    full = [(n, nl) for n, nl, _ in T._stacks(trg.FULL)]
    assert full == [("super", 12), ("extra", 2)]
    # The port's init draws a tree of the JAX package's keys, shapes and
    # dtypes.
    mine = _flat(M.init_params(torch.Generator().manual_seed(0), CFG,
                               "cpu"))
    theirs = _flat(jparams)
    assert sorted(mine) == sorted(theirs)
    for k, v in mine.items():
        assert tuple(v.shape) == theirs[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(theirs[k].dtype), k


def _scan_inputs(length, seed=0, b=2, w=16):
    r = np.random.RandomState(seed)
    return (r.randn(b, length, w).astype(np.float32),
            r.rand(b, length, w).astype(np.float32),
            r.rand(b, length, w).astype(np.float32),
            (r.randn(w) * 0.5 + 0.65).astype(np.float32))


@pytest.mark.parametrize("length", [1, 7, 64, 300])
def test_rglru_scan_matches_jax(length):
    ins = _scan_inputs(length, seed=length)
    got = R._rglru_scan(*map(torch.from_numpy, ins))
    want = jR._rglru_scan(*map(jnp.asarray, ins))
    _close(got, want)


def test_rglru_scan_holds_where_the_decay_underflows():
    """r = 1 and a large ``lam``: ``a`` down to exp(-8 softplus(lam)) a
    step, where a closed form through exp(-cumsum) overflows; the scan
    equals the step-by-step recurrence and stays finite."""
    x, _, i, _ = _scan_inputs(200, seed=9)
    r = np.ones_like(x)
    lam = np.full(x.shape[-1], 1.0, np.float32)
    got = R._rglru_scan(*map(torch.from_numpy, (x, r, i, lam)))
    a = np.exp(-R.RG_C * np.log1p(np.exp(lam)))[None] * np.ones_like(x[:, 0])
    h = np.zeros_like(x[:, 0])
    want = []
    for t in range(x.shape[1]):
        h = a * h + np.sqrt(np.maximum(1 - a * a, 1e-12)) * (i[:, t]
                                                             * x[:, t])
        want.append(h)
    assert bool(torch.isfinite(got).all())
    _close(got, np.stack(want, axis=1))


@pytest.mark.parametrize("plen", [2, 9])
def test_recurrent_block_and_decode_match_jax(jparams, params, plen):
    """The block's output against JAX's; the cache it returns (final
    ``h`` and the last 3 pre-conv inputs, zero-padded for 2 tokens)
    against the state a scan of JAX's decode steps leaves; one decode step
    from a random state against JAX's."""
    r = np.random.RandomState(plen)
    x = r.randn(2, plen, CFG.d_model).astype(np.float32)
    p = _layer(params["super"]["rec2"]["rec"], 0)
    jp = _layer(jparams["super"]["rec2"]["rec"], 0)
    out, h, conv = R.recurrent_block(p, torch.from_numpy(x), CFG,
                                     return_cache=True)
    _close(out, jR.recurrent_block(jp, jnp.asarray(x), JCFG))
    state = jR.recurrent_init_state(JCFG, 2, 1)
    jh, jconv = state["h"][0], state["conv"][0]
    for t in range(plen):
        _, jh, jconv = jR.recurrent_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                           jh, jconv, JCFG)
    assert (h.dtype, conv.dtype) == (torch.float32, CFG.adtype)
    assert tuple(h.shape) == jh.shape and tuple(conv.shape) == jconv.shape
    _close(h, jh)
    _close(conv, jconv)
    hs = r.randn(2, R.rec_width(CFG)).astype(np.float32)
    cs = r.randn(2, CFG.rglru_conv - 1, R.rec_width(CFG)).astype(np.float32)
    got = R.recurrent_decode(p, torch.from_numpy(x[:, :1]),
                             torch.from_numpy(hs), torch.from_numpy(cs), CFG)
    want = jR.recurrent_decode(jp, jnp.asarray(x[:, :1]), jnp.asarray(hs),
                               jnp.asarray(cs), JCFG)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def _attn_inputs(lq, lk, seed, b=2, h=4, hk=2, d=8):
    r = np.random.RandomState(seed)
    return (r.randn(b, lq, h, d).astype(np.float32),
            r.randn(b, lk, hk, d).astype(np.float32),
            r.randn(b, lk, hk, d).astype(np.float32))


WINDOWS = [1, 5, 32]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("offsets", ["scalar", "per-lane"])
def test_sdpa_dense_window_matches_jax(window, offsets):
    """Decode-like queries (one row, or 3 rows behind a prefix) against a
    40-key cache: the window mask at scalar or per-lane offsets."""
    lq = 1 if offsets == "per-lane" else 3
    q, k, v = _attn_inputs(lq, 40, seed=window)
    if offsets == "per-lane":
        off, kv_len = np.array([17, 39]), np.array([18, 40])
        toff, tkv = torch.from_numpy(off), torch.from_numpy(kv_len)
    else:
        off, kv_len = 30, 33
        toff, tkv = off, kv_len
    got = A._sdpa_dense(*map(torch.from_numpy, (q, k, v)), causal=True,
                        window=window, q_offset=toff, kv_len=tkv, scale=0.3)
    want = jA._sdpa_dense(*map(jnp.asarray, (q, k, v)), causal=True,
                          window=window, q_offset=jnp.asarray(off),
                          kv_len=jnp.asarray(kv_len), scale=0.3)
    _close(got, want)


@pytest.mark.parametrize("window", WINDOWS)
def test_sdpa_blockwise_window_matches_jax(window, monkeypatch):
    """The online softmax over key blocks (blocks of 16 in both packages,
    so a window crosses block edges) with a scalar offset."""
    monkeypatch.setattr(A, "BLOCK_K", 16)
    monkeypatch.setattr(jA, "BLOCK_K", 16)
    q, k, v = _attn_inputs(40, 70, seed=10 + window)
    got = A._sdpa_blockwise(*map(torch.from_numpy, (q, k, v)), causal=True,
                            window=window, q_offset=30, kv_len=None,
                            scale=0.3)
    want = jA._sdpa_blockwise(*map(jnp.asarray, (q, k, v)), causal=True,
                              window=window, q_offset=30, kv_len=None,
                              scale=0.3)
    _close(got, want)


@pytest.mark.parametrize("window", WINDOWS)
def test_sdpa_windowed_prefill_takes_the_blockwise_path_like_jax(
        window, monkeypatch):
    """A causal self-attention call past a lowered key threshold runs the
    blockwise path in both packages; the port sends it to flash only when
    the window spans every query (never here: 48 queries)."""
    calls = []
    monkeypatch.setattr(A, "flash_attention",
                        lambda *a, **kw: calls.append(1))
    q, k, v = _attn_inputs(48, 48, seed=20 + window)
    with config.override(blockwise_kv_threshold=16), \
            jconfig.override(blockwise_kv_threshold=16), torch.no_grad():
        got = A._sdpa(*map(torch.from_numpy, (q, k, v)), causal=True,
                      window=window)
        want = jA._sdpa(*map(jnp.asarray, (q, k, v)), causal=True,
                        window=window)
    assert not calls
    _close(got, want)


@pytest.mark.parametrize("lq", [32, 33])
def test_sdpa_sends_a_window_to_flash_only_where_it_masks_nothing(lq):
    """Under no grad, a causal self-attention call with window 32 runs the
    flash wrapper (its plain version on the CPU) at 32 queries and the
    masked plain attention at 33; both agree with JAX's masked dense."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _attn_inputs(lq, lq, seed=lq)
    FA.LAUNCHES["flash_attention"] = 0
    seen = []
    real = A.flash_attention

    def spy(*a, **kw):
        seen.append(1)
        return real(*a, **kw)
    A.flash_attention = spy
    try:
        with torch.no_grad():
            got = A._sdpa(*map(torch.from_numpy, (q, k, v)), causal=True,
                          window=32)
    finally:
        A.flash_attention = real
    assert len(seen) == (1 if lq <= 32 else 0)
    want = jA._sdpa(*map(jnp.asarray, (q, k, v)), causal=True, window=32)
    _close(got, want)


@pytest.mark.parametrize("policy", ["lax", "pallas"])
def test_forward_logits_match_jax(jparams, params, policy):
    toks = _toks(3, (2, 45))
    got, aux = M.forward(params, {"tokens": torch.from_numpy(toks)},
                         dataclasses.replace(CFG, conv_policy=policy))
    want, jaux = jM.forward(jparams, {"tokens": jnp.asarray(toks,
                                                            jnp.int32)},
                            dataclasses.replace(JCFG, conv_policy=policy))
    assert got.shape == (2, 45, CFG.vocab) and aux == jaux == {}
    _close(got, want)
    assert M.count_params(params) == jM.count_params(jparams)


def test_a_super_block_is_one_checkpoint_when_a_gradient_flows(
        params, monkeypatch):
    """Under a gradient, the (rec, rec, attn) super-block is rematerialized
    whole, as the JAX package's ``_maybe_remat(super_block)``, and each
    extra RG-LRU block on its own: two checkpoints at the smoke depth."""
    calls = []
    real = T.checkpoint

    def spy(fn, block, *a, **kw):
        calls.append(block.__name__)
        return real(fn, block, *a, **kw)
    monkeypatch.setattr(T, "checkpoint", spy)
    p = dict(params)
    p["embed"] = {"w": params["embed"]["w"].clone().requires_grad_(True)}
    logits, _ = M.forward(p, {"tokens": torch.from_numpy(_toks(4, (1, 9)))},
                          CFG)
    logits.sum().backward()
    assert calls == ["super_block", "rec_block"]
    assert p["embed"]["w"].grad is not None


@pytest.mark.parametrize("plen", [1, 2, 3, 20, 40])
def test_prefill_matches_jax_scan(jparams, params, plen):
    """The one-pass prefill (40: past the window of 32) against JAX's scan
    of decode steps: every cache leaf and the last logits, then the decode
    step after it."""
    toks = _toks(7 + plen, (2, plen))
    logits, cache = M.prefill(params, torch.from_numpy(toks), CFG, plen + 4)
    want, jcache = jM.prefill(jparams, jnp.asarray(toks, jnp.int32), JCFG,
                              plen + 4)
    _close(logits, want)
    mine, theirs = _flat(cache), _flat(_np(jcache))
    assert sorted(mine) == sorted(theirs) == [
        "extra/conv", "extra/h", "super/attn/k", "super/attn/v",
        "super/rec1/conv", "super/rec1/h", "super/rec2/conv",
        "super/rec2/h"]
    for key, leaf in mine.items():
        assert tuple(leaf.shape) == theirs[key].shape, key
        assert str(leaf.dtype).split(".")[-1] == str(theirs[key].dtype), key
        _close(leaf, theirs[key])
    nxt = toks[:, -1]
    got, _ = M.decode_step(params, cache, torch.from_numpy(nxt), plen, CFG)
    wnt, _ = jM.decode_step(jparams, jcache, jnp.asarray(nxt, jnp.int32),
                            jnp.int32(plen), JCFG)
    _close(got, wnt)


def test_fifty_decode_steps_past_the_window_match_jax(jparams, params):
    """Two lanes prefilled to depths 10 and 25 (batch-1 prefills inserted
    into a slotted cache, as the continuous engine does), then 50 decode
    steps with per-lane positions up to 74, well past the window of 32:
    every step's logits against JAX's."""
    max_len = 80
    cache = T.init_cache(CFG, 2, max_len, "cpu")
    jcache = jM.build_model(JCFG).init_cache(2, max_len)
    nxt, pos = [], []
    for lane, plen in enumerate((10, 25)):
        toks = _toks(30 + lane, (1, plen))
        lg, src = M.prefill(params, torch.from_numpy(toks), CFG, max_len)
        jlg, jsrc = jM.prefill(jparams, jnp.asarray(toks, jnp.int32), JCFG,
                               max_len)
        _close(lg, jlg)
        C.lane_insert(cache, src, lane)
        jcache = jC.lane_insert(jcache, jsrc, jnp.int32(lane))
        nxt.append(int(np.argmax(np.asarray(jlg)[0])))
        pos.append(plen)
    steps = _toks(40, (50, 2))
    for t in range(50):
        tok = np.array(nxt) if t == 0 else steps[t]
        p = np.array(pos) + t
        got, cache = M.decode_step(params, cache, torch.from_numpy(tok),
                                   torch.from_numpy(p), CFG)
        want, jcache = jM.decode_step(jparams, jcache,
                                      jnp.asarray(tok, jnp.int32),
                                      jnp.asarray(p, jnp.int32), JCFG)
        assert bool(torch.isfinite(got).all())
        _close(got, want)


def test_lane_insert_of_a_hybrid_cache_matches_jax():
    r = np.random.RandomState(0)
    shapes = _np(jM.build_model(JCFG).init_cache(3, 16))
    cache = jax.tree.map(lambda a: r.randn(*a.shape).astype(np.float32),
                         shapes)
    src = jax.tree.map(lambda a: r.randn(a.shape[0], 1, *a.shape[2:])
                       .astype(np.float32), shapes)
    tcache = T.init_cache(CFG, 3, 16, "cpu")
    assert {k: tuple(v.shape) for k, v in _flat(tcache).items()} == \
        {k: v.shape for k, v in _flat(shapes).items()}
    got = C.lane_insert(jax.tree.map(torch.tensor, cache),
                        jax.tree.map(torch.tensor, src), 1)
    want = jC.lane_insert(jax.tree.map(jnp.asarray, cache),
                          jax.tree.map(jnp.asarray, src), jnp.int32(1))
    for key, leaf in _flat(got).items():
        np.testing.assert_array_equal(leaf.numpy(),
                                      np.asarray(_flat(want)[key]))


ARGV = ["--arch", ARCH, "--requests", "5", "--max-new", "6",
        "--prompt-len", "30", "--max-batch", "2"]


@pytest.mark.parametrize("policy", ["auto", "pallas"])
@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_greedy_tokens_match_the_jax_engines(engine, policy, jparams,
                                             monkeypatch):
    """Both engines through the launcher give JAX's greedy tokens: 30-token
    prompts and 6 new tokens run the decode steps past the window of 32."""
    want = jserve.main(ARGV + ["--engine", engine])
    monkeypatch.setattr(tserve, "init_params", lambda cfg, seed, dev:
                        params_from_numpy(jparams, dev))
    res = tserve.main(ARGV + ["--engine", engine, "--device", "cpu",
                              "--conv-policy", policy])
    got = res["requests"]
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert g.status == w.status == "ok"
        assert g.out == w.out, (g.rid, g.out, w.out)
    assert res["summary"]["completed"] == 5


@pytest.mark.parametrize("policy", ["lax", "pallas"])
def test_five_train_step_losses_match_jax(jparams, policy):
    """5 guarded steps from JAX's init under one conv policy, on 48-token
    sequences (past the window): losses and grad norms within 1e-4 of
    JAX's step.  At a peak lr of 1e-3: at 5e-3 AdamW's normalised update
    turns float32 order differences in near-zero gradient elements into
    steps of the lr, and the two packages' losses part by 1.5e-4 after
    three updates (1e-6 at 1e-3)."""
    opt_cfg = dict(peak_lr=1e-3)
    kw = dict(total_steps=5, warmup=1, guard=True, conv_policy=policy)
    jstep = jax.jit(jTS.make_train_step(JCFG, jadamw.AdamWConfig(**opt_cfg),
                                        **kw))
    tstep = TS.make_train_step(CFG, adamw.AdamWConfig(**opt_cfg), **kw)
    jp = jax.tree.map(jnp.asarray, jparams)
    jo = jadamw.init_state(jp)
    tp = tree_from_numpy(jparams, "cpu")
    to = tree_from_numpy(_np(jo), "cpu")
    dcfg = pipe.DataConfig(seed=3, seq_len=48, global_batch=2,
                           vocab=CFG.vocab)
    for s in range(5):
        b = pipe.make_batch(CFG, dcfg, s)
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b),
                           jnp.int32(s))
        tp, to, tm = tstep(tp, to, tree_from_numpy(b, "cpu"), s)
        for k in ("loss", "grad_norm", "guard_bad"):
            _close(tm[k], jm[k], 1e-4)
    for g, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        _close(g, w, 1e-4)
