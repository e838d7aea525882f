"""The port's MoE family against the JAX package on the CPU, at
moonshot-v1-16b-a3b's smoke config in float32 (8 experts, top-2, one
shared expert, a dense first layer, an untied head) with the JAX model's
parameters carried across by ``params_from_numpy``:

* ``moe_apply`` at its default capacity (which drops tokens) and at a
  capacity that drops none: output and both aux terms (1e-5);
* ``_group`` over a range of token counts (equal);
* ``forward`` logits and aux (1e-4);
* ``decode_step`` with scalar and per-lane positions (1e-5);
* ``prefill`` -- one causal pass at a capacity that drops nothing in the
  port, a scan of decode steps in JAX -- logits and every layer's cache
  (1e-5), on a prompt where the default capacity drops tokens;
* greedy tokens through both port engines against the JAX engines
  (identical); parameter counts, total and active (equal);
* ``train_step.loss_fn`` (1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models import moe as jMOE  # noqa: E402
from repro.train import train_step as jTS  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.tree import params_from_numpy  # noqa: E402

ARCH = "moonshot-v1-16b-a3b"
CFG = get_smoke_config(ARCH)
JCFG = jget_smoke(ARCH)


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


def test_config_structure():
    assert CFG.family == "moe" and not CFG.tie_embeddings
    assert (CFG.n_experts, CFG.moe_top_k, CFG.n_shared_experts,
            CFG.first_dense_layers) == (8, 2, 1, 1)
    assert [CFG.is_moe_layer(i) for i in range(CFG.n_layers)] \
        == [JCFG.is_moe_layer(i) for i in range(JCFG.n_layers)] \
        == [False, True, True, True]


@pytest.mark.parametrize("capacity", [None, 1024],
                         ids=["default_drops", "no_drop"])
def test_moe_apply_matches_jax(jparams, params, capacity):
    # A direction every token shares skews the router, so that the
    # default capacity binds.
    r = np.random.RandomState(1)
    x = (r.randn(2, 512, CFG.d_model)
         + 2.0 * r.randn(CFG.d_model)).astype(np.float32)
    p = _layer(params["blocks_moe"]["moe"], 1)
    jp = _layer(jparams["blocks_moe"]["moe"], 1)
    got, aux = MOE.moe_apply(p, torch.from_numpy(x), CFG, capacity)
    want, jaux = jMOE.moe_apply(jp, jnp.asarray(x), JCFG, capacity)
    _close(got, want, 1e-5)
    assert sorted(aux) == sorted(jaux) == ["moe_lb", "moe_z"]
    for key in aux:
        _close(aux[key], jaux[key], 1e-5)
    if capacity is None:
        # The default capacity binds here: some tokens lose an expert.
        full, _ = jMOE.moe_apply(jp, jnp.asarray(x), JCFG, 1024)
        assert np.abs(np.asarray(full) - np.asarray(want)).max() > 1e-2


def test_group_matches_jax():
    for t in [*range(1, 1100), 1536, 2048, 4096, 4100, 10007, 32768]:
        assert MOE._group(t) == jMOE._group(t), t


def test_forward_logits_and_aux_match_jax(jparams, params):
    toks = _toks(3, (2, 33))
    got, aux = M.forward(params, {"tokens": torch.from_numpy(toks)}, CFG)
    want, jaux = jM.forward(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                            JCFG)
    assert got.shape == (2, 33, CFG.vocab)
    _close(got, want, 1e-4)
    assert sorted(aux) == sorted(jaux) == ["moe_lb", "moe_z"]
    for key in aux:
        _close(aux[key], jaux[key], 1e-5)


@pytest.mark.parametrize("per_lane", [False, True], ids=["scalar", "lanes"])
def test_decode_step_matches_jax(jparams, params, per_lane):
    toks = _toks(5, (3, 9))
    _, cache = M.prefill(params, torch.from_numpy(toks), CFG, 16)
    _, jcache = jM.prefill(jparams, jnp.asarray(toks, jnp.int32), JCFG, 16)
    nxt = np.array([7, 200, 31])
    pos = np.array([9, 4, 12]) if per_lane else 9
    got, cache = M.decode_step(
        params, cache, torch.from_numpy(nxt),
        torch.from_numpy(pos) if per_lane else pos, CFG)
    want, jcache = jM.decode_step(jparams, jcache, jnp.asarray(nxt, jnp.int32),
                                  jnp.asarray(pos, jnp.int32), JCFG)
    _close(got, want, 1e-5)
    for name in cache:
        for key in ("k", "v"):
            _close(cache[name][key], jcache[name][key], 1e-5)


def test_prefill_drops_no_token_and_matches_jax_scan(jparams, params,
                                                     monkeypatch):
    """400-token prompts: at the default capacity (800 tokens in one group,
    250 slots an expert) the forward pass drops tokens and its last logits
    move; the prefill passes a capacity that drops none and gives the JAX
    scan's logits and cache."""
    toks = _toks(4, (2, 400))
    seen = []
    apply = MOE.moe_apply
    monkeypatch.setattr(MOE, "moe_apply", lambda p, x, cfg, capacity=None:
                        seen.append(capacity) or apply(p, x, cfg, capacity))
    logits, cache = M.prefill(params, torch.from_numpy(toks), CFG, 410)
    assert seen == [800] * (CFG.n_layers - CFG.first_dense_layers)
    want_logits, want_cache = jM.prefill(
        jparams, jnp.asarray(toks, jnp.int32), JCFG, 410)
    _close(logits, want_logits, 1e-5)
    assert sorted(cache) == sorted(want_cache) == ["blocks_dense",
                                                   "blocks_moe"]
    for name in cache:
        for key in ("k", "v"):
            got = cache[name][key]
            assert got.shape == want_cache[name][key].shape
            _close(got, want_cache[name][key], 1e-5)
            assert not got[:, :, 400:].any()     # the tail stays zero
    dropped, _ = M.forward(params, {"tokens": torch.from_numpy(toks)}, CFG)
    assert (dropped[:, -1] - logits).abs().max() > 1e-2


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_greedy_tokens_match_the_jax_engines(engine, jparams, monkeypatch):
    argv = ["--arch", ARCH, "--requests", "5", "--max-new", "6",
            "--prompt-len", "7", "--max-batch", "2", "--engine", engine]
    want = jserve.main(argv)
    monkeypatch.setattr(tserve, "init_params", lambda cfg, seed, dev:
                        params_from_numpy(jparams, dev))
    got = tserve.main(argv + ["--device", "cpu"])["requests"]
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert g.status == w.status == "ok"
        assert g.out == w.out, (g.rid, g.out, w.out)


def test_param_counts_match_jax(jparams):
    model = M.build_model(CFG)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    jmodel = jM.build_model(JCFG)
    assert model.param_count(params) == jmodel.param_count(jparams)
    active = model.active_param_count(params)
    assert active == jmodel.active_param_count(jparams) \
        < model.param_count(params)
    assert params["blocks_moe"]["moe"]["router"]["w"].dtype == torch.float32
    assert T.cache_keys(CFG) == ("k", "v")


def test_loss_fn_matches_jax(jparams, params):
    r = np.random.RandomState(6)
    toks = r.randint(0, CFG.vocab, (2, 24))
    batch = {"tokens": toks, "targets": r.randint(0, CFG.vocab, (2, 24))}
    loss, metrics = TS.loss_fn(params, {k: torch.from_numpy(v)
                                        for k, v in batch.items()}, CFG)
    jloss, jmetrics = jTS.loss_fn(jparams, {k: jnp.asarray(v, jnp.int32)
                                            for k, v in batch.items()}, JCFG)
    _close(loss, jloss, 1e-5)
    assert sorted(metrics) == sorted(jmetrics) == ["ce", "loss", "moe_lb"]
    for key in metrics:
        _close(metrics[key], jmetrics[key], 1e-5)
