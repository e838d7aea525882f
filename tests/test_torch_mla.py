"""The port's MLA path (DeepSeek-V3) against the JAX package on the CPU, at
deepseek-v3-671b's smoke config in float32 (MLA with q/kv ranks 32, nope
16, rope 8, v 16; MoE with a dense first layer; multi-token prediction;
an untied head) with the JAX model's parameters carried across by
``params_from_numpy``:

* ``mla_train`` (1e-5), and ``mla_decode`` -- the absorbed-weight decode
  -- with scalar and per-lane positions (1e-5);
* ``forward`` logits and aux, ``mtp_logits`` included (1e-4);
* ``prefill`` -- one causal pass through the flash wrapper's plain version
  at head dim 24 in the port, JAX's scan of absorbed decode steps -- logits
  and every layer's ``c_kv`` and ``k_rope`` (1e-5);
* greedy tokens through both port engines against the JAX engines
  (identical);
* the loss with its ``mtp_ce`` and ``moe_lb`` terms (1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.train import train_step as jTS  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.tree import params_from_numpy  # noqa: E402

ARCH = "deepseek-v3-671b"
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
    assert CFG.use_mla and CFG.mtp_depth == 1 and not CFG.tie_embeddings
    assert CFG.qk_nope_head_dim + CFG.qk_rope_head_dim == CFG.head_dim == 24
    assert T.cache_keys(CFG) == ("c_kv", "k_rope")


def test_mla_train_matches_jax(jparams, params):
    x = np.random.RandomState(1).randn(2, 37, CFG.d_model).astype(np.float32)
    got = A.mla_train(_layer(params["blocks_moe"]["attn"], 0),
                      torch.from_numpy(x), CFG)
    want = jA.mla_train(_layer(jparams["blocks_moe"]["attn"], 0),
                        jnp.asarray(x), JCFG)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("per_lane", [False, True], ids=["scalar", "lanes"])
def test_mla_decode_matches_jax(jparams, params, per_lane):
    r = np.random.RandomState(2)
    b, lmax = 3, 24
    x = r.randn(b, 1, CFG.d_model).astype(np.float32)
    ckv = r.randn(b, lmax, CFG.kv_lora_rank).astype(np.float32)
    kr = r.randn(b, lmax, CFG.qk_rope_head_dim).astype(np.float32)
    pos = np.array([5, 0, 17]) if per_lane else 9
    got = A.mla_decode(_layer(params["blocks_dense"]["attn"], 0),
                       torch.from_numpy(x), torch.from_numpy(ckv),
                       torch.from_numpy(kr),
                       torch.from_numpy(pos) if per_lane else pos, CFG)
    want = jA.mla_decode(_layer(jparams["blocks_dense"]["attn"], 0),
                         jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(kr),
                         jnp.asarray(pos, jnp.int32), JCFG)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_forward_with_mtp_matches_jax(jparams, params):
    toks = _toks(3, (2, 33))
    got, aux = M.forward(params, {"tokens": torch.from_numpy(toks)}, CFG)
    want, jaux = jM.forward(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                            JCFG)
    _close(got, want, 1e-4)
    assert sorted(aux) == sorted(jaux) == ["moe_lb", "moe_z", "mtp_logits"]
    assert aux["mtp_logits"].shape == (2, 33, CFG.vocab)
    _close(aux["mtp_logits"], jaux["mtp_logits"], 1e-4)
    for key in ("moe_lb", "moe_z"):
        _close(aux[key], jaux[key], 1e-5)


def test_prefill_matches_jax_absorbed_scan(jparams, params, monkeypatch):
    toks = _toks(4, (2, 45))
    calls = []
    spy = A.flash_attention
    monkeypatch.setattr(A, "flash_attention",
                        lambda q, *a, **k: calls.append(q.shape[-1])
                        or spy(q, *a, **k))
    logits, cache = M.prefill(params, torch.from_numpy(toks), CFG, 50)
    assert calls == [CFG.head_dim] * CFG.n_layers    # one call a layer
    want_logits, want_cache = jM.prefill(
        jparams, jnp.asarray(toks, jnp.int32), JCFG, 50)
    _close(logits, want_logits, 1e-5)
    for name in ("blocks_dense", "blocks_moe"):
        assert sorted(cache[name]) == sorted(want_cache[name]) \
            == ["c_kv", "k_rope"]
        for key in ("c_kv", "k_rope"):
            got = cache[name][key]
            assert got.shape == want_cache[name][key].shape
            _close(got, want_cache[name][key], 1e-5)
            assert not got[:, :, 45:].any()      # the tail stays zero


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


def test_loss_with_mtp_matches_jax(jparams, params):
    r = np.random.RandomState(6)
    toks = r.randint(0, CFG.vocab, (2, 24))
    batch = {"tokens": toks, "targets": r.randint(0, CFG.vocab, (2, 24))}
    loss, metrics = TS.loss_fn(params, {k: torch.from_numpy(v)
                                        for k, v in batch.items()}, CFG)
    jloss, jmetrics = jTS.loss_fn(jparams, {k: jnp.asarray(v, jnp.int32)
                                            for k, v in batch.items()}, JCFG)
    _close(loss, jloss, 1e-5)
    assert sorted(metrics) == sorted(jmetrics) \
        == ["ce", "loss", "moe_lb", "mtp_ce"]
    for key in metrics:
        _close(metrics[key], jmetrics[key], 1e-5)
