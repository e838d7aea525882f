"""The port's LM path against the JAX package on the CPU, at SmolLM-360M's
smoke config in float32 with the JAX model's parameters carried across by
``params_from_numpy``: rmsnorm, RoPE and the SwiGLU MLP (1e-6),
``gqa_train`` (1e-5), ``gqa_decode`` with scalar and per-lane positions
(1e-5), ``forward`` logits (1e-4), and ``prefill`` -- one causal pass in
the port, a scan of decode steps in JAX -- logits and every layer's cache
(1e-5).  On the CPU the flash-attention wrapper runs its plain version;
the routing of ``_sdpa`` to it is checked here, the kernel on the card."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import deepseek_v3_671b as jdeepseek  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.configs import mamba2_370m as jmamba2  # noqa: E402
from repro.configs import moonshot_v1_16b_a3b as jmoonshot  # noqa: E402
from repro.configs import recurrentgemma_9b as jrg  # noqa: E402
from repro.configs import smollm_360m as jsmol  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import model as jM  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import deepseek_v3_671b as tdeepseek  # noqa: E402
from repro_torch.configs import mamba2_370m as tmamba2  # noqa: E402
from repro_torch.configs import moonshot_v1_16b_a3b as tmoonshot  # noqa: E402,E501
from repro_torch.configs import smollm_360m as tsmol  # noqa: E402
from repro_torch.configs import recurrentgemma_9b as trg  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.tree import params_from_numpy  # noqa: E402

CFG = configs.get_smoke_config("smollm-360m")
JCFG = jget_smoke("smollm-360m")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jM.init_params(jax.random.PRNGKey(0),
                                                   JCFG))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jparams, device="cpu")


#: (port module, JAX module, FULL or SMOKE); SmolLM's ids stay the bare
#: config name.
CONFIGS = [pytest.param(mine, theirs, conf,
                        id=conf if mine is tsmol else f"{name}-{conf}")
           for name, mine, theirs in (("smollm", tsmol, jsmol),
                                      ("moonshot", tmoonshot, jmoonshot),
                                      ("deepseek", tdeepseek, jdeepseek),
                                      ("mamba2", tmamba2, jmamba2),
                                      ("recurrentgemma", trg, jrg))
           for conf in ("FULL", "SMOKE")]


@pytest.mark.parametrize("mine,theirs,conf", CONFIGS)
def test_configs_match_the_jax_package(mine, theirs, conf):
    mine, theirs = getattr(mine, conf), getattr(theirs, conf)
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert str(mine.dtype).split(".")[-1] == str(theirs.dtype)
    assert str(mine.adtype).split(".")[-1] == str(theirs.adtype)
    assert [mine.is_moe_layer(i) for i in range(mine.n_layers)] \
        == [theirs.is_moe_layer(i) for i in range(theirs.n_layers)]


def test_only_smollm_is_registered():
    """The registry holds the dense SmolLM-360M, the MoE family, the SSM
    family (Mamba2) and the hybrid family (recurrentgemma-9b), by module
    name and dashed alias; a config still unported (granite-3-8b) raises,
    in the registry, and so does a family still unported (vlm) in the
    model; a windowed ``_sdpa`` call runs."""
    assert configs.get_config("smollm_360m") is tsmol.FULL
    for mod in (tmoonshot, tdeepseek, tmamba2, trg):
        name = mod.__name__.rsplit(".", 1)[1]
        assert configs.get_config(name) is mod.FULL \
            is configs.get_config(name.replace("_", "-"))
        assert configs.get_smoke_config(mod.FULL.name) is mod.SMOKE
    for name in ("granite_3_8b", "granite-3-8b"):
        with pytest.raises(NotImplementedError, match="A10"):
            configs.get_config(name)
    assert sorted(M.init_params(torch.Generator(), tmamba2.SMOKE, "cpu")
                  ["blocks"]) == ["ln", "ssm"]
    assert sorted(M.init_params(torch.Generator(), trg.SMOKE, "cpu")) == [
        "embed", "extra", "final_norm", "lm_head", "super"]
    with pytest.raises(NotImplementedError, match="A10"):
        M.init_params(torch.Generator(), dataclasses.replace(
            CFG, family="vlm"), "cpu")
    q = torch.randn(1, 4, 2, 8, generator=torch.Generator().manual_seed(0))
    out = A._sdpa(q, q, q, causal=True, window=2)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())


def test_rmsnorm_rope_and_mlp_match_jax(jparams, params):
    r = np.random.RandomState(0)
    x = r.randn(2, 5, CFG.d_model).astype(np.float32)
    p = {"scale": r.rand(CFG.d_model).astype(np.float32) + 0.5}
    _close(L.rmsnorm({"scale": _t(p["scale"])}, _t(x), 1e-6),
           jL.rmsnorm(p, jnp.asarray(x), 1e-6), 1e-6)
    pos = np.array([0, 3, 7, 100, 2047])
    ang = L.rope_freqs(16, 10000.0, torch.from_numpy(pos))
    jang = jL.rope_freqs(16, 10000.0, jnp.asarray(pos))
    _close(ang, jang, 1e-6)
    xr = r.randn(2, 5, 3, 16).astype(np.float32)
    _close(L.apply_rope(_t(xr), ang), jL.apply_rope(jnp.asarray(xr), jang),
           1e-5)
    mp = jax.tree.map(lambda a: a[1], jparams["blocks"]["mlp"])
    tp = {k: {"w": params["blocks"]["mlp"][k]["w"][1]} for k in mp}
    _close(L.mlp(tp, _t(x)), jL.mlp(mp, jnp.asarray(x)), 1e-5)


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def test_gqa_train_matches_jax(jparams, params):
    x = np.random.RandomState(1).randn(2, 37, CFG.d_model).astype(np.float32)
    got = A.gqa_train(_layer(params["blocks"]["attn"], 0), _t(x), CFG)
    want = jA.gqa_train(_layer(jparams["blocks"]["attn"], 0), jnp.asarray(x),
                        JCFG)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("per_lane", [False, True], ids=["scalar", "lanes"])
def test_gqa_decode_matches_jax(jparams, params, per_lane):
    r = np.random.RandomState(2)
    b, lmax, hk, dh = 3, 24, CFG.n_kv_heads, CFG.head_dim
    x = r.randn(b, 1, CFG.d_model).astype(np.float32)
    ck = r.randn(b, lmax, hk, dh).astype(np.float32)
    cv = r.randn(b, lmax, hk, dh).astype(np.float32)
    pos = np.array([5, 0, 17]) if per_lane else 9
    got = A.gqa_decode(_layer(params["blocks"]["attn"], 2), _t(x), _t(ck),
                       _t(cv), torch.from_numpy(pos) if per_lane else pos,
                       CFG)
    want = jA.gqa_decode(_layer(jparams["blocks"]["attn"], 2),
                         jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                         jnp.asarray(pos, jnp.int32), JCFG)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_forward_logits_match_jax(jparams, params):
    toks = np.random.RandomState(3).randint(0, CFG.vocab, (2, 33))
    got, aux = M.forward(params, {"tokens": torch.from_numpy(toks)}, CFG)
    want, _ = jM.forward(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                         JCFG)
    assert aux == {} and got.shape == (2, 33, CFG.vocab)
    _close(got, want, 1e-4)


def test_prefill_one_causal_pass_matches_jax_scan(jparams, params,
                                                  monkeypatch):
    toks = np.random.RandomState(4).randint(0, CFG.vocab, (2, 21))
    calls = []
    spy = A.flash_attention
    monkeypatch.setattr(A, "flash_attention",
                        lambda *a, **k: calls.append(1) or spy(*a, **k))
    logits, cache = M.prefill(params, torch.from_numpy(toks), CFG, 30)
    assert len(calls) == CFG.n_layers       # one attention call per layer
    want_logits, want_cache = jM.prefill(jparams, jnp.asarray(toks,
                                                              jnp.int32),
                                         JCFG, 30)
    _close(logits, want_logits, 1e-5)
    for key in ("k", "v"):
        got = cache["blocks"][key]
        assert got.shape == (CFG.n_layers, 2, 30, CFG.n_kv_heads,
                             CFG.head_dim)
        _close(got, want_cache["blocks"][key], 1e-5)
        assert not got[:, :, 21:].any()     # the tail stays zero


def test_decode_step_after_prefill_matches_jax(jparams, params, monkeypatch):
    """A decode step with per-lane positions on a prefilled cache routes no
    call to the flash wrapper and gives JAX's logits."""
    toks = np.random.RandomState(5).randint(0, CFG.vocab, (2, 9))
    _, cache = M.prefill(params, torch.from_numpy(toks), CFG, 16)
    _, jcache = jM.prefill(jparams, jnp.asarray(toks, jnp.int32), JCFG, 16)
    monkeypatch.setattr(A, "flash_attention", None)   # must not be called
    nxt = np.array([7, 200])
    pos = np.array([9, 9])
    got, cache = M.decode_step(params, cache, torch.from_numpy(nxt),
                               torch.from_numpy(pos), CFG)
    want, jcache = jM.decode_step(jparams, jcache, jnp.asarray(nxt, jnp.int32),
                                  jnp.asarray(pos, jnp.int32), JCFG)
    _close(got, want, 1e-4)
    _close(cache["blocks"]["k"], jcache["blocks"]["k"], 1e-5)
