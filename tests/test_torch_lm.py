"""The port's LM path against the JAX package on the CPU, at SmolLM-360M's
smoke config in float32 with the JAX model's parameters carried across by
``params_from_numpy``: rmsnorm, RoPE and the SwiGLU MLP (1e-6),
``gqa_train`` (1e-5), ``gqa_decode`` with scalar and per-lane positions
(1e-5), ``forward`` logits (1e-4), and ``prefill`` -- one causal pass in
the port, a scan of decode steps in JAX -- logits and every layer's cache
(1e-5).  On the CPU the flash-attention wrapper runs its plain version;
the routing of ``_sdpa`` to it is checked here, the kernel on the card."""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ALIASES as JALIASES  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import model as jM  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import mamba2_370m as tmamba2  # noqa: E402
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


#: (architecture, FULL or SMOKE) over every architecture of the JAX
#: package; SmolLM's ids stay the bare config name.
CONFIGS = [pytest.param(arch, conf, id=conf if arch == "smollm_360m"
                        else f"{arch.split('_')[0]}-{conf}")
           for arch in ARCH_IDS for conf in ("FULL", "SMOKE")]


@pytest.mark.parametrize("arch,conf", CONFIGS)
def test_configs_match_the_jax_package(arch, conf):
    """The port's config module is the JAX one's copy: the same fields
    (none missing on either side), each equal."""
    mine = getattr(importlib.import_module(f"repro_torch.configs.{arch}"),
                   conf)
    theirs = getattr(importlib.import_module(f"repro.configs.{arch}"), conf)
    assert ({f.name for f in dataclasses.fields(mine)}
            == {f.name for f in dataclasses.fields(theirs)})
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert str(mine.dtype).split(".")[-1] == str(theirs.dtype)
    assert str(mine.adtype).split(".")[-1] == str(theirs.adtype)
    assert [mine.is_moe_layer(i) for i in range(mine.n_layers)] \
        == [theirs.is_moe_layer(i) for i in range(theirs.n_layers)]


def test_only_smollm_is_registered():
    """Every architecture of the JAX package resolves by module name, by
    each JAX alias (``phi4-mini-3.8b``) and by its dashed module name, to
    the port's config module; an unknown name raises in the registry, and
    a family neither package knows raises in the model; a windowed
    ``_sdpa`` call runs."""
    for arch in ARCH_IDS:
        mod = importlib.import_module(f"repro_torch.configs.{arch}")
        names = [arch, arch.replace("_", "-"), mod.FULL.name] + [
            a for a, m in JALIASES.items() if m == arch]
        for name in names:
            assert configs.get_config(name) is mod.FULL
            assert configs.get_smoke_config(name) is mod.SMOKE
    for name in ("granite-3-9b", "paper_cnn", "llama"):
        with pytest.raises(NotImplementedError, match="unknown"):
            configs.get_config(name)
    assert sorted(M.init_params(torch.Generator(), tmamba2.SMOKE, "cpu")
                  ["blocks"]) == ["ln", "ssm"]
    assert sorted(M.init_params(torch.Generator(), trg.SMOKE, "cpu")) == [
        "embed", "extra", "final_norm", "lm_head", "super"]
    with pytest.raises(ValueError, match="unknown family"):
        M.init_params(torch.Generator(), dataclasses.replace(
            CFG, family="video"), "cpu")
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
