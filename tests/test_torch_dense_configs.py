"""The port's remaining dense configs (granite-3-8b, minicpm-2b,
phi4-mini-3.8b) and the VLM's token path (internvl2-76b) against the JAX
package on the CPU, at their smoke configs in float32, with the JAX model's
parameters carried across by ``params_from_numpy``:

* ``forward`` logits, 1e-5;
* the one-pass ``prefill`` (one flash-wrapper call a layer: its plain
  version here) against JAX's scan of decode steps: the last logits and
  every layer's cache, 1e-5;
* greedy tokens of both engines, through the launchers, identical;
* every architecture of the JAX package: the published configs' parameter
  counts equal JAX's (``jax.eval_shape``; the port's init on the meta
  device), and ``build_model(cfg).init`` and ``forward`` run at every smoke
  config.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as jM  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data import pipeline as pipe  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.tree import params_from_numpy  # noqa: E402

#: the token-path configs of this file: the three dense ones and the VLM,
#: whose prefill and decode take text only, as in the JAX package.
ARCHS = ["granite-3-8b", "minicpm-2b", "phi4-mini-3.8b", "internvl2-76b"]
TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def carried():
    """arch -> (JAX params as numpy, the port's params from them)."""
    out = {}

    def get(arch):
        if arch not in out:
            jp = jax.tree.map(np.asarray, jM.init_params(
                jax.random.PRNGKey(0), jget_smoke(arch)))
            out[arch] = jp, params_from_numpy(jp, device="cpu")
        return out[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, carried):
    jp, params = carried(arch)
    cfg = configs.get_smoke_config(arch)
    toks = np.random.RandomState(3).randint(0, cfg.vocab, (2, 33))
    got, aux = M.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    want, _ = jM.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                         jget_smoke(arch))
    assert aux == {} and got.shape == (2, 33, cfg.vocab)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax_scan(arch, carried, monkeypatch):
    jp, params = carried(arch)
    cfg = configs.get_smoke_config(arch)
    toks = np.random.RandomState(4).randint(0, cfg.vocab, (2, 21))
    calls = []
    spy = A.flash_attention
    monkeypatch.setattr(A, "flash_attention", lambda *a, **k: calls.append(
        k["causal"]) or spy(*a, **k))
    logits, cache = M.prefill(params, torch.from_numpy(toks), cfg, 30)
    assert calls == [True] * cfg.n_layers
    want_logits, want_cache = jM.prefill(
        jp, jnp.asarray(toks, jnp.int32), jget_smoke(arch), 30)
    _close(logits, want_logits)
    assert sorted(cache) == sorted(want_cache) == ["blocks"]
    for key in ("k", "v"):
        got = cache["blocks"][key]
        assert got.shape == (cfg.n_layers, 2, 30, cfg.n_kv_heads,
                             cfg.head_dim)
        _close(got, want_cache["blocks"][key])
        assert not got[:, :, 21:].any()


ARGV = ["--requests", "5", "--max-new", "6", "--prompt-len", "7",
        "--max-batch", "2"]


@pytest.mark.parametrize("engine", ["static", "continuous"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_the_jax_engines(arch, engine, carried,
                                             monkeypatch):
    argv = ARGV + ["--arch", arch, "--engine", engine]
    want = jserve.main(argv)
    jp, _ = carried(arch)
    monkeypatch.setattr(tserve, "init_params", lambda cfg, seed, dev:
                        params_from_numpy(jp, dev))
    got = tserve.main(argv + ["--device", "cpu"])["requests"]
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert g.status == w.status == "ok"
        assert g.out == w.out, (g.rid, g.out, w.out)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_published_parameter_counts_match_jax(arch, monkeypatch):
    """The published widths' parameter tree (drawn on the meta device: no
    memory) has JAX's keys' count of parameters, for every architecture."""
    monkeypatch.setattr(L, "_draw", lambda g, shape, scale, dtype, device:
                        torch.empty(shape, dtype=dtype, device="meta"))
    cfg = configs.get_config(arch)
    got = M.count_params(M.init_params(torch.Generator(), cfg, "meta"))
    shapes = jax.eval_shape(lambda: jM.init_params(jax.random.PRNGKey(0),
                                                   jget_config(arch)))
    assert got == sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_smoke_config_builds_and_runs(arch):
    """``build_model(cfg).init`` and ``forward`` on ``make_batch``'s batch
    at every smoke config: finite logits over the positions the family
    predicts (the VLM's text, the audio encoder's frames)."""
    cfg = configs.get_smoke_config(arch)
    model = M.build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in pipe.make_batch(
        cfg, pipe.DataConfig(seq_len=24, global_batch=2), 0).items()}
    with torch.no_grad():
        logits, _ = model.forward(params, batch)
    assert logits.shape == (*batch["targets"].shape, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
