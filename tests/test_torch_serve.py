"""The port's serving path against the JAX package on the CPU, at
SmolLM-360M's smoke config in float32: the slot ops ``lane_insert`` and
``lane_reset`` (exactly equal), and greedy tokens identical per request to
the JAX engines for both engines, each run through its launcher's ``main``
with the JAX launcher's parameters carried across.  Also: on the card the
continuous engine lets a failed prefill raise unless it is an injected
fault, off the card it finalizes that request as ``"failed"`` and serves
on, and the launcher refuses to run without a card unless asked for the
CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.serve import cache as jC  # noqa: E402

from repro_torch.ft import inject  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import cache as C  # noqa: E402
from repro_torch.serve.continuous import ContinuousEngine  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402
from repro_torch.tree import params_from_numpy  # noqa: E402

ARGV = ["--requests", "5", "--max-new", "6", "--prompt-len", "7",
        "--max-batch", "2"]


def test_lane_insert_and_reset_match_jax():
    r = np.random.RandomState(0)
    cache = {"blocks": {k: r.randn(3, 4, 6, 2, 5).astype(np.float32)
                        for k in ("k", "v")}}
    src = {"blocks": {k: r.randn(3, 1, 6, 2, 5).astype(np.float32)
                      for k in ("k", "v")}}
    got = C.lane_insert(jax.tree.map(torch.tensor, cache),
                        jax.tree.map(torch.tensor, src), 2)
    want = jC.lane_insert(jax.tree.map(jnp.asarray, cache),
                          jax.tree.map(jnp.asarray, src), jnp.int32(2))
    for key in ("k", "v"):
        np.testing.assert_array_equal(got["blocks"][key].numpy(),
                                      np.asarray(want["blocks"][key]))
    got = C.lane_reset(got, 1)
    want = jC.lane_reset(want, jnp.int32(1))
    for key in ("k", "v"):
        np.testing.assert_array_equal(got["blocks"][key].numpy(),
                                      np.asarray(want["blocks"][key]))


@pytest.fixture(scope="module")
def jax_params():
    cfg = jget_smoke("smollm-360m")
    return jax.tree.map(np.asarray, jM.build_model(cfg).init(
        jax.random.PRNGKey(0)))


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_greedy_tokens_match_the_jax_engines(engine, jax_params,
                                             monkeypatch):
    want = jserve.main(ARGV + ["--engine", engine])
    monkeypatch.setattr(tserve, "init_params", lambda cfg, seed, dev:
                        params_from_numpy(jax_params, dev))
    res = tserve.main(ARGV + ["--engine", engine, "--device", "cpu"])
    got = res["requests"]
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert g.status == w.status == "ok"
        assert g.out == w.out, (g.rid, g.out, w.out)
    summary = res["summary"]
    assert summary["engine_kind"] == engine
    assert summary["completed"] == 5 and summary["tokens"] == 30
    if engine == "continuous":
        assert summary["admitted"] == summary["inserts"] == 5
    else:
        assert summary["waves"] == 3


def test_continuous_engine_lets_a_failed_prefill_raise(monkeypatch):
    """On the card a prefill that raises anything but an injected fault
    (here a kernel launch) escapes ``run``: a broken kernel fails the
    serving run instead of being reported as a failed request.  The card
    is stood in for by what ``inject.absorbs`` answers for a CUDA
    device."""
    cfg = tserve.get_smoke_config("smollm-360m")
    eng = ContinuousEngine(cfg, tserve.init_params(cfg, 0, "cpu"),
                           max_batch=2, max_len=16)
    absorbs = inject.absorbs
    monkeypatch.setattr(inject, "absorbs",
                        lambda exc, device: absorbs(exc, "cuda"))

    def broken(*args, **kwargs):
        raise RuntimeError("flash_attention: CUDA launch failed")

    monkeypatch.setattr(M, "prefill", broken)
    eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new=4))
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.run()
    assert eng.counters["failed"] == 0 and eng.counters["admitted"] == 0


def test_continuous_engine_fails_a_request_whose_prefill_raises_on_cpu(
        monkeypatch):
    """Off the card, as in the JAX engine, a prefill that raises
    finalizes THAT request as ``"failed"`` and the engine serves the
    next one."""
    cfg = tserve.get_smoke_config("smollm-360m")
    eng = ContinuousEngine(cfg, tserve.init_params(cfg, 0, "cpu"),
                           max_batch=2, max_len=16)
    prefill = M.prefill
    calls = []

    def broken_once(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("flash_attention: CUDA launch failed")
        return prefill(*args, **kwargs)

    monkeypatch.setattr(M, "prefill", broken_once)
    eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new=4))
    eng.submit(Request(rid=1, prompt=[1, 2, 3], max_new=4))
    done = {r.rid: r for r in eng.run()}
    assert done[0].status == "failed" and done[0].out == []
    assert done[1].status == "ok" and len(done[1].out) == 4
    assert eng.counters["failed"] == 1 and eng.counters["admitted"] == 1


def test_launcher_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--requests", "1", "--max-new", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(torch.Generator(), tserve.get_smoke_config(
            "smollm-360m"))


def test_temperature_sampler_is_seeded():
    from repro_torch.serve.sampling import make_sampler
    logits = torch.from_numpy(np.random.RandomState(3).randn(6, 50)
                              .astype(np.float32))
    draws = [make_sampler(0.8, seed=7)(logits) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert draws[0].shape == (6,) and 0 <= int(draws[0].min())
    assert int(draws[0].max()) < 50
    assert torch.equal(make_sampler(0.0)(logits), logits.argmax(-1))


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_expired_requests_time_out_at_admission(engine):
    cfg = tserve.get_smoke_config("smollm-360m")
    now = [0.0]
    eng = tserve.ENGINES[engine](cfg, tserve.init_params(cfg, 0, "cpu"),
                                 max_batch=2, max_len=16,
                                 clock=lambda: now[0])
    eng.submit(Request(rid=0, prompt=[1, 2], max_new=3, deadline_s=1.0))
    eng.submit(Request(rid=1, prompt=[3, 4], max_new=3))
    now[0] = 5.0
    done = {r.rid: r for r in eng.run()}
    assert done[0].status == "timed_out" and done[0].out == []
    assert done[1].status == "ok" and len(done[1].out) == 3
    assert eng.run_summary()["timed_out"] == 1
