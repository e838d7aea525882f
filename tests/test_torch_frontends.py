"""The port's VLM (internvl2-76b) and audio encoder (hubert-xlarge) against
the JAX package on the CPU, at their smoke configs in float32, with the
JAX model's parameters carried across by ``params_from_numpy``:

* the VLM's forward on projected image embeddings ahead of the text:
  logits over the text positions only, 1e-5;
* the audio encoder's forward on projected frames (bidirectional: the
  first position reads the last frame), 1e-5;
* 3 ``make_train_step`` steps on ``make_batch``'s audio and VLM batches:
  losses and grad norms within 1e-4 (``LM_TRAIN_TOL``) of JAX's step;
* the launcher: minicpm-2b trains on WSD, as in the JAX launcher, and
  hubert-xlarge's losses equal the JAX launcher's (1e-4);
* ``_sdpa``'s routing: a no-grad full (non-causal) call runs the flash
  wrapper with ``causal=False``; a call a gradient flows through, or one
  with ``kv_len`` (decode), runs the dense path;
* the audio encoder has no cache and neither engine serves it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import train_step as jTS  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data import pipeline as pipe  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.launch.serve import ENGINES  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw, schedule  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.tree import (params_from_numpy,  # noqa: E402
                              tree_from_numpy, tree_leaves)

VLM, AUDIO = "internvl2-76b", "hubert-xlarge"
TOL = 1e-5
LM_TRAIN_TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    return {arch: _np(jM.init_params(jax.random.PRNGKey(0),
                                     jget_smoke(arch)))
            for arch in (VLM, AUDIO)}


def _forward_both(jparams, arch, batch):
    got, _ = M.forward(params_from_numpy(jparams[arch], device="cpu"),
                       tree_from_numpy(batch, "cpu"),
                       configs.get_smoke_config(arch))
    want, _ = jM.forward(jparams[arch], jax.tree.map(jnp.asarray, batch),
                         jget_smoke(arch))
    return got, want


def test_vlm_forward_with_images_matches_jax(jparams):
    """8 image embeddings take positions 0-7 (RoPE and attention), the 12
    text tokens 8-19; the head sees the text positions only."""
    cfg = configs.get_smoke_config(VLM)
    r = np.random.RandomState(0)
    batch = {"tokens": r.randint(0, cfg.vocab, (2, 12)).astype(np.int32),
             "frontend": r.randn(2, cfg.frontend_tokens,
                                 cfg.d_frontend).astype(np.float32)}
    got, want = _forward_both(jparams, VLM, batch)
    assert got.shape == (2, 12, cfg.vocab)
    _close(got, want)
    # The images reach the text: other images give other text logits.
    batch["frontend"] = batch["frontend"][::-1].copy()
    assert not torch.allclose(_forward_both(jparams, VLM, batch)[0], got)


def test_audio_forward_is_bidirectional_and_matches_jax(jparams):
    cfg = configs.get_smoke_config(AUDIO)
    frames = np.random.RandomState(1).randn(2, 20, cfg.d_frontend) \
        .astype(np.float32)
    got, want = _forward_both(jparams, AUDIO, {"frontend": frames})
    assert got.shape == (2, 20, cfg.vocab)
    _close(got, want)
    later = frames.copy()
    later[:, -1] += 1.0
    got2, want2 = _forward_both(jparams, AUDIO, {"frontend": later})
    _close(got2, want2)
    # Position 0 reads the last frame, in both packages.
    assert float((got2[:, 0] - got[:, 0]).abs().max()) > 1e-3
    assert float(np.abs(np.asarray(want2)[:, 0]
                        - np.asarray(want)[:, 0]).max()) > 1e-3


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_three_train_steps_match_jax(jparams, arch):
    """Guarded steps from JAX's init on the pipeline's VLM batch (8 image
    embeddings, 23 text tokens) or audio batch (32 frames): losses and
    grad norms within ``LM_TRAIN_TOL``; the audio encoder's unread
    ``embed`` gets a zero gradient (AdamW's decay still moves it, as in
    JAX)."""
    cfg, jcfg = configs.get_smoke_config(arch), jget_smoke(arch)
    kw = dict(total_steps=3, warmup=1, guard=True)
    jstep = jax.jit(jTS.make_train_step(
        jcfg, jadamw.AdamWConfig(peak_lr=1e-3), **kw))
    tstep = TS.make_train_step(cfg, adamw.AdamWConfig(peak_lr=1e-3), **kw)
    jp = jax.tree.map(jnp.asarray, jparams[arch])
    jo = jadamw.init_state(jp)
    tp = tree_from_numpy(jparams[arch], "cpu")
    to = tree_from_numpy(_np(jo), "cpu")
    dcfg = pipe.DataConfig(seed=3, seq_len=32, global_batch=2,
                           vocab=cfg.vocab)
    for s in range(3):
        b = pipe.make_batch(cfg, dcfg, s)
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b),
                           jnp.int32(s))
        tp, to, tm = tstep(tp, to, tree_from_numpy(b, "cpu"), s)
        for k in ("loss", "grad_norm", "guard_bad"):
            _close(tm[k], jm[k], LM_TRAIN_TOL)
    for g, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        _close(g, w, LM_TRAIN_TOL)
    if arch == AUDIO:
        grads = TS._value_and_grad(TS.loss_fn, tp, tree_from_numpy(b, "cpu"),
                                   cfg)[2]
        assert not grads["embed"]["w"].any()


def test_minicpm_launcher_trains_on_wsd(monkeypatch):
    """minicpm-2b's launcher run picks WSD (warmup, a stable plateau, the
    decay over the last tenth) and its losses equal the JAX launcher's."""
    argv = ["--arch", "minicpm-2b", "--smoke", "--steps", "8", "--batch",
            "2", "--seq", "16"]
    want = jlaunch.main(argv)
    steps = []
    wsd = schedule.SCHEDULES["wsd"]
    monkeypatch.setitem(schedule.SCHEDULES, "wsd", lambda step, **kw:
                        steps.append(step) or wsd(step, **kw))
    monkeypatch.setitem(schedule.SCHEDULES, "cosine", None)
    jp = _np(jM.init_params(jax.random.PRNGKey(0),
                            jget_smoke("minicpm-2b")))
    got = launch.main(argv + ["--device", "cpu"],
                      params=tree_from_numpy(jp, "cpu"))
    assert steps == list(range(1, 9))
    np.testing.assert_allclose(got, want, rtol=LM_TRAIN_TOL,
                               atol=LM_TRAIN_TOL)


def test_audio_launcher_matches_jax(jparams):
    argv = ["--arch", AUDIO, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "16"]
    want = jlaunch.main(argv)
    got = launch.main(argv + ["--device", "cpu"],
                      params=tree_from_numpy(jparams[AUDIO], "cpu"))
    np.testing.assert_allclose(got, want, rtol=LM_TRAIN_TOL,
                               atol=LM_TRAIN_TOL)


def test_sdpa_routes_full_calls_to_flash_only_without_grad(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 9, 4, 8, generator=gen) for _ in range(3))
    calls = []
    spy = A.flash_attention
    monkeypatch.setattr(A, "flash_attention", lambda *a, **kw: calls.append(
        kw["causal"]) or spy(*a, **kw))
    dense = A._sdpa_dense(q, k, v, causal=False, q_offset=0, kv_len=None,
                          scale=8 ** -0.5)
    with torch.no_grad():
        _close(A._sdpa(q, k, v, causal=False), dense, 1e-6)
    assert calls == [False]
    qg = q.clone().requires_grad_(True)
    out = A._sdpa(qg, k, v, causal=False)
    assert out.grad_fn is not None and calls == [False]
    _close(out.detach(), dense, 1e-6)
    with torch.no_grad():
        A._sdpa(q, k, v, causal=False, q_offset=8, kv_len=9)
        A._sdpa(q[:, :1], k, v, causal=False, q_offset=8, kv_len=9)
    assert calls == [False]


def test_audio_encoder_has_no_cache_and_is_not_served():
    cfg = configs.get_smoke_config(AUDIO)
    with pytest.raises(ValueError, match="encoder-only"):
        T.init_cache(cfg, 2, 16, "cpu")
    params = M.init_params(torch.Generator(), cfg, "cpu")
    for cls in ENGINES.values():
        with pytest.raises(ValueError, match="encoder-only archs do not"):
            cls(cfg, params, max_batch=2, max_len=16)
