"""The port's transposed conv and the autoencoder trainer against the JAX
package on the CPU: the mirror geometry (``transpose_dims``, output shape,
tap accounting) equal; ``conv2d_transpose`` y/dx/dw within 1e-4 relative
of JAX under ``lax``, ``traditional``, ``bp_im2col`` and ``bp_phase`` (the
port's ``pallas`` against JAX's ``lax``: the JAX Pallas kernels do not run
on the installed jax); the AdamW step and schedules; and 20 autoencoder
steps from the JAX example's parameters, MSEs within 1e-4."""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import conv as jconv  # noqa: E402
from repro.core.convspec import ConvTransposeSpec as JTSpec  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402

from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.core.convspec import ConvTransposeSpec  # noqa: E402
from repro_torch.models import autoencoder as TM  # noqa: E402
from repro_torch.optim import adamw, schedule  # noqa: E402
from repro_torch.train import autoencoder_bp, cnn_bp  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.tree import params_from_numpy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-4


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-6), err


# (x shape, w shape (C_in, C_out/g, kh, kw), ConvTransposeSpec.make kwargs)
CASES = [
    ((2, 4, 5, 5), (4, 3, 3, 3), dict(stride=2, padding=1,
                                      output_padding=1)),
    ((1, 3, 4, 5), (3, 2, 3, 3), dict(stride=(2, 3), padding=1)),
    ((2, 2, 4, 4), (2, 3, 1, 1), dict(stride=2)),
    ((1, 2, 5, 5), (2, 2, 3, 3), dict(stride=2, padding=2, dilation=2,
                                      output_padding=1)),
    ((2, 4, 5, 5), (4, 3, 3, 3), dict(stride=2, padding=1, groups=2,
                                      output_padding=1)),
    ((1, 2, 4, 4), (2, 2, 3, 3), dict(stride=3, padding=((0, 2), (1, 1)))),
    ((2, 3, 6, 6), (3, 2, 3, 3), dict(stride=1, padding=1)),
]
IDS = ["s2op1", "s2x3", "k1s2", "d2", "g2", "s3asympad", "s1"]


def _data(case, seed=0):
    x_shape, w_shape, kw = case
    r = np.random.RandomState(seed)
    x = r.randn(*x_shape).astype(np.float32)
    w = r.randn(*w_shape).astype(np.float32)
    spec = ConvTransposeSpec.make(**kw)
    out = tconv.conv_transpose_output_shape(x_shape, w_shape, spec)
    dy = r.randn(*out).astype(np.float32)
    return x, w, dy, spec, JTSpec.make(**kw)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mirror_geometry_equals_jax(case):
    x, w, _, spec, jspec = _data(case)
    d = tconv.transpose_dims(x.shape, w.shape, spec)
    jd = jconv.transpose_dims(x.shape, w.shape, jspec)
    assert dataclasses.asdict(d) == dataclasses.asdict(jd)
    assert tconv.conv_transpose_output_shape(x.shape, w.shape, spec) == \
        jconv.conv_transpose_output_shape(x.shape, w.shape, jspec)
    assert tconv.transpose_tap_counts(d) == jconv.transpose_tap_counts(jd)
    nhwc = spec.with_layout("NHWC")
    x_nhwc = x.transpose(0, 2, 3, 1).shape
    assert tconv.conv_transpose_output_shape(x_nhwc, w.shape, nhwc) == \
        jconv.conv_transpose_output_shape(x_nhwc, w.shape,
                                          jspec.with_layout("NHWC"))


def _jax_fwd_bwd(x, w, dy, jspec, engine, materialized=False):
    @jax.jit
    def run(a, b, c):
        f = (lambda a_, b_: jconv.conv2d_transpose_materialized(
                a_, b_, jspec, engine)) if materialized else \
            (lambda a_, b_: jconv.conv2d_transpose(a_, b_, jspec, engine))
        y, vjp = jax.vjp(f, a, b)
        return (y, *vjp(c))
    return run(x, w, dy)


def _torch_fwd_bwd(x, w, dy, spec, policy):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = tconv.conv2d_transpose(xt, wt, spec, policy)
    y.backward(torch.from_numpy(dy))
    return y.detach(), xt.grad, wt.grad


@pytest.mark.parametrize("policy", ["lax", "traditional", "bp_im2col",
                                    "bp_phase", "pallas"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_conv2d_transpose_matches_jax(case, policy):
    x, w, dy, spec, jspec = _data(case)
    want = _jax_fwd_bwd(x, w, dy, jspec, "lax" if policy == "pallas"
                        else policy)
    tconv.reset_dispatch_events()
    got = _torch_fwd_bwd(x, w, dy, spec, policy)
    for g, wnt in zip(got, want):
        _close(g, wnt)
    d = tconv.transpose_dims(x.shape, w.shape, spec)
    engine = {p: tconv.resolve_engine(policy, p, d, True)[0]
              for p in ("forward", "input_grad", "weight_grad")}
    assert tconv.dispatch_events() == {
        f"{p}_T:{e}": 1 for p, e in engine.items()}


@pytest.mark.parametrize("engine", ["lax", "traditional"])
def test_materialized_oracle_matches_jax(engine):
    x, w, dy, spec, jspec = _data(CASES[4])
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = tconv.conv2d_transpose_materialized(xt, wt, spec, engine)
    y.backward(torch.from_numpy(dy))
    want = _jax_fwd_bwd(x, w, dy, jspec, engine, materialized=True)
    for g, wnt in zip((y.detach(), xt.grad, wt.grad), want):
        _close(g, wnt)


def test_pallas_forward_is_the_phased_input_grad_and_traditional_materializes(
        monkeypatch):
    """Under pallas the transposed forward role-swaps onto the mirror input
    grad (one tap_gemm_phased call); under traditional it zero-inserts the
    input and runs the explicit forward GEMM through matmul."""
    from repro_torch.core import im2col_ref
    from repro_torch.kernels import ops, ref
    calls = []
    monkeypatch.setattr(ref, "tap_gemm_phased_ref",
                        lambda *a, f=ref.tap_gemm_phased_ref:
                        calls.append("phased") or f(*a))
    monkeypatch.setattr(im2col_ref, "matmul",
                        lambda *a, f=im2col_ref.matmul, **k:
                        calls.append("matmul") or f(*a, **k))
    x, w, _, spec, _ = _data(CASES[0])
    with torch.no_grad():
        tconv.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                               spec, "pallas")
        assert calls == ["phased"]
        calls.clear()
        tconv.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                               spec, "traditional")
        assert calls == ["matmul"]
    assert ops.launch_gap("input_grad", tconv.transpose_dims(
        x.shape, w.shape, spec)) is None


def test_output_padding_must_be_below_stride():
    with pytest.raises(ValueError, match="output_padding"):
        ConvTransposeSpec.make(stride=2, output_padding=2)
    with pytest.raises(ValueError, match="channel mismatch"):
        tconv.transpose_dims((1, 3, 4, 4), (4, 2, 3, 3),
                             ConvTransposeSpec.make(stride=2))


def test_params_from_numpy_takes_nested_lists_and_dicts():
    tree = {"enc": [{"w": np.ones((2, 3))}, {"w": np.zeros(4)}],
            "dec": ({"w": np.full((1,), 2.0)},), "head": np.eye(2)}
    got = params_from_numpy(tree, device="cpu")
    assert isinstance(got["enc"], list) and isinstance(got["dec"], tuple)
    assert got["enc"][0]["w"].dtype == torch.float32
    np.testing.assert_array_equal(got["dec"][0]["w"].numpy(), [2.0])
    np.testing.assert_array_equal(got["head"].numpy(), np.eye(2))
    assert cnn_bp.params_from_numpy is params_from_numpy


@pytest.mark.parametrize("name", ["cosine", "wsd", "constant"])
def test_schedules_match_jax(name):
    for step in (0, 1, 5, 17, 90, 95, 100, 130):
        got = schedule.SCHEDULES[name](step, peak_lr=1e-2, warmup=10,
                                       total=100)
        want = float(jschedule.SCHEDULES[name](step, peak_lr=1e-2,
                                               warmup=10, total=100))
        assert abs(got - want) <= 1e-6 * 1e-2, (step, got, want)


def test_adamw_step_matches_jax():
    r = np.random.RandomState(4)
    params = {"a": [r.randn(3, 4), r.randn(5)], "b": r.randn(2, 2)}
    grads = jax.tree.map(lambda p: 3 * r.randn(*p.shape), params)
    cfg = adamw.AdamWConfig(peak_lr=1e-2)
    jcfg = jadamw.AdamWConfig(peak_lr=1e-2)
    jp = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32), params)
    jg = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32), grads)
    tp = params_from_numpy(params, "cpu")
    tg = params_from_numpy(grads, "cpu")
    js, ts = jadamw.init_state(jp), adamw.init_state(tp)
    for _ in range(3):
        jp, js, jm = jadamw.apply_updates(jp, jg, js, 1e-2, jcfg)
        tp, ts, tm = adamw.apply_updates(tp, tg, ts, 1e-2, cfg)
    assert ts["step"] == int(js["step"]) == 3
    _close(tm["grad_norm"], jm["grad_norm"], 1e-6)
    for got, want in zip(jax.tree.leaves(jax.tree.map(np.asarray, jp)),
                         [tp["a"][0], tp["a"][1], tp["b"]]):
        _close(got, want.numpy(), 1e-6)


def test_make_train_step_raises_on_what_is_not_ported():
    cfg = TM.AutoencoderConfig()
    opt = adamw.AdamWConfig()
    loss = TM.autoencoder_loss
    for kw, item in ((dict(accum_steps=2), "A9"),
                     (dict(compress_grads=True), "A9"),
                     (dict(guard=True), "A12"), (dict(conv_mesh="tp"), "A13")):
        with pytest.raises(NotImplementedError, match=item):
            make_train_step(cfg, opt, loss=loss, **kw)
    with pytest.raises(NotImplementedError, match="A10"):
        make_train_step(cfg, opt)


def _jax_example():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import train_autoencoder_bp
    finally:
        sys.path.remove(str(ROOT / "examples"))
    return train_autoencoder_bp


def test_synthetic_images_are_bit_identical():
    ex = _jax_example()
    np.testing.assert_array_equal(
        autoencoder_bp.synthetic_images(np.random.RandomState(3), 4),
        ex.synthetic_images(np.random.RandomState(3), 4))


STEPS, BATCH = 20, 16


@pytest.fixture(scope="module")
def jax_autoencoder():
    """The JAX example's training loop (make_train_step, AdamW, cosine
    schedule) under traditional for 20 steps at batch 16."""
    ex = _jax_example()
    cfg = JM.AutoencoderConfig(c_in=3, widths=(16, 32), k=3,
                               conv_policy="traditional")
    params = JM.init_autoencoder(jax.random.PRNGKey(0), cfg)
    params0 = jax.tree.map(np.asarray, params)
    opt_state = jadamw.init_state(params)
    step_fn = jax.jit(jmake_train_step(
        cfg, jadamw.AdamWConfig(peak_lr=1e-2, weight_decay=0.0),
        total_steps=STEPS, warmup=max(1, STEPS // 10),
        loss=JM.autoencoder_loss, conv_policy="traditional"))
    rng = np.random.RandomState(0)
    mses = []
    for step in range(STEPS):
        batch = {"image": ex.synthetic_images(rng, BATCH, 3, 16)}
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        mses.append(float(metrics["mse"]))
    return params0, np.array(mses)


@pytest.mark.parametrize("policy", ["traditional", "pallas", "bp_im2col"])
def test_autoencoder_mses_match_jax_example(jax_autoencoder, policy):
    """20 MSEs from the JAX example's parameters within 1e-4 (measured
    here: at most 6.2e-6 under each policy)."""
    params0, want = jax_autoencoder
    res = autoencoder_bp.train(policy, steps=STEPS, batch=BATCH,
                               device="cpu",
                               params=params_from_numpy(params0, "cpu"))
    np.testing.assert_allclose(res["mses"], want, rtol=1e-4, atol=1e-4)


def test_autoencoder_cli_runs_on_the_cpu(capsys):
    tconv.reset_dispatch_events()
    res = autoencoder_bp.main(["--device", "cpu", "--steps", "3",
                               "--mse-floor", "1", "--policy", "pallas"])
    assert len(res["mses"]) == 3 and all(np.isfinite(res["mses"]))
    assert "final_mse" in capsys.readouterr().out
    ev = tconv.dispatch_events()
    # 2 encoder convs and 2 decoder transposed convs per step, every pass.
    assert ev["forward_T:pallas"] == 6 and ev["weight_grad_T:pallas"] == 6
    assert ev["input_grad_T:pallas"] == 6 and ev["forward:pallas"] == 6
    assert ev["input_grad:pallas"] == 3    # the first conv needs no dx
    with pytest.raises(SystemExit, match="failed to learn"):
        autoencoder_bp.main(["--device", "cpu", "--steps", "1",
                             "--mse-floor", "0", "--policy", "lax"])


def test_chip_smoke_checks_every_gemm_the_autoencoder_runs(monkeypatch):
    """The smoke script holds ``matmul`` against its plain version at each
    GEMM one traditional autoencoder step runs, and at no other of its
    shapes (recorded on the CPU, where ``matmul`` calls ``matmul_ref``)."""
    from repro_torch.core.im2col_ref import ConvDims
    from repro_torch.kernels import ref
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    ae = chip_smoke.ae_shapes(ConvDims, tconv, ConvTransposeSpec)
    cases = chip_smoke.matmul_cases(torch, tconv,
                                    chip_smoke.cnn_shapes(ConvDims), ae)
    want = sorted(c[2] for c in cases if c[0].startswith("ae."))
    seen, plain = [], ref.matmul_ref

    def record(a, b, out_dtype=None):
        a3, b3 = (a, b) if a.dim() == 3 else (a[None], b[None])
        seen.append((*a3.shape, b3.shape[2]))
        return plain(a, b, out_dtype)

    monkeypatch.setattr(ref, "matmul_ref", record)
    autoencoder_bp.train("traditional", steps=1, device="cpu")
    assert sorted(seen) == want
