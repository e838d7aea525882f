"""The port's ``conv2d`` (forward and both grads through the per-pass
engines) against the JAX package's lax ground truth, rtol/atol 1e-4, over
strides {1,2,3}, asymmetric strides, dilation, asymmetric padding, groups
and depthwise; plus the ``"auto"`` resolution, which must pick the same
engine as the JAX resolver for every case."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import conv as jconv  # noqa: E402
from repro.core import im2col_ref as jref  # noqa: E402
from repro.core.convspec import ConvSpec as JSpec  # noqa: E402

from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.core.convspec import ConvSpec, EnginePolicy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)

# (x shape, w shape, ConvSpec.make kwargs)
GEOMS = [
    ((2, 3, 8, 8), (4, 3, 3, 3), dict(stride=1, padding=1)),
    ((2, 3, 9, 9), (4, 3, 3, 3), dict(stride=2, padding=1)),
    ((1, 2, 12, 12), (3, 2, 3, 3), dict(stride=3, padding=1)),
    ((2, 2, 8, 8), (3, 2, 1, 1), dict(stride=2)),
    ((1, 3, 10, 12), (4, 3, 3, 3), dict(stride=(2, 3), padding=1)),
    ((1, 2, 11, 11), (3, 2, 3, 3), dict(stride=2, padding=2, dilation=2)),
    ((1, 2, 10, 10), (2, 2, 3, 3), dict(stride=1, padding=2, dilation=2)),
    ((2, 3, 9, 10), (2, 3, 3, 3), dict(stride=2, padding=((0, 2), (2, 1)))),
    ((2, 4, 9, 9), (6, 2, 3, 3), dict(stride=2, padding=1, groups=2)),
    ((2, 5, 8, 8), (5, 1, 3, 3), dict(stride=1, padding=1, groups=5)),
    ((2, 4, 8, 8), (4, 1, 3, 3), dict(stride=2, padding=1, groups=4)),
]
GEOM_IDS = ["s1", "s2", "s3", "k1s2", "s2x3", "s2d2", "s1d2", "asympad",
            "g2s2", "dw_s1", "dw_s2"]
POLICIES = ["pallas", "bp_phase", "lax", "auto",
            "fwd=pallas,dgrad=bp_phase,wgrad=pallas"]


def _data(x_shape, w_shape, kw, seed=0):
    spec = ConvSpec.make(**kw)
    d = tconv.spec_dims(x_shape, w_shape, spec)
    r = np.random.RandomState(seed)
    x = r.randn(*x_shape).astype(np.float32)
    w = r.randn(*w_shape).astype(np.float32)
    dy = r.randn(d.B, d.N * spec.groups, d.H_o, d.W_o).astype(np.float32)
    return x, w, dy, spec


def _jax_truth(x, w, dy, kw):
    """(y, dI, dW) from repro.core.im2col_ref's lax oracle, group by group,
    with the dilated kernel materialized and its real taps sliced back."""
    jspec = JSpec.make(**kw)
    d = jconv.spec_dims(x.shape, w.shape, jspec)
    g = jspec.groups
    ys, dis, dws = [], [], []
    for i in range(g):
        xg = jnp.asarray(x[:, i * d.C:(i + 1) * d.C])
        wg = jnp.asarray(w[i * d.N:(i + 1) * d.N])
        dyg = jnp.asarray(dy[:, i * d.N:(i + 1) * d.N])
        w_eff = jref.zero_insert(wg, (d.D_h, d.D_w))
        ys.append(np.asarray(jref.conv2d_lax(xg, w_eff, d)))
        di, dw = jref.conv_grads_lax(xg, w_eff, dyg, d)
        dis.append(np.asarray(di))
        dws.append(np.asarray(dw)[..., ::d.D_h, ::d.D_w])
    return (np.concatenate(ys, 1), np.concatenate(dis, 1),
            np.concatenate(dws, 0))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_conv2d_and_grads_match_jax_lax(geom, policy):
    x_shape, w_shape, kw = geom
    x, w, dy, spec = _data(x_shape, w_shape, kw)
    want_y, want_dx, want_dw = _jax_truth(x, w, dy, kw)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    tconv.reset_dispatch_events()
    y = tconv.conv2d(xt, wt, spec, policy)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), want_y, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), want_dw, **TOL)
    # dispatch_events names exactly the engines the resolver picked.
    d = tconv.spec_dims(x_shape, w_shape, spec)
    picked = tconv.resolve_policy(d, policy)
    assert tconv.dispatch_events() == {
        f"{p}:{v['engine']}": 1 for p, v in picked.items()}
    if EnginePolicy.coerce(policy).forward == "pallas":
        assert picked["forward"]["engine"] == "pallas"


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_auto_resolves_like_jax(geom):
    x_shape, w_shape, kw = geom
    d = tconv.spec_dims(x_shape, w_shape, ConvSpec.make(**kw))
    jd = jconv.spec_dims(x_shape, w_shape, JSpec.make(**kw))
    for p in ("forward", "input_grad", "weight_grad"):
        got, _ = tconv.resolve_engine("auto", p, d)
        want, _ = jconv.resolve_engine("auto", p, jd)
        assert got == want, (p, got, want)


def test_policy_strings_parse_like_jax():
    from repro.core.convspec import EnginePolicy as JPolicy
    for text in POLICIES + ["dgrad=pallas", "wgrad=lax,fwd=bp_phase"]:
        got = EnginePolicy.parse(text)
        want = JPolicy.parse(text)
        assert got.slots() == want.slots() and str(got) == str(want)


def test_geometry_outside_paper_constraints_falls_back_with_reason():
    """Padding beyond K-1: the kernel and bp_phase engines decline and the
    resolver records why, landing on lax (as in the JAX package)."""
    x, w, dy, spec = _data((1, 2, 8, 8), (2, 2, 3, 3),
                           dict(stride=2, padding=3))
    want_y, want_dx, want_dw = _jax_truth(x, w, dy, dict(stride=2, padding=3))
    tconv.reset_dispatch_events()
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = tconv.conv2d(xt, wt, spec, "pallas")
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), want_y, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), want_dw, **TOL)
    assert set(tconv.dispatch_events()) == {"forward:lax", "input_grad:lax",
                                            "weight_grad:lax"}
    assert all("paper's constraints" in dec["reason"]
               for dec in tconv.policy_decisions())


def test_kernel_launch_limit_falls_back_with_reason():
    """A 256x256 stride has 65,536 input-grad phases, one past the grid's z
    limit: that pass leaves the kernel engine with the reason recorded,
    while the forward and weight grad (9 taps) stay on it."""
    d = tconv.make_dims((1, 1, 256, 256), (1, 1, 3, 3), stride=256)
    assert "grid z = 65536" in tops.launch_gap("input_grad", d)
    for requested in ("pallas", "auto"):
        engine, reason = tconv.resolve_engine(requested, "input_grad", d)
        assert engine == "bp_phase" and "grid z = 65536" in reason
        for p in ("forward", "weight_grad"):
            assert tconv.resolve_engine(requested, p, d)[0] == "pallas"


def test_conv_policy_context_and_nhwc_layout():
    x, w, dy, spec = _data((2, 3, 9, 9), (4, 3, 3, 3),
                           dict(stride=2, padding=1))
    want_y, _, _ = _jax_truth(x, w, dy, dict(stride=2, padding=1))
    tconv.reset_dispatch_events()
    with tconv.conv_policy("bp_phase"):
        y = tconv.conv2d(torch.from_numpy(x.transpose(0, 2, 3, 1).copy()),
                         torch.from_numpy(w), spec.with_layout("NHWC"),
                         "pallas")
    np.testing.assert_allclose(y.numpy().transpose(0, 3, 1, 2), want_y, **TOL)
    assert tconv.dispatch_events() == {"forward:bp_phase": 1}
    with pytest.raises(ValueError, match="unknown conv engine"):
        tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w), spec, "nope")


def test_input_grad_skipped_when_input_needs_none():
    x, w, dy, spec = _data((2, 3, 9, 9), (4, 3, 3, 3),
                           dict(stride=2, padding=1))
    wt = torch.from_numpy(w).requires_grad_(True)
    tconv.reset_dispatch_events()
    tconv.conv2d(torch.from_numpy(x), wt, spec, "pallas").backward(
        torch.from_numpy(dy))
    assert tconv.dispatch_events() == {"forward:pallas": 1,
                                       "weight_grad:pallas": 1}


# ---------------------------------------------------------------------------
# The call surfaces of conv2d and conv2d_transpose, against the JAX package's
# ---------------------------------------------------------------------------

def _both(call, x, w):
    """``call(conv2d, x, w)`` through the JAX package and the port."""
    want = np.asarray(call(jconv, jnp.asarray(x), jnp.asarray(w)))
    got = call(tconv, torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


CALLS = {
    "spec_policy": lambda m, x, w: m.conv2d(
        x, w, (JSpec if m is jconv else ConvSpec).make(stride=2, padding=1),
        "lax"),
    "spec_kw": lambda m, x, w: m.conv2d(
        x, w, spec=(JSpec if m is jconv else ConvSpec).make(stride=2),
        policy="bp_phase"),
    "geometry_kwargs": lambda m, x, w: m.conv2d(x, w, stride=2, padding=1,
                                                groups=1, policy="lax"),
    "policy_positional": lambda m, x, w: m.conv2d(x, w, "lax", stride=(2, 1),
                                                  dilation=2),
    "legacy_stride_padding": lambda m, x, w: m.conv2d(x, w, 2, 1),
    "legacy_groups": lambda m, x, w: m.conv2d(x, w, 2, 1, None, 1),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_conv2d_call_surfaces_match_jax(name):
    r = np.random.RandomState(5)
    x = r.randn(2, 3, 9, 9).astype(np.float32)
    w = r.randn(4, 3, 3, 3).astype(np.float32)
    _both(CALLS[name], x, w)


def test_conv2d_deprecated_mode_warns_like_jax():
    r = np.random.RandomState(6)
    x = r.randn(1, 2, 8, 8).astype(np.float32)
    w = r.randn(3, 2, 3, 3).astype(np.float32)
    for call in (lambda m, x, w: m.conv2d(x, w, 2, 1, "lax"),
                 lambda m, x, w: m.conv2d(x, w, stride=2, mode="pallas")):
        with pytest.warns(DeprecationWarning, match="mode=.* is deprecated"):
            _both(call, x, w)


@pytest.mark.parametrize("call", [
    lambda m, S, x, w: m.conv2d(x, w, S(), spec=S()),
    lambda m, S, x, w: m.conv2d(x, w, S(), "lax", policy="lax"),
    lambda m, S, x, w: m.conv2d(x, w, S(), "lax", "lax"),
    lambda m, S, x, w: m.conv2d(x, w, "lax", "bp_phase"),
    lambda m, S, x, w: m.conv2d(x, w, 1, 0, "lax", 1, 9),
    lambda m, S, x, w: m.conv2d(x, w, 2, stride=2),
    lambda m, S, x, w: m.conv2d(x, w, 1, 0, "lax", mode="lax"),
    lambda m, S, x, w: m.conv2d(x, w, mode="lax", policy="lax"),
    lambda m, S, x, w: m.conv2d(x, w, S.make(stride=2), stride=2),
    lambda m, S, x, w: m.conv2d(x, w, bogus=1),
], ids=["spec_twice", "policy_twice", "after_spec", "after_policy",
        "too_many", "stride_twice", "mode_twice", "mode_and_policy",
        "geometry_twice", "unknown_kwarg"])
def test_conv2d_call_errors_match_jax(call):
    x, w = np.zeros((1, 2, 6, 6), np.float32), np.zeros((2, 2, 3, 3),
                                                         np.float32)
    with pytest.raises(TypeError) as want:
        call(jconv, JSpec, jnp.asarray(x), jnp.asarray(w))
    with pytest.raises(TypeError) as got:
        call(tconv, ConvSpec, torch.from_numpy(x), torch.from_numpy(w))
    assert str(got.value) == str(want.value)


def test_conv2d_transpose_call_surfaces_match_jax():
    from repro.core.convspec import ConvTransposeSpec as JTSpec
    from repro_torch.core.convspec import ConvTransposeSpec
    r = np.random.RandomState(7)
    x = r.randn(2, 3, 5, 5).astype(np.float32)
    w = r.randn(3, 4, 3, 3).astype(np.float32)
    kw = dict(stride=2, padding=1, output_padding=1)
    calls = [
        lambda m, x, w: m.conv2d_transpose(
            x, w, (JTSpec if m is jconv else ConvTransposeSpec).make(**kw),
            "lax"),
        lambda m, x, w: m.conv2d_transpose(x, w, policy="lax", **kw),
        lambda m, x, w: m.conv2d_transpose(x, w, "lax", **kw),
    ]
    for call in calls:
        _both(call, x, w)
    errors = [
        lambda m, S, x, w: m.conv2d_transpose(x, w, S(), spec=S()),
        lambda m, S, x, w: m.conv2d_transpose(x, w, "lax", policy="lax"),
        lambda m, S, x, w: m.conv2d_transpose(x, w, S(), 2),
        lambda m, S, x, w: m.conv2d_transpose(x, w, S(), "lax", "lax"),
        lambda m, S, x, w: m.conv2d_transpose(x, w, S.make(stride=2),
                                              stride=2),
        lambda m, S, x, w: m.conv2d_transpose(x, w, mode="lax"),
    ]
    for call in errors:
        with pytest.raises(TypeError) as want:
            call(jconv, JTSpec, jnp.asarray(x), jnp.asarray(w))
        with pytest.raises(TypeError) as got:
            call(tconv, ConvTransposeSpec, torch.from_numpy(x),
                 torch.from_numpy(w))
        assert str(got.value) == str(want.value)
