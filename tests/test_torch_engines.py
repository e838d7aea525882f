"""The port's baseline engines against the JAX package on the CPU: the
BP-im2col address maps (Algorithms 1 and 2) and the sparsity and traffic
accounting (exactly equal), the explicit and implicit GEMMs and the
``matmul`` kernel's plain path (1e-4 relative, bf16 5e-2), ``conv2d``
under ``traditional`` and ``bp_im2col`` (grouped included), and 20
training steps of the CNN under ``traditional``.

"Relative" is max |port - jax| <= tol * max |jax| over the tensor: the
two packages sum in different orders, and an element that cancels to near
zero carries the rounding of terms far larger than itself."""

import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import paper_cnn as jpaper  # noqa: E402
from repro.core import bpim2col as jbp  # noqa: E402
from repro.core import conv as jconv  # noqa: E402
from repro.core import im2col_ref as jref  # noqa: E402
from repro.core.convspec import ConvSpec as JSpec  # noqa: E402
from repro.kernels.matmul import matmul as jmatmul  # noqa: E402

from repro_torch.core import bpim2col as tbp  # noqa: E402
from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.core import im2col_ref as tref  # noqa: E402
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.kernels import matmul as tmm  # noqa: E402
from repro_torch.kernels import ref as tkref  # noqa: E402
from repro_torch.kernels import tap_gemm as ttg  # noqa: E402
from repro_torch.kernels.matmul import matmul  # noqa: E402
from repro_torch.train import cnn_bp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-4


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * max(np.abs(want).max(), 1e-6), err


def _pair(jd):
    """The same ConvDims in both packages."""
    import dataclasses
    return tref.ConvDims(**dataclasses.asdict(jd)), jd


# Small geometries covering strides 1-3, asymmetric strides and padding,
# a tiling remainder, 1x1 kernels and a stride larger than the kernel.
SMALL = [
    dict(B=2, C=3, H_i=9, W_i=9, N=4, K_h=3, K_w=3, S=2, P_h=1, P_w=1),
    dict(B=1, C=2, H_i=12, W_i=12, N=3, K_h=3, K_w=3, S=3, P_h=1, P_w=1),
    dict(B=2, C=2, H_i=8, W_i=8, N=3, K_h=1, K_w=1, S=2),
    dict(B=1, C=3, H_i=10, W_i=12, N=4, K_h=3, K_w=3, S=2, S_w=3, P_h=1,
         P_w=1),
    dict(B=2, C=3, H_i=9, W_i=10, N=2, K_h=3, K_w=3, S=2, P_h=0, P_w=2,
         P_h_hi=2, P_w_hi=1),
    dict(B=2, C=3, H_i=8, W_i=8, N=4, K_h=3, K_w=3, S=1, P_h=1, P_w=1),
    dict(B=1, C=2, H_i=7, W_i=7, N=2, K_h=2, K_w=2, S=3),
]
SMALL_IDS = ["s2", "s3", "k1s2", "s2x3", "asympad", "s1", "k2s3"]


@pytest.fixture(params=SMALL, ids=SMALL_IDS)
def dims(request):
    return _pair(jref.ConvDims(**request.param))


def _data(d, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(d.B, d.C, d.H_i, d.W_i).astype(np.float32)
    w = r.randn(d.N, d.C, d.K_h, d.K_w).astype(np.float32)
    dy = r.randn(d.B, d.N, d.H_o, d.W_o).astype(np.float32)
    return x, w, dy


def test_algorithm1_and_2_equal_jax_exactly(dims):
    td, jd = dims
    rows, cols = jd.lowered_B_shape_loss()
    for t_alg, j_alg, n in (
            (tbp.algorithm1, jbp.algorithm1, rows * cols),
            (tbp.algorithm2, jbp.algorithm2, jd.N * jd.B * jd.H_o2 * jd.W_o2)):
        ok, addr = t_alg(torch.arange(n, dtype=torch.int32), td)
        jok, jaddr = j_alg(jnp.arange(n, dtype=jnp.int32), jd)
        assert addr.dtype == torch.int32
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(addr.numpy(), np.asarray(jaddr))


def test_gathers_and_zero_insertion_equal_jax_exactly(dims):
    td, jd = dims
    x, w, dy = _data(jd)
    tdy = torch.from_numpy(dy)
    np.testing.assert_array_equal(tbp.gather_lowered_B_loss(tdy, td).numpy(),
                                  np.asarray(jbp.gather_lowered_B_loss(dy, jd)))
    np.testing.assert_array_equal(tbp.gather_lowered_A_grad(tdy, td).numpy(),
                                  np.asarray(jbp.gather_lowered_A_grad(dy, jd)))
    np.testing.assert_array_equal(tref.insert_zeros_pad(tdy, td).numpy(),
                                  np.asarray(jref.zero_insert_pad(dy, jd)))
    np.testing.assert_array_equal(
        tref.insert_zeros(tdy, (td.s_h, td.s_w)).numpy(),
        np.asarray(jref.zero_insert(dy, (jd.s_h, jd.s_w))))
    np.testing.assert_array_equal(
        tref.im2col(torch.from_numpy(x), td.K_h, td.K_w, (td.s_h, td.s_w))
        .numpy(), np.asarray(jref.im2col(x, jd.K_h, jd.K_w, (jd.s_h, jd.s_w))))


def test_explicit_and_implicit_gemms_match_jax(dims):
    td, jd = dims
    x, w, dy = _data(jd)
    tx, tw, tdy = map(torch.from_numpy, (x, w, dy))
    _close(tref.conv2d_forward_explicit(tx, tw, td),
           jref.conv2d_forward_explicit(x, w, jd))
    _close(tref.input_grad_explicit(tdy, tw, td),
           jref.input_grad_explicit(dy, w, jd))
    _close(tref.weight_grad_explicit(tx, tdy, td),
           jref.weight_grad_explicit(x, dy, jd))
    _close(tbp.input_grad_implicit(tdy, tw, td),
           jbp.input_grad_implicit(dy, w, jd))
    _close(tbp.weight_grad_implicit(tx, tdy, td),
           jbp.weight_grad_implicit(x, dy, jd))


@pytest.mark.parametrize("layer", jpaper.TABLE2_LAYERS,
                         ids=lambda l: "/".join(map(str, l)))
def test_sparsity_and_traffic_equal_jax_at_table2(layer):
    jd = jpaper.dims(layer)
    td, _ = _pair(jd)
    assert tbp.lowered_sparsity_loss(td) == jbp.lowered_sparsity_loss(jd)
    assert tbp.lowered_sparsity_grad(td) == jbp.lowered_sparsity_grad(jd)
    assert tbp.bp_traffic_elems_loss(td) == jbp.bp_traffic_elems_loss(jd)
    assert tbp.bp_traffic_elems_grad(td) == jbp.bp_traffic_elems_grad(jd)
    assert tref.reorg_traffic_elems_loss(td) == \
        jref.reorg_traffic_elems_loss(jd)
    assert tref.reorg_traffic_elems_grad(td) == \
        jref.reorg_traffic_elems_grad(jd)
    for name in ("lowered_B_shape_loss", "lowered_A_shape_grad",
                 "zero_space_sparsity_loss", "zero_space_sparsity_grad"):
        assert getattr(td, name)() == getattr(jd, name)(), name


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (200, 300, 150),
                                   (128, 256, 128), (1, 7, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_jax_kernel(m, k, n, dtype):
    """The port's matmul on the CPU (its plain version) against the JAX
    package's Pallas matmul in interpret mode, at tests/test_kernels.py's
    shapes and tolerances, output in the operands' type."""
    r = np.random.RandomState(1)
    a, b = r.randn(m, k), r.randn(k, n)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jmatmul(jnp.asarray(a, jdt), jnp.asarray(b, jdt)),
                      np.float32)
    ta = torch.from_numpy(a.astype(np.float32)).to(tdt)
    tb = torch.from_numpy(b.astype(np.float32)).to(tdt)
    got = matmul(ta, tb)
    assert got.dtype == tdt and got.shape == (m, n)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * 10)


def test_matmul_batches_groups_and_output_type():
    r = np.random.RandomState(2)
    a = torch.from_numpy(r.randn(3, 5, 7).astype(np.float32))
    b = torch.from_numpy(r.randn(3, 7, 4).astype(np.float32))
    got = matmul(a, b)
    for g in range(3):
        _close(got[g], (a[g] @ b[g]).numpy())
    assert matmul(a, b, out_dtype=torch.bfloat16).dtype == torch.bfloat16
    torch.testing.assert_close(tkref.matmul_ref(a, b), got)
    with pytest.raises(ValueError, match="disagree"):
        matmul(a, b[:, :6])
    with pytest.raises(ValueError, match="both be 2-D or both 3-D"):
        matmul(a, b[0])


def _smoke_gemms():
    """Every GEMM chip_smoke.py gives ``matmul``: both baseline engines' at
    Table II and the CNN, the autoencoder's under ``traditional``, and the
    bf16 case, as ``(label, (G, M, K, N))``."""
    from repro_torch.configs import paper_cnn
    from repro_torch.core.convspec import ConvTransposeSpec
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    shapes = ([("/".join(map(str, layer)), paper_cnn.dims(layer), 1, True)
               for layer in paper_cnn.TABLE2_LAYERS]
              + chip_smoke.cnn_shapes(tref.ConvDims))
    ae = chip_smoke.ae_shapes(tref.ConvDims, tconv, ConvTransposeSpec)
    return [(f"{layer} {gemm}", gmkn) for layer, gemm, gmkn, _, _ in
            chip_smoke.matmul_cases(torch, tconv, shapes, ae)]


SMOKE_GEMMS = _smoke_gemms()
H100_SMS = 132


@pytest.mark.parametrize("gmkn", [g for _, g in SMOKE_GEMMS],
                         ids=[label for label, _ in SMOKE_GEMMS])
def test_matmul_plan_at_every_smoke_gemm(gmkn):
    """``matmul``'s plan on a 132-SM H100: the 128 x 8 tile where N <= 8
    and the 8 x 128 tile where M <= 8 (the smaller edge decides), else
    64 x 16 where N <= 16, else 64 x 64; its grid within the card's
    limits; no split empty and none under ``MIN_SPLIT_ROWS`` rows (as the
    kernel cuts them)."""
    g, m, k, n = gmkn
    variant, splits = tmm.matmul_plan(g, m, k, n, H100_SMS)
    if min(m, n) <= 8:
        assert variant == ("128x8" if n <= m else "8x128")
    else:
        assert variant == ("64x16" if n <= 16 else "64x64")
    tile = tmm.VARIANTS[variant]
    grid = {"64x64": (-(-m // 64), -(-n // 64)),
            "64x16": (-(-m // 64), -(-n // 16)), "128x8": (-(-m // 128), 1),
            "8x128": (-(-n // 128), 1)}[variant]
    assert grid[0] <= ttg.INT32_MAX and grid[1] <= ttg.GRID_YZ_MAX
    assert 1 <= splits and splits * g <= ttg.GRID_YZ_MAX
    chunk = ttg.split_chunk(k, splits, tile.step)
    assert (splits - 1) * chunk < k <= splits * chunk
    assert splits == 1 or chunk >= ttg.MIN_SPLIT_ROWS


def test_matmul_plan_gives_the_edge_of_3_and_depthwise_gemms_narrow_tiles():
    """Layer 1's and the CNN's first conv's input grads (an edge of 3) and
    the depthwise conv's GEMMs (an edge of 1) take the 128 x 8 or 8 x 128
    tile; a one-tile weight grad splits its long contraction."""
    edge = {label for label, (g, m, k, n) in SMOKE_GEMMS
            if tmm.matmul_plan(g, m, k, n, H100_SMS)[0] in ("128x8",
                                                             "8x128")}
    assert edge == {
        "224/3/64/3/2/0 input_grad traditional",
        "224/3/64/3/2/0 input_grad bp_im2col",
        "cnn.c1 16/3/16/3/2/1 input_grad traditional",
        "cnn.c1 16/3/16/3/2/1 input_grad bp_im2col",
        "cnn.dw 8/16/16/3/1/1 g16 forward",
        "cnn.dw 8/16/16/3/1/1 g16 input_grad traditional",
        "cnn.dw 8/16/16/3/1/1 g16 input_grad bp_im2col",
        "cnn.dw 8/16/16/3/1/1 g16 weight_grad",
        "ae.dec1 16->3 8->16 b16 mirror transposed forward, materialized"}
    assert tmm.matmul_plan(1, 100_352, 576, 3, H100_SMS) == ("128x8", 1)
    assert tmm.matmul_plan(1, 3, 576, 100_352, H100_SMS) == ("8x128", 1)
    variant, splits = tmm.matmul_plan(1, 27, 97_682, 64, H100_SMS)
    assert variant == "64x64" and splits > 100


# (x shape, w shape, ConvSpec.make kwargs); grouped and depthwise included.
CONVS = [
    ((2, 3, 9, 9), (4, 3, 3, 3), dict(stride=2, padding=1)),
    ((1, 2, 12, 12), (3, 2, 3, 3), dict(stride=3, padding=1)),
    ((1, 3, 10, 12), (4, 3, 3, 3), dict(stride=(2, 3), padding=1)),
    ((1, 2, 11, 11), (3, 2, 3, 3), dict(stride=2, padding=2, dilation=2)),
    ((2, 3, 9, 10), (2, 3, 3, 3), dict(stride=2, padding=((0, 2), (2, 1)))),
    ((2, 4, 9, 9), (6, 2, 3, 3), dict(stride=2, padding=1, groups=2)),
    ((2, 5, 8, 8), (5, 1, 3, 3), dict(stride=1, padding=1, groups=5)),
    ((2, 4, 8, 8), (4, 1, 3, 3), dict(stride=2, padding=1, groups=4)),
]
CONV_IDS = ["s2", "s3", "s2x3", "s2d2", "asympad", "g2s2", "dw_s1", "dw_s2"]


@pytest.mark.parametrize("policy", ["traditional", "bp_im2col"])
@pytest.mark.parametrize("case", CONVS, ids=CONV_IDS)
def test_conv2d_matches_jax_engine_of_the_same_name(case, policy):
    x_shape, w_shape, kw = case
    spec = ConvSpec.make(**kw)
    d = tconv.spec_dims(x_shape, w_shape, spec)
    r = np.random.RandomState(3)
    x = r.randn(*x_shape).astype(np.float32)
    w = r.randn(*w_shape).astype(np.float32)
    dy = r.randn(d.B, d.N * spec.groups, d.H_o, d.W_o).astype(np.float32)
    jspec = JSpec.make(**kw)

    @jax.jit
    def jax_fwd_bwd(a, b, c):
        y, vjp = jax.vjp(lambda a_, b_: jconv.conv2d(a_, b_, jspec, policy),
                         a, b)
        return (y, *vjp(c))

    want_y, want_dx, want_dw = jax_fwd_bwd(x, w, dy)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    tconv.reset_dispatch_events()
    y = tconv.conv2d(xt, wt, spec, policy)
    y.backward(torch.from_numpy(dy))
    _close(y.detach(), want_y)
    _close(xt.grad, want_dx)
    _close(wt.grad, want_dw)
    assert tconv.dispatch_events() == {
        f"{p}:{policy}": 1 for p in ("forward", "input_grad", "weight_grad")}


def test_traditional_and_bp_im2col_capability_flags_match_jax():
    for name in ("lax", "traditional", "bp_im2col", "bp_phase", "pallas"):
        t, j = tconv.ENGINES[name], jconv.ENGINES[name]
        assert (t.native_dilation, t.native_transpose, t.paper_geometry) == \
            (j.native_dilation, j.native_transpose, j.paper_geometry), name


def test_gather_map_is_int32_and_built_once_per_geometry():
    td, _ = _pair(jref.ConvDims(B=2, C=3, H_i=9, W_i=9, N=4, K_h=3, K_w=3,
                                S=2, P_h=1, P_w=1))
    tbp._gather_map.cache_clear()
    a = tbp._gather_map("loss", td, torch.device("cpu"))
    b = tbp._gather_map("loss", td, torch.device("cpu"))
    assert a is b and a.dtype == torch.int32
    assert tbp._gather_map.cache_info().misses == 1
    tbp.clear_gather_maps()
    assert tbp._gather_map.cache_info().currsize == 0


def test_cnn_losses_under_traditional_match_jax_example():
    """20 SGD steps at batch 32 from the JAX example's initialization, the
    port under traditional and bp_im2col against the JAX example under
    traditional: losses within 1e-4 (measured here: at most 1.9e-6)."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import train_cnn_bp as ex
    finally:
        sys.path.remove(str(ROOT / "examples"))
    params0 = jax.tree.map(np.asarray, ex.init_params())
    _, loss_fn = ex.make_model("traditional")
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    params = ex.init_params()
    rng = np.random.RandomState(0)
    want = []
    for _ in range(20):
        x, y = ex.synthetic_task(rng, 32)
        loss, g = grad_fn(params, x, y)
        params = jax.tree.map(lambda p, gg: p - 0.05 * gg, params, g)
        want.append(float(loss))
    for policy in ("traditional", "bp_im2col"):
        res = cnn_bp.train(policy, steps=20, batch=32, lr=0.05, device="cpu",
                           params=cnn_bp.params_from_numpy(params0, "cpu"))
        np.testing.assert_allclose(res["losses"], want, rtol=1e-4, atol=1e-4)
