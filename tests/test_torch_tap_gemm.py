"""The plain versions of the three tap-GEMM kernels against the JAX
package's oracles (f32, rtol/atol 1e-5), and the CPU dispatch of the kernel
wrappers.  The CUDA kernels themselves are held against these plain versions
on a card by tests/test_torch_cuda.py."""

import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402

from repro_torch.configs import paper_cnn  # noqa: E402
from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.core.convspec import ConvTransposeSpec  # noqa: E402
from repro_torch.core.im2col_ref import ConvDims  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import tap_gemm as tg  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)

TAP_CASES = [
    # (P, B, Hs, Ws, CIN, COUT, oh, ow, taps)
    (4, 2, 6, 6, 8, 16, 5, 5, [(0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]),
    (4, 3, 6, 6, 8, 16, 5, 5, [(0, 0, 0), (1, 0, 1), (2, 1, 0)]),
    (1, 1, 9, 9, 3, 5, 7, 7, [(0, du, dv) for du in range(3)
                               for dv in range(3)]),
    (6, 2, 5, 7, 2, 3, 4, 5, [(5, 1, 2), (0, 0, 0), (3, 1, 0)]),
]


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("case", TAP_CASES, ids=lambda c: f"P{c[0]}T{len(c[-1])}")
def test_tap_gemm_plain_matches_jax_oracle(case):
    p, b, hs, ws, cin, cout, oh, ow, taps = case
    rng = np.random.RandomState(3)
    src, w = _rand(rng, p, b, hs, ws, cin), _rand(rng, len(taps), cin, cout)
    got = tref.tap_gemm_ref(torch.from_numpy(src), torch.from_numpy(w),
                            taps, oh, ow)
    want = np.asarray(jref.tap_gemm_ref(jnp.asarray(src), jnp.asarray(w),
                                        taps, oh, ow))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", TAP_CASES, ids=lambda c: f"P{c[0]}T{len(c[-1])}")
def test_tap_wgrad_plain_matches_jax_oracle(case):
    p, b, hs, ws, cin, cout, oh, ow, taps = case
    rng = np.random.RandomState(4)
    src, dy = _rand(rng, p, b, hs, ws, cin), _rand(rng, b, oh, ow, cout)
    got = tref.tap_wgrad_ref(torch.from_numpy(src), torch.from_numpy(dy),
                             taps, oh, ow)
    want = np.asarray(jref.tap_wgrad_ref(jnp.asarray(src), jnp.asarray(dy),
                                         taps, oh, ow))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


PHASED_CASES = [
    # (B, Hs, Ws, CIN, COUT, oh, ow, phase_taps, T)
    (2, 6, 6, 4, 3, 4, 4,
     (((0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)), ((0, 1, 0), (1, 1, 1)),
      ((0, 0, 1), (1, 1, 1)), ((0, 1, 1),)), 4),
    (1, 7, 5, 2, 5, 6, 4, (((0, 0, 0),), (), ((1, 1, 1), (0, 0, 0))), 2),
]


@pytest.mark.parametrize("case", PHASED_CASES, ids=["4ph", "3ph-empty"])
def test_tap_gemm_phased_plain_is_per_phase_tap_gemm(case):
    """Each phase plane equals JAX's ``tap_gemm_ref`` over that phase's
    taps and weight rows; an empty phase is zero."""
    b, hs, ws, cin, cout, oh, ow, phase_taps, t = case
    rng = np.random.RandomState(5)
    src = _rand(rng, b, hs, ws, cin)
    w = _rand(rng, len(phase_taps), t, cin, cout)
    got = tref.tap_gemm_phased_ref(torch.from_numpy(src),
                                   torch.from_numpy(w), phase_taps, oh, ow)
    assert got.shape == (len(phase_taps), b, oh, ow, cout)
    for p, taps in enumerate(phase_taps):
        if not taps:
            assert not got[p].any()
            continue
        wp = np.stack([w[p, j] for j, _, _ in taps])
        want = jref.tap_gemm_ref(jnp.asarray(src[None]), jnp.asarray(wp),
                                 [(0, du, dv) for _, du, dv in taps], oh, ow)
        np.testing.assert_allclose(got[p].numpy(), np.asarray(want), **TOL)


def test_plain_versions_zero_fill_reads_past_the_plane():
    """Windows that run past (Hs, Ws) read zeros, as the kernels mask."""
    rng = np.random.RandomState(6)
    src = torch.from_numpy(_rand(rng, 1, 1, 3, 3, 2))
    w = torch.from_numpy(_rand(rng, 1, 2, 2))
    got = tref.tap_gemm_ref(src, w, [(0, 1, 1)], 3, 3)
    want = torch.zeros(1, 3, 3, 2)
    want[:, :2, :2] = torch.einsum("bhwc,cn->bhwn", src[0, :, 1:, 1:], w[0])
    torch.testing.assert_close(got, want, **TOL)


def test_cpu_wrappers_run_the_plain_versions_per_group():
    """On CPU tensors the wrappers return the plain versions, a leading
    group dim computes each group on its own, and nothing is counted as a
    kernel launch."""
    rng = np.random.RandomState(7)
    taps = [(0, 0, 0), (1, 0, 1), (3, 1, 1)]
    src = torch.from_numpy(_rand(rng, 2, 4, 2, 5, 5, 3))
    w = torch.from_numpy(_rand(rng, 2, 3, 3, 4))
    dy = torch.from_numpy(_rand(rng, 2, 2, 4, 4, 4))
    tg.reset_launch_counts()
    y = tg.tap_gemm(src, w, taps, 4, 4)
    dw = tg.tap_wgrad(src, dy, taps, 4, 4)
    for g in range(2):
        torch.testing.assert_close(y[g], tref.tap_gemm_ref(src[g], w[g], taps,
                                                           4, 4), **TOL)
        torch.testing.assert_close(dw[g], tg.tap_wgrad(src[g], dy[g], taps,
                                                       4, 4), **TOL)
    ph_taps = (((0, 0, 0), (1, 1, 1)), ())
    wp = torch.from_numpy(_rand(rng, 2, 2, 2, 3, 4))
    out = tg.tap_gemm_phased(src[:, 0], wp, ph_taps, 3, 3)
    assert out.shape == (2, 2, 2, 3, 3, 4) and not out[:, 1].any()
    assert tg.launch_counts() == {"tap_gemm": 0, "tap_gemm_phased": 0,
                                  "tap_wgrad": 0}


def test_wrappers_reject_bad_tap_tables():
    src = torch.zeros(2, 1, 4, 4, 3)
    with pytest.raises(ValueError, match="bad tap"):
        tg.tap_gemm(src, torch.zeros(1, 3, 2), [(2, 0, 0)], 3, 3)
    with pytest.raises(ValueError, match="disagree"):
        tg.tap_gemm(src, torch.zeros(2, 3, 2), [(0, 0, 0)], 3, 3)


def test_wgrad_split_factor_covers_both_ends_of_the_contraction():
    """Few output tiles and a long contraction split; many tiles or a
    short contraction do not (the TABLE2 extremes on a 132-SM card)."""
    # 224/3->64 K3: 9 taps x 1 tile, contraction 2*111*111 = 24642.
    assert tg.wgrad_splits(9, 24642, 132) == 30
    # 14/1024->2048 K1: 16*32 tiles, contraction 2*7*7 = 98.
    assert tg.wgrad_splits(512, 98, 132) == 1
    assert tg.wgrad_splits(1, 100, 132) == 1
    # matmul: the layer-1 weight grad (27 x 97,682) @ (97,682 x 64) is one
    # tile; splits and groups share the grid's z limit.
    assert tg.wgrad_splits(1, 97682, 132) == 264
    assert tg.wgrad_splits(1, 97682, 132, groups=65535) == 1


def test_forward_split_counts_at_the_paper_and_cnn_shapes():
    """The forward's split-K factor on a 132-SM H100 (64 x 64 output tiles,
    contraction over taps x CIN): Table II layers 1-5 split (1, 3, 1, 9, 4),
    filling layer 4's 28 tiles and layer 5's 64 to over 250 blocks; the
    example CNN's three convs (batch 32) split none."""
    from repro_torch.configs import paper_cnn
    from repro_torch.core.im2col_ref import ConvDims

    def splits(d, groups=1):
        return tg.forward_splits(d.B * d.H_o * d.W_o, d.N,
                                 d.k_taps_h * d.k_taps_w, d.C, 132, groups)

    assert [splits(paper_cnn.dims(layer))
            for layer in paper_cnn.TABLE2_LAYERS] == [1, 3, 1, 9, 4]
    cnn = [(ConvDims(B=32, C=3, H_i=16, W_i=16, N=16, K_h=3, K_w=3, S=2,
                     P_h=1, P_w=1), 1),
           (ConvDims(B=32, C=1, H_i=8, W_i=8, N=1, K_h=3, K_w=3, S=1,
                     P_h=1, P_w=1), 16),
           (ConvDims(B=32, C=16, H_i=8, W_i=8, N=32, K_h=3, K_w=3, S=2,
                     P_h=1, P_w=1), 1)]
    assert [splits(d, g) for d, g in cnn] == [1, 1, 1]


def test_cpu_forward_at_a_split_shape_is_the_plain_version():
    """A shape the card would split 3 ways: on CPU tensors the wrapper
    returns the plain version itself (equal to JAX's oracle) and counts no
    launch."""
    rng = np.random.RandomState(8)
    taps = [(p, du, dv) for p in range(4) for du in range(2)
            for dv in range(2)][:9]
    src, w = _rand(rng, 4, 1, 5, 5, 64), _rand(rng, len(taps), 64, 8)
    assert tg.forward_splits(16, 8, len(taps), 64, 132) == 3
    tg.reset_launch_counts()
    got = tg.tap_gemm(torch.from_numpy(src), torch.from_numpy(w), taps, 4, 4)
    assert torch.equal(got, tref.tap_gemm_ref(torch.from_numpy(src),
                                              torch.from_numpy(w), taps, 4,
                                              4))
    want = np.asarray(jref.tap_gemm_ref(jnp.asarray(src), jnp.asarray(w),
                                        taps, 4, 4))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert tg.launch_counts() == {"tap_gemm": 0, "tap_gemm_phased": 0,
                                  "tap_wgrad": 0}


#: every conv shape chip_smoke.py gives the tap kernels: Table II (batch
#: 2), the example CNN's convs and the autoencoder's (with the mirror
#: convs of its decoder layers), as ``(label, per-group dims, groups)``.
SMOKE_SHAPES = [
    row[:3] for row in
    [("/".join(map(str, layer)), paper_cnn.dims(layer), 1, True)
     for layer in paper_cnn.TABLE2_LAYERS]
    + chip_smoke.cnn_shapes(ConvDims)
    + chip_smoke.ae_shapes(ConvDims, tconv, ConvTransposeSpec)]
H100_SMS = 132


@pytest.mark.parametrize("layer,d,g", SMOKE_SHAPES,
                         ids=[row[0] for row in SMOKE_SHAPES])
def test_wgrad_plan_at_every_smoke_shape(layer, d, g):
    """The weight grad's plan on a 132-SM H100: its grid within the card's
    limits, no split empty and none under ``MIN_SPLIT_ROWS`` rows (as the
    kernel cuts them), and the 64 x 16 tile exactly where COUT <= 16."""
    t, rows = d.k_taps_h * d.k_taps_w, d.B * d.H_o * d.W_o
    variant, splits = tg.wgrad_plan(g, t, d.C, d.N, rows, H100_SMS)
    assert variant == ("64x16" if d.N <= 16 else "64x64")
    tile = tg.WGRAD_TILES[variant]
    grid_x = tg._cdiv(t * d.C, tile.rows) * tg._cdiv(d.N, tile.cols)
    assert 1 <= grid_x <= tg.INT32_MAX
    assert 1 <= splits and splits * g <= tg.GRID_YZ_MAX
    chunk = tg.split_chunk(rows, splits, tile.step)
    assert (splits - 1) * chunk < rows <= splits * chunk
    assert splits == 1 or chunk >= tg.MIN_SPLIT_ROWS


def test_wgrad_plan_narrows_the_edge_of_3_and_depthwise_convs():
    """The 64 x 16 tile serves the convs with 16 or 1 output channels (the
    CNN's first and depthwise convs, the autoencoder's first encoder conv
    and the mirror of its last decoder layer), and the short walks of the
    training shapes split to 64-row walks: the depthwise conv's 16 groups
    of 2,048 pixels into 32 splits each."""
    narrow = {layer.split()[0] for layer, d, g in SMOKE_SHAPES
              if tg.wgrad_plan(g, d.k_taps_h * d.k_taps_w, d.C, d.N,
                               d.B * d.H_o * d.W_o, H100_SMS)[0] == "64x16"}
    assert narrow == {"cnn.c1", "cnn.dw", "ae.enc0", "ae.dec1"}
    assert tg.wgrad_plan(16, 9, 1, 1, 32 * 8 * 8, H100_SMS) == ("64x16", 32)
    assert tg.wgrad_plan(1, 9, 16, 32, 16 * 4 * 4, H100_SMS) == ("64x64", 4)
    # Table II layer 5 (98 rows) cannot split; layer 1 splits to the cap.
    assert tg.wgrad_plan(1, 1, 1024, 2048, 98, H100_SMS) == ("64x64", 1)
    assert tg.wgrad_plan(1, 9, 3, 64, 24642, 4096)[1] <= tg.MAX_SPLITS


def test_split_count_leaves_no_split_empty_and_respects_the_grid():
    """Across contraction lengths and group counts the split count is at
    least 1, cuts no empty split, and keeps splits x groups within the
    grid's z limit."""
    tile = tg.WGRAD_TILES["64x64"]
    for rows in (0, 1, 63, 64, 65, 127, 392, 1000, 24642, 10**6):
        for groups in (1, 16, 4096, tg.GRID_YZ_MAX):
            s = tg.split_count(tile, groups, rows, H100_SMS, groups)
            assert s >= 1 and s * groups <= tg.GRID_YZ_MAX
            chunk = tg.split_chunk(rows, s, tile.step)
            assert s == 1 or (s - 1) * chunk < rows
