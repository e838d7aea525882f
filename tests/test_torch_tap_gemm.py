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
    w = torch.zeros(1, 1, 3, 2)           # one phase, one weight slot
    with pytest.raises(ValueError, match="2 taps for 1 weight slots"):
        tg.tap_gemm_phased(src[0], w, (((0, 0, 0), (0, 1, 1)),), 3, 3)


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


#: every geometry chip_smoke.py gives the input-grad kernel: the conv
#: shapes above and the mirror convs of its transposed cases (the
#: autoencoder's decoder layers and the mirror of Table II layer 2).
PHASED_SHAPES = SMOKE_SHAPES + [
    (f"{label} T", tconv.transpose_dims(xs, ws, spec), 1)
    for label, xs, ws, spec in chip_smoke.transposed_cases(ConvTransposeSpec)]


def _phased_geometry(d, g):
    from repro_torch.kernels import ops
    pp = ops.input_grad_plan(d)
    return [len(t) for t in pp.phase_taps], d.B * pp.n_qh * pp.n_qw


@pytest.mark.parametrize("layer,d,g", PHASED_SHAPES,
                         ids=[row[0] for row in PHASED_SHAPES])
def test_phased_plan_at_every_smoke_shape(layer, d, g):
    """The input grad's plan on a 132-SM H100: the narrow tiles exactly
    where COUT <= 16 (128 x 8 for COUT <= 8), its grid within the card's
    limits, no split of the longest phase empty or under
    ``MIN_SPLIT_ROWS`` rows, one empty (zero-storing) block row per phase
    without taps and no split of it, and partials of at most splits x
    active phases x M x COUT floats a group."""
    counts, m = _phased_geometry(d, g)
    cin, cout = d.N, d.C                 # dY's channels in, dX's out
    variant, splits = tg.phased_plan(g, counts, cin, cout, m, H100_SMS)
    assert variant == ("128x8" if cout <= 8 else
                       "64x16" if cout <= 16 else "64x64")
    tile = tg.PHASED_TILES[variant]
    work, sums, slots = tg.phased_work(counts, cin, splits, tile.step)
    assert 1 <= tg._cdiv(m, tile.rows) <= tg.INT32_MAX
    assert tg._cdiv(cout, tile.cols) <= tg.GRID_YZ_MAX
    assert 1 <= splits and 1 <= len(work) * g <= tg.GRID_YZ_MAX
    rows = max(counts) * cin
    chunk = tg.split_chunk(rows, splits, tile.step)
    assert (splits - 1) * chunk < rows <= splits * chunk
    assert splits == 1 or chunk >= tg.MIN_SPLIT_ROWS
    active = [p for p, n in enumerate(counts) if n]
    assert [r for r in work if r[1] == r[2]] == [
        (p, 0, 0, -1) for p, n in enumerate(counts) if not n]
    for p in active:                   # each phase's rows, cut in order
        mine = sorted(r[1:3] for r in work if r[0] == p)
        assert mine[0][0] == 0 and mine[-1][1] == counts[p] * cin
        assert all(a[1] == b[0] for a, b in zip(mine, mine[1:]))
        assert all(e - b <= chunk for b, e in mine)
    assert sorted(s for r in work for s in [r[3]] if s >= 0) == list(
        range(slots))
    assert sum(n for _, _, n in sums) == slots
    assert 4 * slots * g * m * cout <= 4 * splits * len(active) * m * cout * g


def test_phased_plan_splits_the_one_phase_of_table2_1x1_layers():
    """Table II layers 3 and 5 (1x1, stride 2) have one active phase of
    four: it alone splits (5 and 16 partial planes, against the 20 and 64
    of splitting every phase as many ways), and the three inactive phases
    are one zero-storing block row each; layer 1 (COUT 3) fills the card
    without a split on the 128 x 8 tile.  Layers 2 and 4 count each
    phase's own chunks: their 1/2/2/4-tap phases split 2 and 8 ways where
    a full split of every phase would allow 1 and 4."""
    layers = [paper_cnn.dims(layer) for layer in paper_cnn.TABLE2_LAYERS]
    plans = []
    for d in layers:
        counts, m = _phased_geometry(d, 1)
        variant, splits = tg.phased_plan(1, counts, d.N, d.C, m, H100_SMS)
        work, sums, slots = tg.phased_work(counts, d.N, splits,
                                           tg.PHASED_TILES[variant].step)
        plans.append((variant, splits, slots, len(work)))
    assert plans[0] == ("128x8", 1, 0, 4)
    assert plans[1] == ("64x64", 2, 2, 5)
    assert plans[2] == ("64x64", 5, 5, 5 + 3)
    assert plans[3] == ("64x64", 8, 18, 18)
    assert plans[4] == ("64x64", 16, 16, 16 + 3)


def test_phased_work_orders_long_chunks_first_and_zero_phases_last():
    work, sums, slots = tg.phased_work((1, 2, 2, 4), 64, 2, 16)
    assert work == ((1, 0, 128, -1), (2, 0, 128, -1), (3, 0, 128, 0),
                    (3, 128, 256, 1), (0, 0, 64, -1))
    assert sums == ((3, 0, 2),) and slots == 2
    work, sums, slots = tg.phased_work((0, 3, 0), 5, 1, 16)
    assert work == ((1, 0, 15, -1), (0, 0, 0, -1), (2, 0, 0, -1))
    assert sums == () and slots == 0
    assert tg.phased_work((0, 0), 8, 1, 16) == (
        ((0, 0, 0, -1), (1, 0, 0, -1)), (), 0)


def _stack_before(w, d, groups):
    """The weight stack as ``input_grad_operands`` built it before it wrote
    one preallocated tensor: per phase a gather out of ``rot180(w)``, a
    permute, a pad to ``t_max``, zeros for an inactive phase, then a
    stack."""
    import torch.nn.functional as F

    from repro_torch.core.im2col_ref import rot180
    from repro_torch.kernels import ops
    pp = ops.input_grad_plan(d)
    wf = rot180(w).reshape(groups, d.N, d.C, d.k_taps_h, d.k_taps_w)
    blocks = []
    for spec in pp.phase_specs:
        if spec is None:
            blocks.append(wf.new_zeros((groups, pp.t_max, d.N, d.C)))
            continue
        rows, cols = spec
        wk = wf[:, :, :, list(rows)][:, :, :, :, list(cols)]
        wk = wk.permute(0, 3, 4, 1, 2).reshape(groups, len(rows) * len(cols),
                                               d.N, d.C)
        blocks.append(F.pad(wk, (0, 0, 0, 0, 0, pp.t_max - wk.shape[1])))
    return torch.stack(blocks, dim=1).contiguous()


#: dilated, asymmetric-stride and grouped geometries beside the smoke
#: shapes: (label, per-group dims, groups).
OPERAND_EXTRA = [
    ("d2 s2", ConvDims(B=1, C=2, H_i=11, W_i=11, N=3, K_h=5, K_w=5, S=2,
                       P_h=2, P_w=2, D_h=2, D_w=2), 1),
    ("s2x3", ConvDims(B=1, C=3, H_i=10, W_i=12, N=4, K_h=3, K_w=3, S=2,
                      S_w=3, P_h=1, P_w=1), 1),
    ("s3 k2 empty phases", ConvDims(B=1, C=6, H_i=10, W_i=10, N=10, K_h=2,
                                    K_w=2, S=3), 1),
    ("g2 s3", ConvDims(B=2, C=4, H_i=12, W_i=12, N=6, K_h=3, K_w=3, S=3,
                       P_h=1, P_w=1), 2),
]


@pytest.mark.parametrize("layer,d,g", PHASED_SHAPES + OPERAND_EXTRA,
                         ids=[row[0] for row in PHASED_SHAPES + OPERAND_EXTRA])
def test_input_grad_operands_equal_the_stacked_construction(layer, d, g):
    """The weight stack written once into one tensor equals, element for
    element, the one stacked out of per-phase gathers and zero blocks; dY
    is padded as before."""
    from repro_torch.kernels import ops
    rng = np.random.RandomState(9)
    w = torch.from_numpy(_rand(rng, d.N * g, d.C, d.k_taps_h, d.k_taps_w))
    dy = torch.from_numpy(_rand(rng, d.B, d.N * g, d.H_o, d.W_o))
    src, stack, pp = ops.input_grad_operands(dy, w, d, g)
    assert stack.is_contiguous() and src.is_contiguous()
    assert torch.equal(stack, _stack_before(w, d, g))
    want = torch.nn.functional.pad(
        dy.reshape(d.B, g, d.N, d.H_o, d.W_o).permute(1, 0, 3, 4, 2),
        (0, 0, pp.g_lo_w, 0, pp.g_lo_h, 0))
    assert torch.equal(src, want)


# ---------------------------------------------------------------------------
# The depthwise variant "dw" (one channel a group): its plan rules, and the
# wrappers under a dw plan against the JAX package's oracles
# ---------------------------------------------------------------------------

def _dw_problem(role, groups=2304, taps=4, cin=1, cout=1, b=8, oh=1, ow=512,
                dtype="bf16"):
    """A tap kernel's problem; the defaults are Mamba2-370M's conv at its
    training shape (2,304 groups of one channel, 4 taps, 8 x 512)."""
    return tg.Problem(role, groups, (taps,), cin, cout, b * oh * ow, ow,
                      dtype)


@pytest.mark.parametrize("role", ["forward", "weight_grad", "input_grad"])
@pytest.mark.parametrize("cin,cout", [(1, 1), (1, 2), (2, 1), (4, 4)])
def test_analytic_plan_takes_dw_exactly_at_one_channel_a_group(role, cin,
                                                               cout):
    """Every role, the input grad too, plans the depthwise variant exactly
    where CIN = COUT = 1; every other problem keeps its tiles.  Every
    analytic plan launches."""
    prob = _dw_problem(role, groups=64, cin=cin, cout=cout)
    plan = tg.analytic_plan(prob, H100_SMS)
    assert (plan.variant == "dw") == (cin == cout == 1)
    assert tg.plan_gap(prob, plan) is None


@pytest.mark.parametrize("taps", [1, 4, 9, 16, 17, 49, 50])
def test_dw_holds_to_its_tap_limit(taps):
    """Up to ``DW_MAX_TAPS`` (49: a 7 x 7 kernel) taps plan the depthwise
    variant; past it ``plan_gap`` refuses the variant and the analytic plan
    keeps the tiles (planning, not a fallback at run time)."""
    for role, tile in (("forward", "64x64"), ("weight_grad", "64x16")):
        prob = _dw_problem(role, groups=16, taps=taps, b=32, oh=8, ow=8,
                           dtype="f32")
        gap = tg.plan_gap(prob, tg.Plan(role, "dw", 1))
        fits = taps <= tg.DW_MAX_TAPS
        assert (gap is None) == fits, gap
        assert fits or "taps outside" in gap
        assert tg.analytic_plan(prob, H100_SMS).variant == ("dw" if fits
                                                            else tile)


@pytest.mark.parametrize("name,plan,shape,match", [
    ("tap_gemm", tg.Plan("forward", "dw", 1), (2, 1), "one channel a group"),
    ("tap_gemm", tg.Plan("forward", "dw", 1), (1, 3), "one channel a group"),
    ("tap_gemm", tg.Plan("forward", "dw", 2), (1, 1), "does not split"),
    ("tap_wgrad", tg.Plan("weight_grad", "dw", 1), (2, 2),
     "one channel a group"),
    ("tap_wgrad", tg.Plan("weight_grad", "dw", 3), (1, 1), "empty"),
    ("tap_gemm_phased", tg.Plan("input_grad", "dw", 2), (1, 1),
     "input grad does not split"),
], ids=["fwd_cin2", "fwd_cout3", "fwd_split", "wgrad_2x2", "wgrad_empty",
        "phased"])
def test_a_dw_plan_it_cannot_run_raises(name, plan, shape, match):
    """A dw plan on a problem it cannot run raises ``ValueError`` from
    ``plan_gap`` before any launch, on CPU tensors too: two or more
    channels, a split forward, a weight-grad split left empty (4 groups
    of 2 x 9 pixels: 2 float32 vectors a row, 4 vectors in all, cannot
    take 3 splits), a split input grad."""
    cin, cout = shape
    src = torch.zeros(4, 1, 2, 9, 9, cin)
    taps = [(0, 0, 0), (0, 0, 1)]
    call = {"tap_gemm": lambda: tg.tap_gemm(
                src, torch.zeros(4, 2, cin, cout), taps, 1, 8, plan),
            "tap_wgrad": lambda: tg.tap_wgrad(
                src, torch.zeros(4, 2, 1, 8, cout), taps, 1, 8, plan),
            "tap_gemm_phased": lambda: tg.tap_gemm_phased(
                src[:, 0], torch.zeros(4, 1, 2, cin, cout), (tuple(taps),),
                1, 8, plan)}[name]
    with pytest.raises(ValueError, match=match):
        call()


def test_dw_has_no_grid_limit_at_100000_groups():
    """The depthwise variant puts the groups on the grid's x: 100,000 groups
    plan and launch unsplit (the forward, the input grad) or split (the
    weight grad), where the tiles, whose groups share the grid's z
    (65,535), are refused."""
    for role, tile in (("forward", "64x64"), ("weight_grad", "64x16"),
                       ("input_grad", "128x8")):
        for groups in (4096, 70_000, 100_000):
            prob = _dw_problem(role, groups=groups, b=2, ow=64)
            plan = tg.analytic_plan(prob, H100_SMS)
            assert plan.variant == "dw" and tg.plan_gap(prob, plan) is None
            assert tg.plan_gap(prob, tg.Plan(role, "dw", 1)) is None
            gap = tg.plan_gap(prob, tg.Plan(role, tile, 1))
            assert (gap is None) == (groups <= tg.GRID_YZ_MAX)
            assert gap is None or "grid z" in gap


#: (label, groups, B, OH, OW, dtype, splits on a 132-SM H100): Mamba2-370M's
#: conv (training and prefill), the CNN's 3 x 3 layer, ragged widths.
DW_SPLIT_CASES = [
    ("mamba2 8x512", 2304, 8, 1, 512, "bf16", 1),
    ("mamba2 1x1024", 2304, 1, 1, 1024, "bf16", 1),
    ("cnn.dw", 16, 32, 8, 8, "f32", 4),
    ("ragged 1001", 64, 2, 1, 1001, "bf16", None),
    ("ragged 100", 3, 2, 1, 100, "f32", None),
    ("one row", 1, 1, 1, 3, "f32", 1),
    ("4096 groups", 4096, 8, 1, 512, "bf16", 1),
]


@pytest.mark.parametrize("case", DW_SPLIT_CASES,
                         ids=[c[0] for c in DW_SPLIT_CASES])
def test_dw_weight_grad_splits_cover_every_pixel_once(case):
    """The depthwise weight grad's split chunks, cut as the kernel cuts
    them (``split_chunk`` of the vectors, one vector a step), cover every
    vector of every row once and leave no split empty; a split is at
    least one vector a thread; every pixel (b, oh, ow) lies in exactly
    one vector.  The CNN's 16 groups split, Mamba2's 2,304 do not."""
    label, g, b, oh, ow, dtype, want = case
    prob = _dw_problem("weight_grad", groups=g, taps=9, b=b, oh=oh, ow=ow,
                       dtype=dtype)
    splits = tg.dw_splits(prob, H100_SMS)
    assert want is None or splits == want
    assert tg.plan_gap(prob, tg.Plan("weight_grad", "dw", splits)) is None
    v = tg.DW_VEC[dtype]
    units = tg.dw_units(prob)
    assert units == b * oh * tg._cdiv(ow, v)
    chunk = tg.split_chunk(units, splits, 1)
    spans = [(s * chunk, min(units, (s + 1) * chunk)) for s in range(splits)]
    assert all(lo < hi for lo, hi in spans)
    assert [u for lo, hi in spans for u in range(lo, hi)] == list(
        range(units))
    assert splits == 1 or chunk >= tg.DW_THREADS
    pixels = [(u // tg._cdiv(ow, v), (u % tg._cdiv(ow, v)) * v + j)
              for u in range(units) for j in range(v)
              if (u % tg._cdiv(ow, v)) * v + j < ow]
    assert sorted(pixels) == [(q, x) for q in range(b * oh)
                              for x in range(ow)]


def test_candidates_time_dw_beside_the_tiles():
    """A depthwise problem's shortlist starts with the dw plan and keeps the
    role's tiles beside it (the tuner times both); a problem of more
    channels never sees dw."""
    for role, variants in (("forward", {"dw", "64x64"}),
                           ("weight_grad", {"dw", "64x64", "64x16"}),
                           ("input_grad", {"dw", "64x64", "64x16", "128x8"})):
        for groups, dtype in ((2304, "bf16"), (16, "f32")):
            prob = _dw_problem(role, groups=groups, taps=9, b=32, oh=8, ow=8,
                               dtype=dtype)
            cands = tg.candidate_plans(prob, H100_SMS)
            assert cands[0] == tg.analytic_plan(prob, H100_SMS)
            assert cands[0].variant == "dw"
            assert {c.variant for c in cands} == variants
            assert all(tg.plan_gap(prob, c) is None for c in cands)
        wide = _dw_problem(role, cin=4, cout=4)
        assert "dw" not in {c.variant
                            for c in tg.candidate_plans(wide, H100_SMS)}


#: depthwise geometries for the wrappers under a dw plan: (label, P, B, Hs,
#: Ws, oh, ow, taps) -- Mamba2's 4-tap causal conv on an H = 1 plane, a
#: stride-2 3 x 3 (taps on 4 phase planes), a 3 x 3 on odd widths.
DW_JAX_CASES = [
    ("mamba2", 1, 2, 1, 35, 1, 32, [(0, 0, dv) for dv in range(4)]),
    ("s2 3x3", 4, 2, 5, 5, 4, 4, [((kh % 2) * 2 + kw % 2, kh // 2, kw // 2)
                                  for kh in range(3) for kw in range(3)]),
    ("3x3 odd", 1, 1, 8, 9, 6, 7, [(0, du, dv) for du in range(3)
                                   for dv in range(3)]),
]


@pytest.mark.parametrize("case", DW_JAX_CASES,
                         ids=[c[0] for c in DW_JAX_CASES])
def test_dw_plans_on_cpu_match_the_jax_kernels(case):
    """Three groups of one channel through the wrappers under a dw plan on
    CPU tensors (the plain versions: a CPU tensor takes no kernel) against
    the JAX package's oracles of its ``tap_gemm`` and ``tap_wgrad``
    kernels, group by group (f32, 1e-5); no launch is counted."""
    label, p, b, hs, ws, oh, ow, taps = case
    rng = np.random.RandomState(11)
    g = 3
    src, w = _rand(rng, g, p, b, hs, ws, 1), _rand(rng, g, len(taps), 1, 1)
    dy = _rand(rng, g, b, oh, ow, 1)
    tg.reset_launch_counts()
    y = tg.tap_gemm(torch.from_numpy(src), torch.from_numpy(w), taps, oh, ow,
                    tg.Plan("forward", "dw", 1))
    dw = tg.tap_wgrad(torch.from_numpy(src), torch.from_numpy(dy), taps, oh,
                      ow, tg.Plan("weight_grad", "dw", 1))
    for k in range(g):
        want_y = jref.tap_gemm_ref(jnp.asarray(src[k]), jnp.asarray(w[k]),
                                   taps, oh, ow)
        want_dw = jref.tap_wgrad_ref(jnp.asarray(src[k]),
                                     jnp.asarray(dy[k]), taps, oh, ow)
        np.testing.assert_allclose(y[k].numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(dw[k].numpy(), np.asarray(want_dw), **TOL)
    assert not any(tg.launch_counts().values())
    assert tg.variant_launch_counts() == {}


# ---------------------------------------------------------------------------
# The depthwise variant "dw" of the input grad: its tap table, its limits,
# and conv2d under pallas at the depthwise geometries against JAX
# ---------------------------------------------------------------------------

#: depthwise convs (one channel a group) and the taps of their input
#: grad's phases: (label, x shape, w shape, ConvSpec kwargs, taps a
#: phase).  Mamba2's causal conv (4 taps on an H = 1 plane, left pad 3),
#: the CNN's cnn.dw, a 3 x 3 at stride 2, a 7 x 7 at stride 2 (49 taps
#: over 4 phases: the table's capacity), a (2, 3) stride with dilation 2
#: (three phases without taps) and K = 2 at stride 3 (five).
DW_GRAD_GEOMS = [
    ("mamba2", (2, 6, 1, 32), (6, 1, 1, 4),
     dict(padding=((0, 0), (3, 0)), groups=6), [4]),
    ("cnn.dw", (2, 4, 8, 8), (4, 1, 3, 3),
     dict(stride=1, padding=1, groups=4), [9]),
    ("3x3 s2", (2, 3, 9, 9), (3, 1, 3, 3),
     dict(stride=2, padding=1, groups=3), [1, 2, 2, 4]),
    ("7x7 s2", (1, 2, 14, 14), (2, 1, 7, 7),
     dict(stride=2, padding=3, groups=2), [9, 12, 12, 16]),
    ("s2x3 d2", (1, 2, 13, 14), (2, 1, 3, 3),
     dict(stride=(2, 3), padding=2, dilation=2, groups=2),
     [3, 3, 3, 0, 0, 0]),
    ("k2 s3", (1, 3, 10, 10), (3, 1, 2, 2), dict(stride=3, groups=3),
     [1, 1, 0, 1, 1, 0, 0, 0, 0]),
]


def _dw_grad_dims(x_shape, w_shape, kw):
    from repro_torch.core.convspec import ConvSpec
    spec = ConvSpec.make(**kw)
    return tconv.spec_dims(x_shape, w_shape, spec), spec


@pytest.mark.parametrize("label,x_shape,w_shape,kw,counts", DW_GRAD_GEOMS,
                         ids=[c[0] for c in DW_GRAD_GEOMS])
def test_dw_phase_table_holds_the_input_grad_plans_taps(label, x_shape,
                                                        w_shape, kw, counts):
    """The host tables the depthwise input grad's entry receives: the rows
    ``(j, du, dv)`` of every phase of ``ops.input_grad_plan(d)``, phase
    after phase and in each phase's order, and ``PH + 1`` starts that cut
    them back into the phases (a phase without taps an empty range); every
    weight slot j within the stack's ``t_max``; the analytic plan is dw."""
    from repro_torch.kernels import ops
    d, spec = _dw_grad_dims(x_shape, w_shape, kw)
    pp = ops.input_grad_plan(d)
    assert [len(t) for t in pp.phase_taps] == counts
    host_rows, host_starts = tg.dw_phase_table(pp.phase_taps)
    starts = list(host_starts)
    assert len(starts) == len(pp.phase_taps) + 1 and starts[0] == 0
    assert starts[-1] == sum(counts) <= tg.DW_MAX_TAPS
    flat = list(host_rows)[:3 * starts[-1]]
    rows = [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]
    for p, taps in enumerate(pp.phase_taps):
        assert tuple(rows[starts[p]:starts[p + 1]]) == taps
    assert all(0 <= j < pp.t_max and du >= 0 and dv >= 0
               for j, du, dv in rows)
    prob = ops.problem("input_grad", d, spec.groups)
    plan = tg.analytic_plan(prob, H100_SMS)
    assert plan == tg.Plan("input_grad", "dw", 1)
    assert tg.plan_gap(prob, plan) is None


#: one input-grad problem a limit of the dw variant: (label, problem,
#: splits, the refusal's words or None where it launches).
DW_GRAD_LIMITS = [
    ("split", tg.Problem("input_grad", 64, (4,), 1, 1, 4096, 512, "bf16"), 2,
     "input grad does not split"),
    ("cout2", tg.Problem("input_grad", 64, (4,), 1, 2, 4096, 512, "bf16"), 1,
     "one channel a group"),
    ("65 phases", tg.Problem("input_grad", 4, (0,) * 64 + (1,), 1, 1, 64, 8,
                             "f32"), 1, "65 phases outside"),
    ("64 phases", tg.Problem("input_grad", 4, (0,) * 63 + (1,), 1, 1, 64, 8,
                             "f32"), 1, None),
    ("50 taps", tg.Problem("input_grad", 4, (16, 12, 12, 10), 1, 1, 98, 7,
                           "f32"), 1, "50 taps over all phases exceed"),
    ("49 taps", tg.Problem("input_grad", 4, (16, 12, 12, 9), 1, 1, 98, 7,
                           "f32"), 1, None),
    ("no taps", tg.Problem("input_grad", 4, (0, 0, 0, 0), 1, 1, 98, 7,
                           "f32"), 1, None),
    ("grid x", tg.Problem("input_grad", 2**22, (1,) * 32 + (0,) * 32, 1, 1,
                          2**20, 1024, "f32"), 1,
     "blocks exceed the grid's x"),
    ("pixels", tg.Problem("input_grad", 1, (4,), 1, 1, 2**31, 2**16, "bf16"),
     1, "32-bit pixel index"),
]


@pytest.mark.parametrize("label,prob,splits,match", DW_GRAD_LIMITS,
                         ids=[c[0] for c in DW_GRAD_LIMITS])
def test_dw_gap_holds_the_input_grads_limits(label, prob, splits, match):
    """``plan_gap`` refuses a dw input-grad plan past each of its limits
    (a split, two output channels, 65 phases, 50 taps over all phases, a
    grid past 2^31 - 1 blocks, 2^31 pixels) and takes one at each limit
    (64 phases, 49 taps in all, no taps at all: every phase stores zeros).
    Where dw is refused for a problem it could otherwise take, the analytic
    plan keeps a tile: planning, not a fallback at run time."""
    gap = tg.plan_gap(prob, tg.Plan("input_grad", "dw", splits))
    if match is None:
        assert gap is None
        assert tg.analytic_plan(prob, H100_SMS).variant == "dw"
        return
    assert gap is not None and match in gap, gap
    if splits == 1:
        assert tg.analytic_plan(prob, H100_SMS).variant != "dw"


@pytest.mark.parametrize("label,x_shape,w_shape,kw,counts", DW_GRAD_GEOMS,
                         ids=[c[0] for c in DW_GRAD_GEOMS])
def test_conv2d_pallas_at_depthwise_geometries_matches_jax_lax(
        label, x_shape, w_shape, kw, counts):
    """``conv2d`` under ``pallas`` on CPU tensors (the plain versions of the
    three tap kernels, fed by the port's lowering) at the depthwise
    geometries whose input grad plans dw on the card, forward and both
    grads against the JAX package's ``conv2d`` under ``lax`` on the same
    numpy-seeded inputs (f32, 1e-4)."""
    import jax

    from repro.core import conv as jconv
    from repro.core.convspec import ConvSpec as JSpec
    d, spec = _dw_grad_dims(x_shape, w_shape, kw)
    rng = np.random.RandomState(21)
    x, w = _rand(rng, *x_shape), _rand(rng, *w_shape)
    dy = _rand(rng, d.B, d.N * spec.groups, d.H_o, d.W_o)
    y, vjp = jax.vjp(lambda a, b: jconv.conv2d(a, b, JSpec.make(**kw), "lax"),
                     jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    tconv.reset_dispatch_events()
    got = tconv.conv2d(xt, wt, spec, "pallas")
    got.backward(torch.from_numpy(dy))
    assert tconv.dispatch_events() == {"forward:pallas": 1,
                                       "input_grad:pallas": 1,
                                       "weight_grad:pallas": 1}
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw),
                               rtol=1e-4, atol=1e-4)
