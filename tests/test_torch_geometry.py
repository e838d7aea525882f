"""The port's geometry and planner equal the JAX package's exactly:
ConvDims properties, forward tap tables, the fused input-grad phase plan,
and the phase split (with its round trip)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import paper_cnn as jax_paper  # noqa: E402
from repro.core import im2col_ref as jref  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch.configs import paper_cnn  # noqa: E402
from repro_torch.core import im2col_ref as tref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

_D = jref.ConvDims
CASES = [
    # tests/test_kernels.py CONV_CASES
    _D(B=2, C=3, H_i=8, W_i=8, N=4, K_h=3, K_w=3, S=2, P_h=1, P_w=1),
    _D(B=1, C=2, H_i=9, W_i=9, N=3, K_h=3, K_w=3, S=2, P_h=0, P_w=0),
    _D(B=1, C=2, H_i=8, W_i=8, N=3, K_h=1, K_w=1, S=2, P_h=0, P_w=0),
    _D(B=2, C=2, H_i=12, W_i=12, N=3, K_h=3, K_w=3, S=3, P_h=1, P_w=1),
    _D(B=1, C=3, H_i=8, W_i=8, N=4, K_h=3, K_w=3, S=1, P_h=1, P_w=1),
    _D(B=1, C=130, H_i=6, W_i=6, N=140, K_h=3, K_w=3, S=2, P_h=1, P_w=1),
    _D(B=1, C=3, H_i=10, W_i=12, N=4, K_h=3, K_w=3, S=2, S_w=3, P_h=1, P_w=1),
    _D(B=2, C=2, H_i=9, W_i=12, N=3, K_h=3, K_w=3, S=1, S_w=2, P_h=0, P_w=1),
    # dilated (effective 5x5 = 3 taps at dilation 2), stride 2
    _D(B=1, C=2, H_i=11, W_i=11, N=3, K_h=5, K_w=5, S=2, P_h=2, P_w=2,
       D_h=2, D_w=2),
    # dilation on one axis, stride 3 on the other
    _D(B=1, C=2, H_i=13, W_i=10, N=2, K_h=7, K_w=3, S=1, S_w=3, P_h=3,
       P_w=1, D_h=3),
    # asymmetric padding
    _D(B=2, C=3, H_i=9, W_i=10, N=2, K_h=3, K_w=3, S=2, P_h=0, P_w=2,
       P_h_hi=2, P_w_hi=1),
    _D(B=1, C=2, H_i=7, W_i=7, N=2, K_h=4, K_w=2, S=3, P_h=3, P_w=0,
       P_h_hi=0, P_w_hi=1),
] + jax_paper.table2_dims()

IDS = [f"H{d.H_i}x{d.W_i}K{d.K_h}x{d.K_w}S{d.s_h}x{d.s_w}"
       f"P{d.P_h},{d.p_h_hi},{d.P_w},{d.p_w_hi}D{d.D_h}x{d.D_w}C{d.C}N{d.N}"
       for d in CASES]

PROPS = ("s_h", "s_w", "k_taps_h", "k_taps_w", "has_dilation", "p_h_hi",
         "p_w_hi", "H_o", "W_o", "H_o2", "W_o2", "H_o3", "W_o3", "R_h", "R_w")


def _port(d):
    return tref.ConvDims(**dataclasses.asdict(d))


def _valid(d, exc):
    try:
        d.validate()
    except exc:
        return False
    return True


@pytest.mark.parametrize("d", CASES, ids=IDS)
def test_convdims_properties_equal(d):
    t = _port(d)
    assert {p: getattr(t, p) for p in PROPS} == \
        {p: getattr(d, p) for p in PROPS}
    assert _valid(t, ValueError) == _valid(d, AssertionError)


@pytest.mark.parametrize("d", CASES, ids=IDS)
def test_forward_taps_equal(d):
    assert tops._forward_taps(_port(d)) == jops._forward_taps(d)


@pytest.mark.parametrize("d", CASES, ids=IDS)
def test_input_grad_geometry_equal(d):
    """The whole fused-phase tuple (n_q*, g_lo_*, t_max, phase_specs,
    phase_taps, halos) -- JAX's without its TPU channel padding."""
    got = tops._input_grad_geom(tops._canonical(_port(d)))
    want = jops._input_grad_geom(jops._canonical(d))
    assert got == tuple(want[2:])
    pp = tops.input_grad_plan(_port(d))
    assert (pp.t_max, pp.phase_taps, pp.phase_specs) == \
        (want[6], want[8], want[7])


@pytest.mark.parametrize("d", CASES, ids=IDS)
def test_plan_report_tap_counts_equal(d):
    got = tops.plan_report(_port(d))
    want = jops.plan_report(d)
    assert got["kernel_taps"] == want["kernel_taps"]
    assert got["phases"] == want["phases"]
    assert got["input_grad"]["t_max"] == want["input_grad"]["t_max"]
    assert got["input_grad"]["taps_total"] == \
        want["input_grad"]["taps_total"]
    assert got["forward"]["halo"] == want["forward"]["halo"]
    assert got["pallas_path"]


def test_table2_layers_equal():
    assert paper_cnn.TABLE2_LAYERS == jax_paper.TABLE2_LAYERS
    assert paper_cnn.NETWORKS == jax_paper.NETWORKS
    assert [dataclasses.asdict(d) for d in paper_cnn.table2_dims()] == \
        [dataclasses.asdict(d) for d in jax_paper.table2_dims()]


@pytest.mark.parametrize("s", [(1, 1), (2, 2), (3, 3), (2, 3), (1, 2)])
@pytest.mark.parametrize("hw", [(8, 8), (9, 7), (5, 11)])
def test_phase_split_equal_and_round_trips(s, hw):
    x = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    got = tops._phase_split(torch.from_numpy(x), s)
    want = np.asarray(jops._phase_split(x, s))
    np.testing.assert_array_equal(got.numpy(), want)
    back = tops._phase_unsplit(got, s, *hw)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jops._phase_unsplit(want, s, *hw)))
    # A leading group dim splits each group on its own.
    xg = torch.from_numpy(np.stack([x, 2 * x]))
    gs = tops._phase_split(xg, s)
    np.testing.assert_array_equal(gs[1].numpy(), 2 * want)
    np.testing.assert_array_equal(tops._phase_unsplit(gs, s, *hw).numpy(),
                                  xg.numpy())
