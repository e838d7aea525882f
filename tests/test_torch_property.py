"""The paper's invariant as a property of the port, on the CPU: the
port's ``conv2d`` and ``conv2d_transpose`` under every policy (the tap
kernels' plain versions under ``pallas``) give the forward and both grads
of the JAX package's ``bp_phase`` at any valid geometry.

These are the port's counterparts of the JAX package's three sweeps, with
their strategies, example counts and grid:

  * ``tests/test_bpim2col.py::test_property_all_engines_match_lax``:
    square strides, kernels and paddings, 40 examples;
  * ``tests/test_per_axis_taps.py``'s ``GRID_DIMS``: per-axis strides and
    dilations, deterministic;
  * ``tests/test_per_axis_taps.py::test_property_per_axis_pallas_grads``:
    the per-axis grid drawn at random, 30 examples.

Every grid geometry and every other drawn one also runs as a transposed
conv (the same stride, padding and dilation, the kernel's in and out
channels swapped): the JAX oracles' compiles are the file's cost.  The oracle is JAX's
``bp_phase``, not its ``lax`` autodiff, which hard-crashes XLA on some
strided and dilated geometries of the grid (``test_per_axis_taps.py``
says which).  y, dx and dw agree within ``REL`` of the oracle's largest
magnitude (a re-run of these sweeps outside the suite read at most
8.3e-7 for the convs and 5.1e-7 for the transposed convs).  A sweep's
examples are drawn first and checked together, so that the oracles
compile at once.  When ``hypothesis`` is missing,
``tests/_hypothesis_stub.py`` replays a fixed sample
(``tests/conftest.py``).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import conv as jconv  # noqa: E402
from repro.core.convspec import ConvSpec as JSpec  # noqa: E402
from repro.core.convspec import ConvTransposeSpec as JTSpec  # noqa: E402
from repro.core.im2col_ref import ConvDims  # noqa: E402

from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.core.convspec import ConvSpec  # noqa: E402
from repro_torch.core.convspec import ConvTransposeSpec  # noqa: E402

#: every engine of the port, and ``auto``.
POLICIES = ("lax", "traditional", "bp_im2col", "bp_phase", "pallas", "auto")
#: the largest |port - oracle| over the oracle's largest magnitude.
REL = 1e-5
#: threads compiling the JAX oracles of a test at once.
ORACLE_THREADS = 8
#: ``tests/test_per_axis_taps.py``'s deterministic grid.
GRID_DIMS = [
    ConvDims(B=2, C=3, H_i=10, W_i=12, N=4, K_h=3, K_w=3, S=1, S_w=2,
             P_h=1, P_w=1),
    ConvDims(B=2, C=3, H_i=12, W_i=10, N=4, K_h=3, K_w=3, S=3, S_w=2,
             P_h=1, P_w=1),
    ConvDims(B=1, C=2, H_i=12, W_i=12, N=3, K_h=5, K_w=5, S=2,
             P_h=2, P_w=2, D_h=2, D_w=2),
    ConvDims(B=1, C=2, H_i=14, W_i=11, N=3, K_h=5, K_w=3, S=2, S_w=3,
             P_h=2, P_w=1, D_h=2, D_w=1),
    ConvDims(B=1, C=2, H_i=13, W_i=13, N=3, K_h=3, K_w=7, S=3, S_w=1,
             P_h=1, P_w=3, D_h=1, D_w=3),
    ConvDims(B=1, C=2, H_i=12, W_i=12, N=3, K_h=5, K_w=5, S=1,
             P_h=2, P_w=2, D_h=2, D_w=2),
]


@pytest.fixture(autouse=True)
def _one_thread():
    """torch's intra-op threads set to one for each test, restored after:
    beside other test processes, tiny convs cost far more in waking a
    pool of threads than in the ops themselves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_oracle(case):
    """(y, dx, dw) of JAX's ``bp_phase`` for ``case`` = ``(x, w, dy,
    geometry, transposed)``, compiled once a geometry."""
    x, w, dy, geometry, transposed = case
    if transposed:
        spec = JTSpec.make(**geometry)

        def conv(a, b):
            return jconv.conv2d_transpose(a, b, spec, "bp_phase")
    else:
        spec = JSpec.make(**geometry)

        def conv(a, b):
            return jconv.conv2d(a, b, spec, "bp_phase")

    def f(a, b, g):
        y, vjp = jax.vjp(conv, a, b)
        return (y, *vjp(g))
    return tuple(np.asarray(t) for t in jax.jit(f)(x, w, dy))


def _port(x, w, dy, geometry, transposed, policy):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    if transposed:
        y = tconv.conv2d_transpose(xt, wt, ConvTransposeSpec.make(
            **geometry), policy)
    else:
        y = tconv.conv2d(xt, wt, ConvSpec.make(**geometry), policy)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy))
    return y.detach().numpy(), dx.numpy(), dw.numpy()


def _cases(b, c, n, hi, wi, k_h, k_w, geometry, seed, scale=1.0,
           twin=True):
    """The conv of ``geometry`` and, with ``twin`` and where it has an
    output, its transposed twin, on data drawn from ``seed``: ``(x, w,
    dy, geometry, transposed)`` each."""
    r = np.random.RandomState(seed)
    out = []
    for transposed in (False, True)[:2 if twin else 1]:
        x = r.randn(b, n if transposed else c, hi, wi).astype(np.float32)
        w = (r.randn(n, c, k_h, k_w) * scale).astype(np.float32)
        if transposed:
            if not _transposed_fits(hi, wi, k_h, k_w, geometry):
                continue
            shape = tconv.conv_transpose_output_shape(
                x.shape, w.shape, ConvTransposeSpec.make(**geometry))
        else:
            shape = tconv.output_shape(tconv.spec_dims(
                x.shape, w.shape, ConvSpec.make(**geometry)))
        dy = r.randn(*shape).astype(np.float32)
        out.append((x, w, dy, geometry, transposed))
    return out


def _check_all(cases) -> None:
    """Every policy's y, dx and dw within ``REL`` of the oracle's, for
    every case.  The oracles compile in threads (XLA compiles outside the
    GIL), as their compiles are most of the time."""
    assert cases
    with ThreadPoolExecutor(ORACLE_THREADS) as pool:
        wants = list(pool.map(_jax_oracle, cases))
    for (x, w, dy, geometry, transposed), want in zip(cases, wants):
        for policy in POLICIES:
            got = _port(x, w, dy, geometry, transposed, policy)
            for name, a, b in zip(("y", "dx", "dw"), got, want):
                assert a.shape == b.shape, (policy, name, a.shape, b.shape)
                err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
                assert err <= REL, (policy, name, geometry, transposed,
                                    x.shape, w.shape, err)


def _draw(max_examples: int, **strategies) -> list[dict]:
    """The examples ``hypothesis`` (or its stub) draws from
    ``strategies``, ``max_examples`` of them, recorded to be checked
    together."""
    drawn = []

    @settings(max_examples=max_examples, deadline=None, database=None)
    @given(**strategies)
    def record(**kw):
        drawn.append(kw)
    record()
    return drawn


def _transposed_fits(hi, wi, k_h, k_w, geometry) -> bool:
    """Whether the transposed conv of ``geometry`` has an output."""
    s = geometry.get("stride", 1)
    s_h, s_w = (s, s) if isinstance(s, int) else s
    dil = geometry.get("dilation", 1)
    d_h, d_w = (dil, dil) if isinstance(dil, int) else dil
    p = geometry.get("padding", 0)
    p_h, p_w = (p, p) if isinstance(p, int) else p
    return ((hi - 1) * s_h - 2 * p_h + (k_h - 1) * d_h + 1 >= 1
            and (wi - 1) * s_w - 2 * p_w + (k_w - 1) * d_w + 1 >= 1
            and p_h <= (k_h - 1) * d_h and p_w <= (k_w - 1) * d_w)


def _square(hi, k, s, b, c, n, p, seed, twin=True) -> list:
    """``test_bpim2col.py``'s filter of a draw, then its cases."""
    if p > k - 1 or hi + 2 * p < k:
        return []
    d = ConvDims(B=b, C=c, H_i=hi, W_i=hi, N=n, K_h=k, K_w=k, S=s, P_h=p,
                 P_w=p)
    if d.H_o < 1:
        return []
    d.validate()
    return _cases(b, c, n, hi, hi, k, k, dict(stride=s, padding=p), seed,
                  twin=twin)


def test_property_every_policy_matches_bp_phase():
    """Square strides, kernels and paddings (``test_bpim2col.py``'s
    strategies, 40 examples, and filter): every policy's y, dx and dw are
    JAX ``bp_phase``'s."""
    draws = _draw(
        40, hi=st.integers(4, 14), k=st.integers(1, 4), s=st.integers(1, 3),
        b=st.integers(1, 2), c=st.integers(1, 3), n=st.integers(1, 3),
        p=st.integers(0, 2), seed=st.integers(0, 2**16))
    _check_all([case for i, kw in enumerate(draws)
                for case in _square(**kw, twin=i % 2 == 0)])


@pytest.mark.parametrize(
    "d", GRID_DIMS, ids=lambda d: f"s{d.s_h}x{d.s_w}_d{d.D_h}x{d.D_w}")
def test_per_axis_grid_matches_bp_phase(d):
    """``test_per_axis_taps.py``'s grid: per-axis strides and dilations."""
    geometry = dict(stride=(d.s_h, d.s_w), padding=(d.P_h, d.P_w),
                    dilation=(d.D_h, d.D_w))
    _check_all(_cases(d.B, d.C, d.N, d.H_i, d.W_i, d.k_taps_h, d.k_taps_w,
                      geometry, 0))


def _per_axis(hi, wi, k_h, k_w, s_h, s_w, d_h, d_w, seed,
              twin=True) -> list:
    """``test_per_axis_taps.py``'s filter of a draw, then its cases."""
    if s_h == s_w and d_h == 1 and d_w == 1:
        return []                    # square dense: the first sweep's
    keff_h, keff_w = (k_h - 1) * d_h + 1, (k_w - 1) * d_w + 1
    p_h, p_w = min(1, keff_h - 1), min(1, keff_w - 1)
    if hi + 2 * p_h < keff_h or wi + 2 * p_w < keff_w:
        return []
    geometry = dict(stride=(s_h, s_w), dilation=(d_h, d_w),
                    padding=(p_h, p_w))
    d = tconv.spec_dims((2, 2, hi, wi), (3, 2, k_h, k_w),
                        ConvSpec.make(**geometry))
    if d.H_o < 1 or d.W_o < 1:
        return []
    return _cases(2, 2, 3, hi, wi, k_h, k_w, geometry, seed, scale=0.5,
                  twin=twin)


def test_property_per_axis_matches_bp_phase():
    """The per-axis grid drawn at random (``test_per_axis_taps.py``'s
    strategies, 30 examples, and filter): every policy's y, dx and dw are
    JAX ``bp_phase``'s."""
    draws = _draw(
        30, hi=st.integers(6, 13), wi=st.integers(6, 13),
        k_h=st.integers(1, 3), k_w=st.integers(1, 3),
        s_h=st.integers(1, 3), s_w=st.integers(1, 3),
        d_h=st.integers(1, 3), d_w=st.integers(1, 3),
        seed=st.integers(0, 2**16))
    _check_all([case for i, kw in enumerate(draws)
                for case in _per_axis(**kw, twin=i % 2 == 0)])
