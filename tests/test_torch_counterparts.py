"""The last of the JAX package's surfaces the port had no counterpart of,
held to the JAX package on the CPU:

  * ``models.attention._sdpa_local_window`` (behind ``WINDOW_SKIP =
    False``, as in JAX): JAX's and the port's masked attention on seeded
    numpy inputs past twice the window, and the gate;
  * the planners' ``{role}_pallas`` / ``{role}_fallback`` events
    (``kernels.ops``): the same counts as JAX's planners at their default
    budget over the Table II layers and the example CNN's geometries;
  * the config's post-import env shim: ``REPRO_SSD_CHUNK`` set after
    import is adopted with a ``DeprecationWarning`` in both packages;
  * ``models.mamba2.CHUNK``, the deprecated alias of ``ssd_chunk``.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import paper_cnn as jpaper  # noqa: E402
from repro.core.config import config as jconfig  # noqa: E402
from repro.core.im2col_ref import ConvDims as JDims  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import mamba2 as JM2  # noqa: E402

from repro_torch.configs import paper_cnn  # noqa: E402
from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.core.config import config  # noqa: E402
from repro_torch.core.im2col_ref import ConvDims  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402

TOL = 1e-5
#: (B, L, H, Hk, D, window): L past 2 W, and a length W does not divide.
WINDOW_CASES = [(2, 40, 4, 2, 16, 8), (1, 37, 2, 1, 8, 6),
                (1, 64, 3, 3, 8, 16)]


def _qkv(b, l, h, hk, dh, seed=0):
    r = np.random.RandomState(seed)
    return tuple(r.randn(b, l, n, dh).astype(np.float32)
                 for n in (h, hk, hk))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", WINDOW_CASES,
                         ids=lambda c: f"L{c[1]}W{c[5]}")
def test_local_window_matches_jax_and_the_masked_path(case):
    b, l, h, hk, dh, w = case
    q, k, v = _qkv(b, l, h, hk, dh)
    scale = dh ** -0.5
    got = A._sdpa_local_window(*map(torch.from_numpy, (q, k, v)), window=w,
                               scale=scale)
    want = JA._sdpa_local_window(*map(jnp.asarray, (q, k, v)), window=w,
                                 scale=scale)
    assert _rel(got, want) <= TOL
    masked = A._sdpa_dense(*map(torch.from_numpy, (q, k, v)), causal=True,
                           q_offset=0, kv_len=None, scale=scale, window=w)
    assert _rel(got, masked) <= TOL


def test_window_skip_is_off_and_gates_the_local_path(monkeypatch):
    """Off by default, as in JAX; on, a full causal call past twice the
    window takes the local path (and gives the masked path's values), a
    shorter one does not."""
    assert A.WINDOW_SKIP is False and JA.WINDOW_SKIP is False
    b, l, h, hk, dh, w = WINDOW_CASES[0]
    q, k, v = map(torch.from_numpy, _qkv(b, l, h, hk, dh))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    calls = []
    sound = A._sdpa_local_window

    def spy(*args, **kw):
        calls.append(args[0].shape[1])
        return sound(*args, **kw)
    monkeypatch.setattr(A, "_sdpa_local_window", spy)
    off = A._sdpa(q, k, v, causal=True, window=w)
    assert calls == []
    monkeypatch.setattr(A, "WINDOW_SKIP", True)
    on = A._sdpa(q, k, v, causal=True, window=w)
    assert calls == [l]
    assert _rel(on.detach(), off.detach()) <= TOL
    A._sdpa(q[:, :2 * w - 1], k[:, :2 * w - 1], v[:, :2 * w - 1],
            causal=True, window=w)
    assert calls == [l]


def _conv_geometries():
    """The example CNN's three convs at its batch of 32 (per group: the
    depthwise layer's 16 groups of one channel), and the Table II
    layers: ``(port dims, groups)``."""
    cnn = [(ConvDims(B=32, C=3, H_i=16, W_i=16, N=16, K_h=3, K_w=3, S=2,
                     P_h=1, P_w=1), 1),
           (ConvDims(B=32, C=1, H_i=8, W_i=8, N=1, K_h=3, K_w=3, S=1,
                     P_h=1, P_w=1), 16),
           (ConvDims(B=32, C=16, H_i=8, W_i=8, N=32, K_h=3, K_w=3, S=2,
                     P_h=1, P_w=1), 1)]
    return {"table2": [(d, 1) for d in paper_cnn.table2_dims()],
            "cnn": cnn}


@pytest.mark.parametrize("which", ["table2", "cnn"])
def test_plan_events_count_as_jax(which):
    """Each geometry's three passes resolved under ``pallas``: the
    port's planner counts one ``{role}_pallas`` (or ``_fallback``) a
    geometry, as JAX's planners do at their default budget."""
    geoms = _conv_geometries()[which]
    if which == "table2":
        assert [dataclasses.asdict(d) for d, _ in geoms] == [
            dataclasses.asdict(d) for d in jpaper.table2_dims()]
    jops.clear_tile_plan_cache()
    jops.reset_plan_events()
    ops.clear_plan_memo()
    ops.reset_plan_events()
    for d, g in geoms:
        jd = JDims(**dataclasses.asdict(d))
        jops.forward_plan(jd)
        jops.weight_grad_plan(jd)
        jops.input_grad_plan(jd)
        for role in ops.PLAN_ROLES:
            assert tconv.resolve_engine("pallas", role, d,
                                        groups=g)[0] == "pallas"
    want = jops.plan_events()
    assert ops.plan_events() == want
    assert want == {f"{r}_pallas": len(geoms) for r in ops.PLAN_ROLES}
    # Once a geometry: resolving again counts nothing.
    for d, g in geoms:
        tconv.resolve_engine("pallas", "forward", d, groups=g)
    assert ops.plan_events() == want
    jops.clear_tile_plan_cache()
    jops.reset_plan_events()


def test_a_pass_the_planner_gives_up_counts_a_fallback(monkeypatch):
    """A geometry whose kernel cannot launch: ``{role}_fallback``, and
    the resolver sends the pass down the fallback chain."""
    from repro_torch.kernels import tap_gemm as tg
    ops.clear_plan_memo()
    ops.reset_plan_events()
    monkeypatch.setattr(tg, "launch_gap", lambda *a, **k: "too wide")
    d = paper_cnn.table2_dims()[0]
    engine, reason = tconv.resolve_engine("pallas", "forward", d)
    assert engine != "pallas" and "too wide" in reason
    assert ops.plan_events() == {"forward_fallback": 1}
    ops.clear_plan_memo()


@pytest.fixture
def _chunk_env(monkeypatch):
    """``REPRO_SSD_CHUNK`` unset, both configs re-snapshotted; restored
    after."""
    monkeypatch.delenv("REPRO_SSD_CHUNK", raising=False)
    saved = (config.ssd_chunk, jconfig.ssd_chunk)
    config.update(ssd_chunk=saved[0])
    jconfig.update(ssd_chunk=saved[1])
    yield saved
    monkeypatch.delenv("REPRO_SSD_CHUNK", raising=False)
    config.update(ssd_chunk=saved[0])
    jconfig.update(ssd_chunk=saved[1])


@pytest.mark.parametrize("package", ["port", "jax"])
def test_env_set_after_import_is_adopted_with_a_warning(package,
                                                        _chunk_env,
                                                        monkeypatch):
    cfg = config if package == "port" else jconfig
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cfg.ssd_chunk == _chunk_env[0]         # no change: silent
    monkeypatch.setenv("REPRO_SSD_CHUNK", "48")
    with pytest.warns(DeprecationWarning, match="REPRO_SSD_CHUNK"):
        assert cfg.ssd_chunk == 48
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cfg.ssd_chunk == 48                     # adopted once
    cfg.update(ssd_chunk=32)                           # update() wins
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cfg.ssd_chunk == 32


def test_both_shims_agree_on_every_read(_chunk_env, monkeypatch):
    """The same env changes read through both packages: the same values
    and one warning each a change."""
    for raw in ("64", "16"):
        monkeypatch.setenv("REPRO_SSD_CHUNK", raw)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            assert config.ssd_chunk == jconfig.ssd_chunk == int(raw)
        assert [w.category for w in seen] == [DeprecationWarning] * 2


def test_mamba2_chunk_alias_is_the_config_field():
    assert M2.CHUNK == config.ssd_chunk == JM2.CHUNK == jconfig.ssd_chunk
    with config.override(ssd_chunk=64), jconfig.override(ssd_chunk=64):
        assert M2.CHUNK == JM2.CHUNK == 64
    with pytest.raises(AttributeError):
        M2.NOT_A_CONSTANT
