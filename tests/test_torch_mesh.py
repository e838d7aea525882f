"""The port's mesh-parallel conv (``repro_torch.dist.conv_parallel``) on 8
gloo ranks on the CPU, against the JAX package.

One process group runs every case (``tests/_torch_mesh_worker.py``, 8
spawned ranks, one thread each); the JAX side of each comparison runs
here on the same numpy inputs:

  * JAX's virtual-device matrix (``tests/test_conv_parallel.py``): 9
    cells of every role x {stride 1/2, dilation, transposed} on a
    ``(data=2, model=2, sw=2)`` mesh under ``auto`` and ``pallas`` (the
    kernels' plain versions here): y / dx / dw within 1e-4 of the same
    pass run unsharded (JAX's measure for its mesh, absolute) and within
    1e-4 relative of JAX's single-device ``lax`` (the port's measure for
    ``conv2d`` against JAX: at ``|dw|`` up to 72 the plain weight grad
    alone, unsharded, reads 1.0e-4 absolute against JAX's ``lax``), each
    cell with its ``mesh:conv2d...`` event, every rank holding the same
    bits; the fallback case exact with JAX's reasons;
  * the halo audit: the ``halo`` events of a forward sharded over H on 8
    ranks sum to ``(lo + hi) * B * C * W * 4`` bytes on every rank, the
    halos of JAX's HLO audit;
  * the autoencoder trained through ``make_train_step(conv_mesh=)`` on a
    ``(data=4, model=2)`` mesh under ``tp``, ``dp_only`` and ``spatial``:
    3 losses within rtol 1e-4 / atol 1e-5 of JAX's single-device step,
    parameters and moments bit-identical on every rank.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import conv as jconv  # noqa: E402
from repro.core.convspec import ConvSpec as JSpec  # noqa: E402
from repro.core.convspec import ConvTransposeSpec as JTSpec  # noqa: E402
from repro.dist import conv_parallel as jcp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _torch_mesh_worker as W  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-4
#: the 8 ranks' start, 9 x 2 matrix cells, the audit and 9 training steps
#: take ~10 s on 8 threads.
TIMEOUT_S = 240


class StubMesh:
    def __init__(self, **axes):
        self.shape = axes


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.RandomState(0)
    inputs = {"x": rng.randn(4, 8, 16, 16).astype(np.float32),
              "w": rng.randn(6, 8, 3, 3).astype(np.float32),
              "wt": rng.randn(8, 6, 3, 3).astype(np.float32),
              "x3": rng.randn(3, 8, 15, 16).astype(np.float32),
              "image": rng.randn(8, 3, 16, 16).astype(np.float32)}
    acfg = JM.AutoencoderConfig(c_in=3, widths=(16, 32), k=3,
                                conv_policy="lax")
    jparams = JM.init_autoencoder(jax.random.PRNGKey(0), acfg)
    for stage in ("enc", "dec"):
        for i, layer in enumerate(jparams[stage]):
            inputs[f"ae_{stage}_{i}"] = np.asarray(layer["w"])
    np.savez(tmp / "inputs.npz", **inputs)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_mesh_worker.py"),
         str(tmp), str(tmp)], capture_output=True, text=True, env=env,
        timeout=TIMEOUT_S, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-6000:]
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(W.WORLD)]
    arrays = dict(np.load(tmp / "arrays.npz"))
    return {"inputs": inputs, "ranks": ranks, "arrays": arrays,
            "jparams": jparams, "acfg": acfg}


def _jax_spec(kind, kw):
    return JSpec.make(**kw) if kind == "reg" else JTSpec.make(**kw)


CELLS = [(policy, cell) for policy in W.POLICIES
         for cell in W.matrix_cells(jcp)]


@pytest.mark.parametrize("policy,cell", CELLS,
                         ids=[f"{p}-{c[0]}" for p, c in CELLS])
def test_matrix_cell_matches_jax_single_device(runs, policy, cell):
    tag, wkey, kind, kw, _, want = cell
    x = jnp.asarray(runs["inputs"]["x"])
    w = jnp.asarray(runs["inputs"][wkey])
    spec = _jax_spec(kind, kw)
    conv = jconv.conv2d if kind == "reg" else jconv.conv2d_transpose

    def loss(x_, w_):
        y = conv(x_, w_, spec, "lax")
        return jnp.sum(jnp.sin(y)), y
    (_, y), (dx, dw) = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(x, w)
    key = f"{policy}|{tag}"
    for name, want_arr in (("y", y), ("dx", dx), ("dw", dw)):
        got = runs["arrays"][f"{key}|{name}"]
        one = runs["arrays"][f"{key}|{name}1"]
        want_arr = np.asarray(want_arr)
        err = np.abs(got - one).max()
        assert err < TOL, (key, name, "vs unsharded", err)
        err = np.abs(got - want_arr).max() / np.abs(want_arr).max()
        assert err < TOL, (key, name, "vs JAX", err)
    digests = {r["matrix"][key]["digest"] for r in runs["ranks"]}
    assert len(digests) == 1, digests
    for r in runs["ranks"]:
        assert want in r["matrix"][key]["events"], r["matrix"][key]


@pytest.mark.parametrize("policy", W.POLICIES)
def test_fallback_is_exact_with_jax_reasons(runs, policy):
    jplan = jcp.plan_conv_sharding(
        (3, 8, 15, 16), (6, 8, 3, 3), JSpec.make(stride=1, padding=1),
        jcp.ConvParallel(batch=("data",), h="model"),
        StubMesh(data=2, model=2, sw=2))
    want = [r for _, r in jplan.dropped]
    for r in runs["ranks"]:
        fb = r["fallback"][policy]
        assert fb["err"] == 0.0
        assert fb["events"].get("mesh:fallback") == 1, fb
        assert fb["events"].get("mesh:drop:data") == 1
        assert fb["events"].get("mesh:drop:h") == 1
        assert fb["reasons"][:2] == want
        assert fb["reasons"][2] == "; ".join(want)
    assert any("batch 3 % 2" in s for s in want)
    assert any("15 % 2 shards" in s for s in want)


@pytest.mark.parametrize("name,halo", [("k3s1", (1, 1)), ("k3s2", (1, 0)),
                                       ("k5d2s1", (2, 2))])
def test_halo_bytes_equal_tap_derived_halos(runs, name, halo):
    """Exactly ``(lo + hi) * B * C * W * 4`` bytes of ``halo`` events a
    rank per sharded forward: a stride-2 kernel sends ONE row, and a
    dilated kernel's zero taps never cross the wire."""
    kw = dict(W.HALO_CASES)[name]
    b, c, h, w = W.HALO_SHAPE
    d = jconv.spec_dims(W.HALO_SHAPE, (W.HALO_COUT, c, 3, 3),
                        JSpec.make(**kw))
    (lo, hi), _ = jops.shard_halo(d)
    assert (lo, hi) == halo
    want = (max(lo, 0) + max(hi, 0)) * b * c * w * 4
    for r in runs["ranks"]:
        assert r["halo"][name]["bytes"] == want, (r["rank"], r["halo"])
        assert r["halo"][name]["sends"] == (lo > 0) + (hi > 0)


def _jax_losses(runs):
    if "jax_losses" not in runs:
        acfg = runs["acfg"]
        step = jax.jit(JTS.make_train_step(
            acfg, jadamw.AdamWConfig(peak_lr=1e-3), total_steps=10,
            warmup=1, loss=JM.autoencoder_loss))
        p, o = runs["jparams"], jadamw.init_state(runs["jparams"])
        batch = {"image": jnp.asarray(runs["inputs"]["image"])}
        out = []
        for s in range(W.AE_STEPS):
            p, o, m = step(p, o, batch, jnp.int32(s))
            out.append(float(m["loss"]))
        runs["jax_losses"] = out
    return runs["jax_losses"]


@pytest.mark.parametrize("policy", W.AE_POLICIES)
def test_autoencoder_sharded_training_matches_jax(runs, policy):
    """The autoencoder's convs train through the sharded lowerings on a
    (4, 2) mesh, the losses those of JAX's single-device step; every rank
    ends with the same parameters and moments, bit for bit; the decoder's
    Cout 3 cannot shard over model=2 under ``tp`` and drops the role."""
    want = _jax_losses(runs)
    per_rank = [r["autoencoder"][policy] for r in runs["ranks"]]
    for got in per_rank:
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4,
                                   atol=1e-5)
    assert len({g["params"] for g in per_rank}) == 1
    assert len({g["opt"] for g in per_rank}) == 1
    ev = per_rank[0]["events"]
    assert any(k.startswith("mesh:conv2d:") for k in ev), ev
    assert any(k.startswith("mesh:conv2d_T:") for k in ev), ev
    if policy == "tp":
        assert ev.get("mesh:drop:cout"), ev
    if policy == "spatial":
        assert ev.get("mesh:conv2d:data+h") and ev.get(
            "mesh:conv2d_T:data+h"), ev
    if policy == "dp_only":
        assert set(ev) == {"mesh:conv2d:data", "mesh:conv2d_T:data"}, ev
