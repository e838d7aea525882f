"""The port's CNN trainer against the JAX example (examples/train_cnn_bp.py)
from one initialization: the same synthetic data, and per-step losses
within 1e-4 over 20 SGD steps at batch 32.

The JAX side runs ``policy="bp_phase"``: on the installed jax its Pallas
kernels do not run and its ``pallas`` policy degrades to ``bp_phase`` at
run time, so ``bp_phase`` is the reference it can give."""

import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.train import cnn_bp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS, BATCH, LR = 20, 32, 0.05


def _jax_example():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import train_cnn_bp
    finally:
        sys.path.remove(str(ROOT / "examples"))
    return train_cnn_bp


@pytest.fixture(scope="module")
def jax_run():
    ex = _jax_example()
    params0 = jax.tree.map(np.asarray, ex.init_params())
    _, loss_fn = ex.make_model("bp_phase")
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    params = ex.init_params()
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(STEPS):
        x, y = ex.synthetic_task(rng, BATCH)
        loss, g = grad_fn(params, x, y)
        params = jax.tree.map(lambda p, gg: p - LR * gg, params, g)
        losses.append(float(loss))
    return {"params0": params0, "losses": np.array(losses), "ex": ex,
            "params": jax.tree.map(np.asarray, params)}


def test_synthetic_task_is_bit_identical(jax_run):
    ex = jax_run["ex"]
    x, y = cnn_bp.synthetic_task(np.random.RandomState(5), 8, device="cpu")
    jx, jy = ex.synthetic_task(np.random.RandomState(5), 8)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


@pytest.mark.parametrize("policy", ["pallas", "bp_phase"])
def test_losses_match_jax_example(jax_run, policy):
    params = cnn_bp.params_from_numpy(jax_run["params0"], device="cpu")
    res = cnn_bp.train(policy, steps=STEPS, batch=BATCH, lr=LR, device="cpu",
                       params=params)
    np.testing.assert_allclose(res["losses"], jax_run["losses"],
                               rtol=1e-4, atol=1e-4)
    for k in ("c1", "dw", "c2"):
        np.testing.assert_allclose(res["params"][k]["w"].detach().numpy(),
                                   jax_run["params"][k]["w"],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res["params"]["head"].detach().numpy(),
                               jax_run["params"]["head"], rtol=1e-4,
                               atol=1e-4)


def test_pallas_policy_runs_every_conv_pass_on_the_kernel_engine():
    from repro_torch.core import conv as tconv
    tconv.reset_dispatch_events()
    cnn_bp.train("pallas", steps=2, batch=4, device="cpu")
    ev = tconv.dispatch_events()
    # 3 convs per forward (2 steps + eval), dx for the 2 inner convs only.
    assert ev == {"forward:pallas": 9, "input_grad:pallas": 4,
                  "weight_grad:pallas": 6}


def test_auto_policy_keeps_the_depthwise_stride1_layer_on_bp_phase():
    from repro_torch.core import conv as tconv
    tconv.reset_dispatch_events()
    cnn_bp.train(None, steps=1, batch=4, device="cpu")
    ev = tconv.dispatch_events()
    assert ev["forward:pallas"] == 4 and ev["forward:bp_phase"] == 2
    assert ev["weight_grad:bp_phase"] == 1 and ev["weight_grad:pallas"] == 2
