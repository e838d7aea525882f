"""The port's checkpoints (``repro_torch.ckpt.checkpoint``) against the JAX
package's (``repro.ckpt.checkpoint``) on the CPU: the same on-disk layout
and manifest for the same float32 tree, bit-exact round trips of float32,
bf16 and the int step count, and the failure handling -- a torn write
ignored, a corrupt leaf skipped with its reason, an explicit bad step
raising, an async failure raised again from ``wait()``.  Also the carrying
of JAX's AdamW state into the port (``tree.tree_from_numpy``)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as JCKPT  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch.ckpt import checkpoint as CKPT  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import (tree_from_numpy,  # noqa: E402,E501
                              tree_leaves)


@pytest.fixture(autouse=True)
def _clean_skips():
    CKPT.reset_skipped_checkpoints()
    yield
    CKPT.reset_skipped_checkpoints()


def _tree(seed=0):
    r = np.random.RandomState(seed)
    return {"params": {"w": r.randn(3, 4).astype(np.float32),
                       "blocks": [{"b": r.randn(5).astype(np.float32)},
                                  {"b": r.randn(5).astype(np.float32)}]},
            "opt": {"m": {"w": r.randn(3, 4).astype(np.float32)},
                    "step": np.int32(7)}}


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_manifest_equals_jax_for_the_same_float32_tree(tmp_path):
    """Names, files, shapes, dtypes and sha256 equal JAX's, the port's
    int32 step count included."""
    np_tree = _tree()
    JCKPT.save(str(tmp_path / "j"), 7, jax.tree.map(jnp.asarray, np_tree))
    tree = tree_from_numpy(np_tree, "cpu")
    tree["opt"]["step"] = torch.tensor(7, dtype=torch.int32)  # the port's
    d = CKPT.save(str(tmp_path / "t"), 7, tree)
    assert sorted(os.listdir(d)) == sorted(
        os.listdir(tmp_path / "j" / "step_00000007"))
    assert _manifest(d) == _manifest(tmp_path / "j" / "step_00000007")
    assert CKPT.latest_steps(str(tmp_path / "t")) == [7]


def test_round_trips_are_bit_exact(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {"f32": torch.randn(4, 6, generator=gen),
            "bf16": torch.randn(7, 3, generator=gen).bfloat16(),
            "int": torch.tensor(5, dtype=torch.int32),
            "opt": {"step": torch.tensor(12, dtype=torch.int32)}}
    CKPT.save(str(tmp_path), 3, tree)
    step, got = CKPT.restore(str(tmp_path), device="cpu")
    assert step == 3
    for key in ("f32", "bf16", "int"):
        assert got[key].dtype == tree[key].dtype
        assert torch.equal(got[key], tree[key])
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 12
    leaf = {x["name"]: x for x in _manifest(tmp_path / "step_00000003")
            ["leaves"]}["bf16"]
    assert leaf["dtype"] == "bfloat16" and leaf["shape"] == [7, 3]


def test_restored_tree_walks_as_the_saved_one(tmp_path):
    """Leaves are stored by sorted path; the tree helpers walk dicts in
    sorted key order too (as ``jax.tree`` does), so a restored tree gives
    its leaves, and their global norm, in the order of the tree that was
    saved, whatever order its keys were inserted in."""
    gen = torch.Generator().manual_seed(3)
    tree = {k: torch.randn(n, generator=gen) * 10 ** (n % 5)
            for k, n in zip("zmaqcx", (7, 3, 11, 5, 2, 13))}
    tree["b"] = [torch.randn(4, generator=gen), {"y": torch.ones(2),
                                                  "d": torch.zeros(3)}]
    CKPT.save(str(tmp_path), 0, tree)
    _, got = CKPT.restore(str(tmp_path), device="cpu")
    assert [t.shape for t in tree_leaves(got)] == \
        [t.shape for t in tree_leaves(tree)]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(tree)))
    assert torch.equal(adamw.global_norm(got), adamw.global_norm(tree))
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    assert all(np.array_equal(a, b.numpy()) for a, b in
               zip(jax.tree.leaves(jtree), tree_leaves(tree)))


def test_bf16_sha256_is_jax_s_for_the_same_values(tmp_path):
    vals = np.random.RandomState(1).randn(6, 5).astype(np.float32)
    JCKPT.save(str(tmp_path / "j"), 0, {"w": jnp.asarray(vals,
                                                         jnp.bfloat16)})
    CKPT.save(str(tmp_path / "t"), 0,
              {"w": torch.from_numpy(vals).bfloat16()})
    want = _manifest(tmp_path / "j" / "step_00000000")["leaves"][0]
    got = _manifest(tmp_path / "t" / "step_00000000")["leaves"][0]
    assert got == want


def test_torn_write_and_corrupt_leaf_are_skipped(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3):
        CKPT.save(d, step, {"x": torch.full((4,), float(step))}, keep=5)
    os.remove(os.path.join(d, "step_00000003", "COMMIT"))     # torn
    arr = os.path.join(d, "step_00000002", "arr_00000.npy")
    np.save(arr, np.zeros(4, np.float32))                      # corrupt
    assert CKPT.latest_steps(d) == [1, 2]
    step, got = CKPT.restore(d, device="cpu")
    assert step == 1 and torch.equal(got["x"], torch.full((4,), 1.0))
    reasons = {s["checkpoint"]: s["reason"]
               for s in CKPT.skipped_checkpoints()}
    assert "torn" in reasons["step_00000003"]
    assert "corruption" in reasons["step_00000002"]
    with pytest.raises(IOError, match="step 2 is not loadable"):
        CKPT.restore(d, step=2, device="cpu")
    assert CKPT.restore(str(tmp_path / "none"), device="cpu") == (None,
                                                                   None)


def test_rotation_keeps_the_newest(tmp_path):
    for step in range(5):
        CKPT.save(str(tmp_path), step, {"x": torch.zeros(2)}, keep=2)
    assert CKPT.latest_steps(str(tmp_path)) == [3, 4]


def test_async_failure_is_raised_again_from_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    CKPT.save(str(blocker), 1, {"x": torch.ones(2)}, blocking=False)
    with pytest.raises(OSError):
        CKPT.wait()
    CKPT.wait()                                   # raised once, then clear
    CKPT.save(str(tmp_path / "ok"), 2, {"x": torch.ones(2)}, blocking=False)
    CKPT.wait()
    assert CKPT.latest_steps(str(tmp_path / "ok")) == [2]


def test_jax_adamw_state_carries_across():
    """JAX's AdamW state with the guard's streak and the compression
    residual -> the port's: float32 moments and residual, the int32
    streak and step; a bf16 parameter tree stays bf16."""
    r = np.random.RandomState(2)
    params = {"a": jnp.asarray(r.randn(3, 2), jnp.bfloat16),
              "b": [jnp.asarray(r.randn(4), jnp.bfloat16)]}
    jopt = jadamw.init_state(params)
    jopt = {**jopt, "step": jnp.int32(9),
            "guard_streak": jnp.int32(2),
            "ef": jax.tree.map(lambda p: jnp.full(p.shape, 0.5, jnp.float32),
                               params)}
    np_opt = jax.tree.map(np.asarray, jopt)
    opt = tree_from_numpy(np_opt, "cpu")
    assert int(opt["step"]) == 9 and opt["step"].shape == ()
    assert opt["step"].dtype == opt["guard_streak"].dtype == torch.int32
    assert all(t.dtype == torch.float32 for t in tree_leaves(opt["m"])
               + tree_leaves(opt["ef"]))
    tparams = tree_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tparams))
    np.testing.assert_array_equal(
        tparams["a"].float().numpy(),
        np.asarray(params["a"].astype(jnp.float32)))
    # The carried state steps as the port's own does.
    new, state, _ = adamw.apply_updates(
        tparams, tparams, {k: opt[k] for k in ("m", "v", "step")}, 1e-3,
        adamw.AdamWConfig())
    assert int(state["step"]) == 10 and new["a"].dtype == torch.bfloat16
