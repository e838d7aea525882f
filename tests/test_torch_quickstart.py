"""The port's quickstart (``python -m repro_torch.quickstart``, the
counterpart of ``examples/quickstart.py``) on the CPU: it runs its four
sections, its internal checks pass, and the sparsities and traffic
figures it prints are those of the JAX package's ``repro.core`` functions
on the same layer."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.core import bpim2col as jbp  # noqa: E402
from repro.core import im2col_ref as jref  # noqa: E402
from repro.core.im2col_ref import ConvDims as JDims  # noqa: E402

from repro_torch import quickstart  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
JLAYER = JDims(**dataclasses.asdict(quickstart.LAYER))


def _jax_lines() -> list[str]:
    """The figure lines of ``examples/quickstart.py``, from the JAX
    package's functions."""
    d = JLAYER
    t = jref.reorg_traffic_elems_loss(d)
    o = jbp.bp_traffic_elems_loss(d)
    return [
        f"layer: H={d.H_i} C={d.C} N={d.N} K={d.K_h} S={d.S} P={d.P_h}"
        f" -> H_o={d.H_o}",
        f"zero-spaced loss map: {d.H_o}x{d.W_o} -> {d.H_o3}x{d.W_o3} "
        f"({d.zero_space_sparsity_loss():.1%} zeros)",
        f"lowered matrix B sparsity (loss calc):  "
        f"{jbp.lowered_sparsity_loss(d):.1%}  <- paper: 75%..93.91%",
        f"zero-inserted dY sparsity (grad calc):  "
        f"{jbp.lowered_sparsity_grad(d):.1%}  <- paper: 74.8%..93.6%",
        f"traditional: reorg {t['reorg_read'] + t['reorg_write']:,} elems, "
        f"off-chip stream {t['offchip_stream']:,}, "
        f"buffer stream {t['buffer_stream']:,}",
        f"BP-im2col:   reorg 0 elems, off-chip stream "
        f"{o['offchip_stream']:,}, buffer stream {o['buffer_stream']:,}",
        f"buffer-bandwidth reduction: "
        f"{1 - o['buffer_stream'] / t['buffer_stream']:.1%} "
        f"(paper: >= 70.6%)",
        f"extra backprop storage eliminated: {t['extra_storage']:,} elems "
        f"(paper: >= 74.78% reduction)"]


def test_quickstart_prints_the_jax_figures_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.quickstart", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    for want in _jax_lines():
        assert want in lines, (want, proc.stdout)
    assert sum(line.endswith("OK") for line in lines) == 2, proc.stdout


def test_quickstart_figures_equal_the_jax_functions(capsys):
    """The figures ``run`` returns are the JAX functions' values, exactly."""
    got = quickstart.run("cpu")
    d = JLAYER
    assert got["zero_space_sparsity_loss"] == d.zero_space_sparsity_loss()
    assert got["lowered_sparsity_loss"] == jbp.lowered_sparsity_loss(d)
    assert got["lowered_sparsity_grad"] == jbp.lowered_sparsity_grad(d)
    assert got["traditional"] == jref.reorg_traffic_elems_loss(d)
    assert got["bp_im2col"] == jbp.bp_traffic_elems_loss(d)


def test_quickstart_check_raises_on_a_mismatch():
    """The internal checks raise: a lowering one element off fails."""
    a = torch.zeros(3, 4)
    b = a.clone()
    b[1, 2] = 1e-3
    with pytest.raises(AssertionError, match="max"):
        quickstart._close(a, b, 1e-6, 0.0, "a check")
    quickstart._close(a, a.clone(), 1e-6, 0.0, "a check")


def test_quickstart_defaults_to_the_card():
    """Without ``--device`` it asks for the card and never falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
