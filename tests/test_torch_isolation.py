"""The port stands alone: it imports neither ``jax`` nor the JAX package
``repro``, and its entry points never fall back to the CPU when no card is
present."""

import importlib
import pathlib
import pkgutil
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:[.\s]|$)",
                     re.MULTILINE)


def _modules():
    import repro_torch
    return ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]


def test_every_module_imports_without_jax_or_repro():
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_source_imports_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
            for p in files for m in _IMPORT.finditer(p.read_text())]
    assert not hits, hits
    assert len(files) > 10


def test_module_list_covers_the_slice():
    mods = set(_modules())
    for m in ("repro_torch.core.conv", "repro_torch.kernels.tap_gemm",
              "repro_torch.kernels.ops", "repro_torch.train.cnn_bp",
              "repro_torch.core.bpim2col", "repro_torch.kernels.matmul",
              "repro_torch.models.autoencoder", "repro_torch.optim.adamw",
              "repro_torch.optim.schedule", "repro_torch.train.train_step",
              "repro_torch.train.autoencoder_bp", "repro_torch.tree",
              "repro_torch.configs.base", "repro_torch.configs.smollm_360m",
              "repro_torch.kernels.flash_attention",
              "repro_torch.models.attention",
              "repro_torch.models.transformer", "repro_torch.models.model",
              "repro_torch.serve.request", "repro_torch.serve.sampling",
              "repro_torch.serve.cache", "repro_torch.serve.engine",
              "repro_torch.serve.continuous", "repro_torch.launch.serve",
              "repro_torch.core.config", "repro_torch.kernels.autotune",
              "repro_torch.kernels.timing", "repro_torch.train.losses",
              "repro_torch.optim.compression", "repro_torch.data.pipeline",
              "repro_torch.ft.failures", "repro_torch.ckpt.checkpoint",
              "repro_torch.launch.train", "repro_torch.models.mamba2",
              "repro_torch.configs.mamba2_370m",
              "repro_torch.models.recurrent",
              "repro_torch.configs.recurrentgemma_9b",
              "repro_torch.configs.granite_3_8b",
              "repro_torch.configs.minicpm_2b",
              "repro_torch.configs.phi4_mini_3_8b",
              "repro_torch.configs.internvl2_76b",
              "repro_torch.configs.hubert_xlarge",
              "repro_torch.ft.inject", "repro_torch.obs",
              "repro_torch.obs.events", "repro_torch.obs.trace",
              "repro_torch.obs.metrics", "repro_torch.train.chaos"):
        assert m in mods
        importlib.import_module(m)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.models import layers
    from repro_torch.train import cnn_bp
    import numpy as np
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cnn_bp.train(steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cnn_bp.init_params()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cnn_bp.synthetic_task(np.random.RandomState(0), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        layers.init_conv2d(torch.Generator(), 3, 4, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cnn_bp.main(["--steps", "1"])
    from repro_torch.models import autoencoder
    from repro_torch.train import autoencoder_bp
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autoencoder_bp.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autoencoder.init_autoencoder(torch.Generator(),
                                     autoencoder.AutoencoderConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        layers.init_conv2d_transpose(torch.Generator(), 4, 3, 3)
    from repro_torch.ckpt import checkpoint
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "smollm-360m", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "mamba2-370m", "--smoke", "--steps", "1",
                    "--conv-policy", "pallas"])
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mamba2-370m", "--conv-policy", "pallas"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.restore(".")


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA (here) or without the package beside it, the smoke
    script exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
