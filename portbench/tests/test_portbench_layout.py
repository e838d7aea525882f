"""The harness finds every piece of a cell by name, and a cell added as
new files only runs without an edit to a file that is there."""

from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from portbench import run
from portbench.lib import bench, result
from portbench.tests import _tiny

ROOT = bench.ROOT
BENCH = bench.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_by_name(name):
    cell = bench.resolve(name)
    assert cell.config["name"] == cell.workload["config"]
    assert hasattr(cell.driver(), "Cell")
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    drv = cell.driver()
    assert drv.RATE_METRIC in {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader_of_its_own(name):
    mod = bench.load_module(ROOT, "metrics", name)
    assert callable(mod.read)


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        bench.resolve("no-such-cell")


def test_every_file_a_config_names_lies_under_paths():
    for c in BENCH["configs"]:
        path = pathlib.Path(c["file"])
        assert path.parts[0] in BENCH["paths"]
        assert (ROOT / path).is_file()
    for w in BENCH["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json") \
            .is_file()


def _digests(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_as_new_files_only_runs(tmp_path):
    """A new configuration, traffic mix and per-layer metric, each a new
    file, and entries in BENCHMARK.json: the cell resolves and runs at a
    tiny CPU size, and no file under portbench/ changed."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    conf = json.loads((ROOT / "portbench/configs/resnet50-s2convs.json")
                      .read_text())
    conf.update(name="tiny-convs", layers=_tiny.CONV_LAYERS[:2])
    (tmp_path / "portbench/configs/tiny-convs.json").write_text(
        json.dumps(conf))
    (tmp_path / "portbench/traffic/b3.json").write_text(json.dumps(
        {"batch": 3, "input_sets": 2, "warmup_steps": 1, "trace_steps": 2,
         "enqueue_steps": 2, "why": "a test"}))
    (tmp_path / "portbench/metrics/steps_traced.cnn.py").write_text(
        "def read(ctx):\n    return ctx.stretch_steps or None\n")
    bj = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bj["configs"].append({"name": "tiny-convs", "source": "a test",
                          "file": "portbench/configs/tiny-convs.json",
                          "reduced": [], "why": "a test"})
    bj["workloads"].append({"name": "tiny-convs.b3", "config": "tiny-convs",
                            "traffic": "b3", "chips": 1, "why": "a test"})
    for m in bj["end_to_end"]:
        if m["name"] == "conv_train_images_per_s":
            m["workloads"].append("tiny-convs.b3")
    bj["per_layer"].append({"name": "steps_traced.cnn", "unit": "steps",
                            "better": "higher", "source": "program_counter",
                            "layer": "conv step",
                            "moves": "conv_train_images_per_s",
                            "workloads": ["tiny-convs.b3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bj))
    after = _digests(tmp_path)
    assert {k: after[k] for k in before} == before

    cell = bench.resolve("tiny-convs.b3", root=tmp_path)
    assert cell.root == tmp_path and cell.traffic["batch"] == 3
    out = run.run_cell(cell, 2 ** 40 + 7, 0.2, True, "cpu")
    assert out["correct"] is True
    assert out["metrics"]["steps_traced.cnn"]["value"] == 2
    out = run.run_cell(cell, 2 ** 40 + 7, 0.2, False, "cpu")
    assert set(out["metrics"]) == {"conv_train_images_per_s",
                                   "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_has_the_keys_the_driver_reads(trace):
    out = run.run_cell(_tiny.cell("resnet50-s2convs.b256"), 11, 0.2, trace,
                       "cpu")
    line = json.loads(result.line(out["correct"], out["attempted"],
                                  out["failed"], out["metrics"],
                                  out["device"], out["checks"],
                                  out["breakdown"]))
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if trace else []
    assert list(line) == want + ["checks"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}


def test_a_run_without_a_card_prints_no_result(capfd):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0
    assert capfd.readouterr().out == ""


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
