"""``correct`` comes out true for the program and false for its control
and for each fault a cell can have.

The CPU cases drive the rest of a run (``run_cell``; the look for a card
is ``main``'s) at a tiny size with the timed path broken underneath.  The
``cuda`` case runs each control at the cell's own size on three seeds, as
the limits were set (``portbench/calibrate.py``)."""

from __future__ import annotations

import json

import pytest

from portbench import run
from portbench.lib import bench
from portbench.tests import _tiny

CELLS = [w["name"] for w in bench.load_benchmark()["workloads"]]
SEED = 2 ** 33 + 12345


def _run(name: str, program=None) -> dict:
    return run.run_cell(_tiny.cell(name), SEED, 0.2, False, "cpu",
                        program=program)


@pytest.mark.parametrize("name", CELLS)
def test_the_program_reads_correct(name):
    out = _run(name)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_not_correct(name):
    cell = _tiny.cell(name)
    make = cell.driver().control(cell.config["control"])
    out = _run(name, make)
    assert out["correct"] is False, out["checks"]


FAULTS = [(n, f) for n in CELLS
          for f in sorted(bench.resolve(n).driver().FAULTS)]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_each_fault_reads_not_correct(name, fault):
    out = _run(name, bench.resolve(name).driver().FAULTS[fault])
    assert out["correct"] is False, out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_own_size(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size")
    cell = bench.resolve(name)
    make = cell.driver().control(cell.config["control"])
    for seed in (101, 2 ** 32 + 5, 2 ** 31 + 77):
        out = run.run_cell(cell, seed, 1.0, False, "cuda", program=make)
        assert out["correct"] is False, out["checks"]


def test_calibrate_prints_one_reading_a_seed(monkeypatch, capsys, tmp_path):
    from portbench import calibrate
    whole = bench.resolve
    monkeypatch.setattr(calibrate.bench, "resolve",
                        lambda name: _tiny.tiny(whole(name)))
    out = tmp_path / "r.jsonl"
    calibrate.main(["--workload", "resnet50-s2convs.b256", "--as", "stale",
                    "--seeds", "1", str(2 ** 40), "--seconds", "0.1",
                    "--device", "cpu", "--out", str(out)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["seed"] for x in lines] == [1, 2 ** 40]
    assert all(x["correct"] is False and x["as"] == "stale" for x in lines)
    assert out.read_text().count("\n") == 2
