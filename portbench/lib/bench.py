"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout root names the configurations, the
cells and the metrics.  Everything else is found by name under
``portbench/``: a configuration's file is the ``file`` its entry gives,
a traffic mix is ``traffic/<traffic>.json``, the driver of a
configuration is ``drivers/<entry>.py`` (``entry`` read from the
configuration's file) and a per-layer metric's reader is
``metrics/<name>.py``, or, where that file is not there, the reader of
its base name, the part before the first dot (``mfu.lm`` and ``mfu.cnn``
are both read by ``metrics/mfu.py``).  A new cell, mix, configuration or metric is a new
file and an entry in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
from types import ModuleType

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = "portbench"


@dataclasses.dataclass
class Cell:
    """One resolved cell: its entries in ``BENCHMARK.json`` and the files
    they name."""
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: pathlib.Path

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def driver(self) -> ModuleType:
        return load_module(self.root, "drivers", self.config["entry"])


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _listed(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(name: str, root: pathlib.Path = ROOT,
            bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; raises
    ``KeyError`` for a name it does not hold."""
    bench = load_benchmark(root) if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; the benchmark has "
                       f"{', '.join(sorted(work))}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _listed(m, name)]
    moves = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moves)]
    return Cell(name, w, config, traffic, e2e, layer, root)


def load_module(root: pathlib.Path, kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py`` as a module, or the file of the
    name's base (the part before its first dot) where ``name`` has no file
    of its own.  A metric's name may hold dots, so the file is loaded by
    its path, not imported by name."""
    path = root / HERE / kind / f"{name}.py"
    if not path.exists():
        path = root / HERE / kind / f"{name.split('.', 1)[0]}.py"
    key = f"portbench_{kind}_" + \
        path.stem.replace(".", "_").replace("-", "_")
    cached = sys.modules.get(key)
    if cached is not None and pathlib.Path(cached.__file__) == path:
        return cached
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
