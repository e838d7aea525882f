"""Readings that the limits of ``correct`` are set from.

    python3 portbench/calibrate.py --workload <cell> --as <who> \\
        --seeds <n> [<n> ...] [--seconds <s>] [--out <file.jsonl>]

runs the cell once a seed, in one process, as the benchmark's own runs
do (set-up, a window of ``--seconds``, the comparison), with ``<who>`` in
the program's place:

* ``program``: the program itself (the lower readings);
* ``control``: the plain reference computed in the precision the
  configuration's ``control`` names, the nearest below its own (the
  upper readings);
* a fault named in ``FAULTS`` of the cell's ``drivers/`` module: the
  program with that fault planted.

Each run prints one JSON line ``{"seed", "as", "correct", "checks",
"details"}``: the compared numbers beside the configuration's present
limits, and the readings behind them that the cell's ``check`` keeps
(the LM's gap of each leaf).  The
benchmark's own runs (``run.py``) use none of this."""

import argparse
import gc
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench.lib import bench  # noqa: E402
from portbench.run import run_cell  # noqa: E402


def factory(cell: bench.Cell, who: str):
    """The program factory that ``who`` names, of ``cell``'s driver."""
    drv = cell.driver()
    if who == "program":
        return drv.program
    if who == "control":
        return drv.control(cell.config["control"])
    if who in drv.FAULTS:
        return drv.FAULTS[who]
    raise KeyError(f"{who!r}: not program, control or one of "
                   f"{sorted(drv.FAULTS)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--as", dest="who", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    cell = bench.resolve(args.workload)
    make = factory(cell, args.who)
    for seed in args.seeds:
        out = run_cell(cell, seed, args.seconds, False, args.device,
                       program=make)
        line = json.dumps({"cell": cell.name, "seed": seed, "as": args.who,
                           "correct": out["correct"],
                           "checks": out["checks"],
                           "details": out["details"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del out
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
