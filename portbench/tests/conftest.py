"""The benchmark's own tests: run from the checkout root with
``python -m pytest portbench/tests``; the program's package is put on
the path as the benchmark's command puts it."""

import pathlib
import sys

SRC = pathlib.Path(__file__).resolve().parents[2] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))
