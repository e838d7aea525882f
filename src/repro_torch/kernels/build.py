"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/*.cu`` compiles into its own shared library with a plain C
interface (loaded with ``ctypes``), for ``sm_90a``.  All sources that are
not built yet compile in parallel, one ``nvcc`` process each.  Libraries go
to ``build/repro_torch/<hash>/`` at the repository root, where ``<hash>``
covers every source and the compiler flags, so an edited source never loads
a stale library.  The compiler's output, ``-Xptxas -v`` register and
shared-memory report included, is kept beside each library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def source_hash() -> str:
    """Hash of every CUDA source and header plus the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> pathlib.Path:
    return BUILD_ROOT / source_hash()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built at first use and need the CUDA toolkit")


def build() -> dict[str, pathlib.Path]:
    """Compile every source that has no library yet (in parallel) and return
    ``{name: library path}``.  Raises with the compiler's output on error."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out_dir / f"lib{src.stem}.so"
            for src in sorted(CSRC.glob("*.cu"))}
    pending = [name for name, lib in libs.items() if not lib.exists()]
    if not pending:
        return libs
    nvcc = _nvcc()
    procs = {}
    for name in pending:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        log = open(out_dir / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), log, tmp)
    failed = []
    for name, (proc, log, tmp) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, libs[name])
        else:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          + (out_dir / f"{name}.log").read_text()[-4000:])
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build()[name]))
        return lib
