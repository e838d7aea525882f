"""Checkpoint / restore with step-atomic manifests (counterpart of
``repro.ckpt.checkpoint``, the same on-disk layout).

Layout per step:
    <dir>/step_000123/
        manifest.json      {step, leaves: [{name, file, shape, dtype,
                           sha256}]}
        arr_00000.npy ...  one file per leaf (dict keys in sorted order)
        COMMIT             written last; a checkpoint without COMMIT is
                           ignored by restore (atomicity under mid-write
                           failures)

Leaves are tensors (copied to the host) or numpy arrays; AdamW's step
count, a 0-d int32 tensor, is the int32 scalar the JAX package writes.
numpy has no bfloat16 (the JAX package gets one from ``ml_dtypes``), so a
bf16 leaf is stored as its raw 16-bit pattern with ``"bfloat16"`` in the
manifest: its sha256 over the raw bytes is the JAX package's for the same
values.  Content hashes detect silent corruption;
``keep`` rotates old checkpoints.

Async save: ``save(..., blocking=False)`` copies to the host in the caller
thread and writes files on a background thread.  A background write that
FAILS is never silent: the exception is re-raised from the next ``save()``
or from :func:`wait`.

Restore is degradation-aware: a candidate checkpoint that cannot be loaded
(truncated array file, manifest hash mismatch, torn write without COMMIT)
is SKIPPED with the reason recorded (:func:`skipped_checkpoints`) and the
next-newest committed step is tried.  Only when NO candidate is loadable --
or an explicitly requested ``step=`` is bad -- does restore raise.  Leaves
come back as tensors on the requested device.

Fault sites and telemetry, as in the JAX package: ``ckpt.write`` fires
inside the writer (on the writer thread for an async save, so its fault
is the one re-raised from the next ``save()`` or :func:`wait`),
``ckpt.read`` at the top of :func:`restore`; each write and restore is a
``ckpt`` event on the obs bus, and each write a ``ckpt:write`` span (on
the writer thread's own ``tid`` lane for an async save).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.ft.inject import fault_point
from repro_torch.obs import events as obs_events
from repro_torch.obs import trace as obs_trace

_STEP_DIR = re.compile(r"step_(\d+)")
BF16 = "bfloat16"


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _set_path(tree, path, val):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = val


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf -> (the array written to disk, the manifest's dtype)."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), BF16
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _sha256(arr: np.ndarray) -> str:
    """The hex sha256 of the array's bytes (``arr.tobytes()``, uncopied)."""
    return hashlib.sha256(
        memoryview(np.ascontiguousarray(arr)).cast("B")).hexdigest()


def _each_leaf(fn, items) -> list:
    """``fn`` over ``items`` on a few threads (hashing and file I/O release
    the GIL; a full-width model's 3.6 GB checkpoint takes seconds on one),
    results in order."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(fn, items))


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


# ---------------------------------------------------------------------------
# Async writer with exception capture
# ---------------------------------------------------------------------------

class _AsyncWriter:
    """At most one background checkpoint write in flight; its exception
    (if any) is held until the next :meth:`launch` or :meth:`wait`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def _join_locked(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _reraise_locked(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def launch(self, fn) -> None:
        """Wait for the previous write (re-raising its failure), then run
        ``fn`` on a fresh background thread."""
        with self._lock:
            self._join_locked()
            self._reraise_locked()

            def _run():
                try:
                    fn()
                except BaseException as e:   # held, re-raised on next call
                    self._exc = e

            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the in-flight write and re-raise its failure (if any)."""
        with self._lock:
            self._join_locked()
            self._reraise_locked()


_WRITER = _AsyncWriter()


def wait() -> None:
    """Block until any async ``save(..., blocking=False)`` has finished,
    re-raising the background exception if the write failed.  Call before
    reading ``latest_steps`` at shutdown / before a rollback-restore."""
    _WRITER.wait()


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------

def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         blocking: bool = True) -> str:
    """Write a step-atomic checkpoint; returns its directory.

    Non-blocking saves hand the file I/O to a background thread; a failure
    there is re-raised from the NEXT ``save()`` (or :func:`wait`), so a
    dead disk cannot silently eat every checkpoint of a run.
    """
    _WRITER.wait()                    # surface any failed previous write
    leaves = [(".".join(path), *_to_host(leaf))
              for path, leaf in _leaf_paths(tree)]

    def _write_impl():
        fault_point("ckpt.write")
        obs_events.emit("ckpt", "write", step=step, blocking=blocking)
        d = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = d + ".tmp"
        try:
            os.makedirs(tmp, exist_ok=True)

            def write(i):
                np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), leaves[i][1])
                return _sha256(leaves[i][1])

            hashes = _each_leaf(write, range(len(leaves)))
            manifest = {"step": step, "leaves": [
                {"name": name, "file": f"arr_{i:05d}.npy",
                 "shape": list(arr.shape), "dtype": dtype, "sha256": h}
                for i, ((name, arr, dtype), h) in enumerate(
                    zip(leaves, hashes))]}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "COMMIT"), "w") as f:
                f.write("ok")
        except BaseException:
            # Never leave a half-written tmp dir behind: the *.tmp suffix
            # already excludes it from latest_steps, but a retry of the
            # same step must start clean.
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        _rotate(ckpt_dir, keep)

    def _write():
        # The span runs on the writer thread for an async save, so the
        # trace shows the checkpoint I/O beside the steps on its own lane.
        with obs_trace.span("ckpt:write", step=step, leaves=len(leaves),
                            blocking=blocking):
            _write_impl()

    if blocking:
        _write()
    else:
        _WRITER.launch(_write)
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _rotate(ckpt_dir: str, keep: int):
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


# ---------------------------------------------------------------------------
# Discovery and skip accounting
# ---------------------------------------------------------------------------

#: restore/discovery decisions to skip a checkpoint, with reasons (bounded).
_SKIPPED: list[dict] = []
_MAX_SKIPPED = 64


def _record_skip(what: str, reason: str) -> None:
    if len(_SKIPPED) < _MAX_SKIPPED:
        _SKIPPED.append({"checkpoint": what, "reason": reason})


def skipped_checkpoints() -> list[dict]:
    """Checkpoints that discovery or restore refused to use, and why
    (torn write without COMMIT, truncated array, hash mismatch, ...)."""
    return list(_SKIPPED)


def reset_skipped_checkpoints() -> None:
    _SKIPPED.clear()


def latest_steps(ckpt_dir: str) -> list[int]:
    """Committed checkpoint steps, ascending.  Torn writes (a ``step_*``
    directory without COMMIT) are skipped and recorded; ``*.tmp`` staging
    dirs and foreign names are ignored."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_DIR.fullmatch(name)
        if not m:
            continue
        if not os.path.exists(os.path.join(ckpt_dir, name, "COMMIT")):
            _record_skip(name, "no COMMIT marker (torn write)")
            continue
        out.append(int(m.group(1)))
    return sorted(out)


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------

def _load_one(ckpt_dir: str, step: int, device, verify: bool):
    """Load one committed checkpoint or raise (OSError/ValueError/...)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def read(leaf):
        arr = np.load(os.path.join(d, leaf["file"]))
        if verify and _sha256(arr) != leaf["sha256"]:
            raise IOError(
                f"checkpoint corruption in {leaf['name']} at step {step}")
        return arr

    tree: dict = {}
    for leaf, arr in zip(manifest["leaves"],
                         _each_leaf(read, manifest["leaves"])):
        _set_path(tree, tuple(leaf["name"].split(".")),
                  _to_tensor(arr, leaf["dtype"], device))
    return tree


def restore(ckpt_dir: str, step: Optional[int] = None, *, device=None,
            verify: bool = True):
    """Restore the newest LOADABLE committed checkpoint (or the given step)
    onto ``device`` (default: the card).  Returns ``(step, tree)``, or
    ``(None, None)`` when no checkpoint exists.  A bf16 leaf comes back as
    ``torch.bfloat16``, the step count as a 0-d int32 tensor.

    Without an explicit ``step=``, candidates are tried newest-first: a
    checkpoint that fails to load (truncated ``.npy``, manifest hash
    mismatch, unreadable manifest) is skipped with the reason recorded in
    :func:`skipped_checkpoints` and the next-newest is tried.  Only when
    every committed candidate fails does restore raise, naming each
    failure.  An explicit ``step=`` never falls back -- a bad requested
    checkpoint raises immediately.
    """
    fault_point("ckpt.read")
    obs_events.emit("ckpt", "restore", step=step)
    dev = resolve_device(device)
    steps = latest_steps(ckpt_dir)
    if not steps:
        return None, None
    if step is not None:
        try:
            return step, _load_one(ckpt_dir, step, dev, verify)
        except (OSError, ValueError, KeyError, EOFError) as e:
            raise IOError(
                f"requested checkpoint step {step} is not loadable: "
                f"{e}") from e
    errors = []
    for cand in reversed(steps):
        try:
            return cand, _load_one(ckpt_dir, cand, dev, verify)
        except (OSError, ValueError, KeyError, EOFError) as e:
            _record_skip(f"step_{cand:08d}", str(e))
            errors.append(f"step {cand}: {e}")
    raise IOError(
        f"no loadable checkpoint in {ckpt_dir}: " + "; ".join(errors))
