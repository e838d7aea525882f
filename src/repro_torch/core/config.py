"""Global runtime configuration of the port: ``repro_torch.core.config``.

Counterpart of ``repro.core.config`` for the fields the port reads: the
measured autotuning of the tap kernels' plans, Mamba2's SSD chunk length,
the key length at which training attention goes blockwise, and the
rematerialization override:

    from repro_torch.core.config import config

    config.autotune                          # read anywhere, any time
    config.update(autotune="measure")        # permanent, validated
    with config.override(autotune="cached", plan_cache_dir="/tmp/plans"):
        ...                                  # scoped, restored on exit

Fields initialize once from the environment (``REPRO_AUTOTUNE``,
``REPRO_AUTOTUNE_TOP_K``, ``REPRO_AUTOTUNE_REPS``, ``REPRO_PLAN_CACHE_DIR``,
``REPRO_SSD_CHUNK``, ``REPRO_BLOCKWISE_THRESHOLD``, ``REPRO_REMAT``,
parsed as the JAX package parses them), and direct attribute assignment
raises: mutation goes through :meth:`GlobalConfig.update` /
:meth:`GlobalConfig.override`, which validate values and drop the tuner's
in-process memo when a plan-affecting field changes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import Any, Callable

AUTOTUNE_MODES = ("off", "measure", "cached")


def _parse_optional_str(raw: str) -> str | None:
    return raw or None


def _check_autotune(v: Any) -> str:
    if v not in AUTOTUNE_MODES:
        raise ValueError(
            f"autotune must be one of {AUTOTUNE_MODES}, got {v!r}")
    return v


def _check_positive_int(name: str) -> Callable[[Any], int]:
    def check(v: Any) -> int:
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ValueError(f"{name} must be a positive int, got {v!r}")
        return v
    return check


def _check_optional_str(v: Any) -> str | None:
    if v is not None and not isinstance(v, str):
        raise ValueError(f"expected a str or None, got {v!r}")
    return v


@dataclasses.dataclass(frozen=True)
class _Field:
    env: str                       # the env var this field initializes from
    default: Any
    parse: Callable[[str], Any]    # raw env string -> value
    check: Callable[[Any], Any]    # validate an update() value
    plan_affecting: bool = False   # True: a change drops the tuner's memo


#: field name -> spec.
FIELDS: dict[str, _Field] = {
    # Measured autotuning of the tap kernels' plans (kernels/autotune.py):
    #   off     -- the analytic plans only;
    #   measure -- time the top-k candidates on the card, persist the
    #              winner in the plan cache, reuse persisted winners;
    #   cached  -- never time: persisted winners when present, analytic
    #              plans otherwise.
    "autotune": _Field("REPRO_AUTOTUNE", "off", str, _check_autotune,
                       plan_affecting=True),
    "autotune_top_k": _Field("REPRO_AUTOTUNE_TOP_K", 4, int,
                             _check_positive_int("autotune_top_k"),
                             plan_affecting=True),
    "autotune_reps": _Field("REPRO_AUTOTUNE_REPS", 3, int,
                            _check_positive_int("autotune_reps"),
                            plan_affecting=True),
    # Plan-cache directory; None resolves under $XDG_CACHE_HOME (see
    # kernels/autotune.py:default_cache_dir).
    "plan_cache_dir": _Field("REPRO_PLAN_CACHE_DIR", None,
                             _parse_optional_str, _check_optional_str,
                             plan_affecting=True),
    # Mamba2 SSD chunk length (intra-chunk quadratic vs inter-chunk linear;
    # models/mamba2.py).
    "ssd_chunk": _Field("REPRO_SSD_CHUNK", 128, int,
                        _check_positive_int("ssd_chunk")),
    # Key length above which attention under autograd switches from the
    # dense scores to the blockwise online-softmax loop
    # (models/attention.py).
    "blockwise_kv_threshold": _Field("REPRO_BLOCKWISE_THRESHOLD", 1024, int,
                                     _check_positive_int(
                                         "blockwise_kv_threshold")),
    # Remat override: None defers to each ArchConfig.remat; "none"/"block"
    # force the policy globally (models/transformer.py).
    "remat": _Field("REPRO_REMAT", None, _parse_optional_str,
                    _check_optional_str),
}


def _invalidate_plan_caches() -> None:
    """Drop the tuner's in-process memo (not the file).  Through
    sys.modules: config must not import the kernel stack."""
    autotune = sys.modules.get("repro_torch.kernels.autotune")
    if autotune is not None:
        autotune.clear_memo()


class GlobalConfig:
    """The configuration singleton.  Frozen: ``config.field = x`` raises;
    go through :meth:`update` (permanent) or :meth:`override` (scoped)."""

    def __init__(self, env: dict | None = None):
        env = os.environ if env is None else env
        object.__setattr__(self, "_values", {
            name: f.default if env.get(f.env) is None
            else f.parse(env[f.env]) for name, f in FIELDS.items()})

    def __getattr__(self, name: str):
        if name not in FIELDS:
            raise AttributeError(
                f"config has no field {name!r}; fields: {tuple(FIELDS)}")
        return self._values[name]

    def snapshot(self) -> dict[str, Any]:
        """Current value of every field (a plain dict copy)."""
        return dict(self._values)

    def __setattr__(self, name: str, value) -> None:
        raise AttributeError(
            f"config is frozen; use config.update({name}={value!r}) or the "
            "config.override(...) context manager")

    def update(self, **kw) -> None:
        """Validated permanent update; drops the tuner's memo when a
        plan-affecting field actually changes.  Every value is checked
        before any is stored."""
        unknown = set(kw) - set(FIELDS)
        if unknown:
            raise ValueError(
                f"unknown config field(s) {sorted(unknown)}; fields: "
                f"{tuple(FIELDS)}")
        new = {name: FIELDS[name].check(v) for name, v in kw.items()}
        invalidate = any(FIELDS[name].plan_affecting
                         and self._values[name] != v
                         for name, v in new.items())
        self._values.update(new)
        if invalidate:
            _invalidate_plan_caches()

    @contextlib.contextmanager
    def override(self, **kw):
        """Scoped :meth:`update`: previous values restored on exit (also on
        exception)."""
        saved = {name: self._values[name] for name in kw if name in FIELDS}
        self.update(**kw)
        try:
            yield self
        finally:
            self.update(**saved)


#: the singleton.
config = GlobalConfig()
