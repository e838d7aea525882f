"""Learning-rate schedules: cosine, WSD (warmup-stable-decay) and constant.

Counterpart of ``repro.optim.schedule``, on Python floats: a schedule is a
host-side number per step.  WSD (arXiv:2404.06395) is MiniCPM's default
(:func:`default_schedule_for`).
"""

from __future__ import annotations

import math


def _clip01(v: float) -> float:
    return min(max(v, 0.0), 1.0)


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> float:
    step = float(step)
    if step < warmup:
        return peak_lr * step / max(warmup, 1)
    prog = _clip01((step - warmup) / max(total - warmup, 1))
    return peak_lr * (final_frac + (1 - final_frac) * 0.5
                      * (1 + math.cos(math.pi * prog)))


def wsd(step, *, peak_lr: float, warmup: int, total: int,
        decay_frac: float = 0.1, final_frac: float = 0.01) -> float:
    """Warmup -> stable plateau -> decay over the last decay_frac of steps."""
    step = float(step)
    if step < warmup:
        return peak_lr * step / max(warmup, 1)
    decay_start = total * (1 - decay_frac)
    if step < decay_start:
        return peak_lr
    prog = _clip01((step - decay_start) / max(total - decay_start, 1))
    return peak_lr * math.exp(math.log(final_frac) * prog)


def constant(step, *, peak_lr: float, **_) -> float:
    return float(peak_lr)


SCHEDULES = {"cosine": warmup_cosine, "wsd": wsd, "constant": constant}


def default_schedule_for(arch_name: str) -> str:
    return "wsd" if "minicpm" in arch_name else "cosine"
