"""Wrappers of the hand-written CUDA tap-GEMM kernels (``csrc/tap_gemm.cu``).

Counterpart of ``repro.kernels.tap_gemm``: the same three multi-tap GEMMs
over phase-split, channels-last compact operands,

  * ``tap_gemm``        forward conv
  * ``tap_gemm_phased`` input grad (transposed mode), all stride phases in
                        one launch (plus a fixed-order reduce where a
                        phase splits)
  * ``tap_wgrad``       weight grad (dilated mode), float32 output

with an optional leading group dim on every operand, so a grouped or
depthwise conv is one launch per pass.  Each of the three has a depthwise
variant, ``"dw"`` (:data:`DW_MAX_TAPS`), for one channel a group: no
tile, a thread a 16-byte vector of outputs or pixels; the analytic plan
takes it wherever CIN = COUT = 1 and the variant's limits hold.
Operands are float32 or bfloat16, every operand of a call in one type
(:data:`DTYPES`); as in the JAX kernels, products are summed in float32,
and the forward and the input grad return the operands' type.  On a CUDA
tensor a wrapper checks
its operands and its :class:`Plan` (the variant and split-K count:
:func:`analytic_plan` unless the caller passes one), launches its kernel
(built at first use by ``repro_torch.kernels.build``) or raises; it never
falls back.  On a CPU tensor it returns the plain version from
``repro_torch.kernels.ref``, which has no plan.  ``LAUNCHES`` counts kernel
launches per wrapper (CUDA only), ``TYPE_LAUNCHES`` the same by operand
type and ``VARIANT_LAUNCHES`` by plan variant.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

#: kernel launches per wrapper, counted only where the CUDA kernel launches.
LAUNCHES: dict[str, int] = {"tap_gemm": 0, "tap_gemm_phased": 0,
                            "tap_wgrad": 0}

#: the forward's fixed output tile (must match fwd::BM, fwd::BN in
#: csrc/tap_gemm.cu), also the widest tile of the input grad and of the
#: weight grad (their tiles are :data:`PHASED_TILES`, :data:`WGRAD_TILES`).
TILE_M, TILE_N = 64, 64
GRID_YZ_MAX = 65_535
INT32_MAX = 2**31 - 1

#: operand type -> the suffix of its kernel entries in csrc/tap_gemm.cu.
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


#: the same launches by operand type, ``"tap_gemm:bf16"`` -> count.
TYPE_LAUNCHES: dict[str, int] = {}

#: the same launches by plan variant, ``"tap_gemm:dw"`` -> count.
VARIANT_LAUNCHES: dict[str, int] = {}


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def type_launch_counts() -> dict[str, int]:
    return dict(TYPE_LAUNCHES)


def variant_launch_counts() -> dict[str, int]:
    return dict(VARIANT_LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    TYPE_LAUNCHES.clear()
    VARIANT_LAUNCHES.clear()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_gap(m: int, cout: int, grid_z: int,
               cols: int = TILE_N) -> str | None:
    """None when a launch with ``m`` output rows (or contraction rows),
    ``cout`` columns in tiles of ``cols`` and ``grid_z`` groups (x phases
    for the input grad, x splits under a plan: :func:`plan_gap`) fits the
    kernels' limits, else why not.  The tiles are fixed and no
    halo is staged, so shared memory (18,432 B per forward block; 18,432,
    12,288 or 21,504 B per input-grad block; 16,384 or 10,240 B per
    weight-grad block) never depends on the geometry; only the grid and the
    32-bit row index can overflow.  The split counts keep the grids' z
    within the limit (:func:`wgrad_splits`, :func:`split_count`: the input
    grad's z is at most splits x ``grid_z``)."""
    if m > INT32_MAX:
        return f"{m} rows exceed the kernels' 32-bit row index"
    if _cdiv(cout, cols) > GRID_YZ_MAX:
        return f"{cout} output channels exceed the grid's y limit"
    if grid_z > GRID_YZ_MAX:
        return f"grid z = {grid_z} exceeds {GRID_YZ_MAX}"
    return None


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, with every entry's C signature declared (each
    pointer and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    lib = build.load("tap_gemm")
    for suffix in DTYPES.values():
        getattr(lib, f"tap_gemm_{suffix}").argtypes = ([_P] * 5 + [_I] * 11
                                                       + [_P])
        getattr(lib, f"tap_gemm_phased_{suffix}").argtypes = (
            [_P] * 4 + [_I, _P, _I, _P, _P] + [_I] * 11 + [_P])
        getattr(lib, f"tap_wgrad_{suffix}").argtypes = ([_P] * 5 + [_I] * 12
                                                        + [_P])
        getattr(lib, f"tap_gemm_dw_{suffix}").argtypes = ([_P] * 4 + [_I] * 8
                                                          + [_P])
        getattr(lib, f"tap_wgrad_dw_{suffix}").argtypes = ([_P] * 5
                                                           + [_I] * 9 + [_P])
        getattr(lib, f"tap_gemm_phased_dw_{suffix}").argtypes = (
            [_P] * 5 + [_I] * 8 + [_P])
    lib.tap_gemm_phased_blocks_per_sm.argtypes = [_I] * 4 + [_P]
    lib.tap_wgrad_blocks_per_sm.argtypes = [_I] * 4 + [_P]
    lib.tap_dw_blocks_per_sm.argtypes = [_I] * 3 + [_P]
    for name in ("tap_gemm", "tap_gemm_phased", "tap_wgrad", "tap_gemm_dw",
                 "tap_gemm_phased_dw", "tap_wgrad_dw"):
        for suffix in DTYPES.values():
            getattr(lib, f"{name}_{suffix}").restype = ctypes.c_int
    for fn in (lib.tap_gemm_phased_blocks_per_sm,
               lib.tap_wgrad_blocks_per_sm, lib.tap_dw_blocks_per_sm):
        fn.restype = ctypes.c_int
    return lib



@functools.lru_cache(maxsize=1024)
def _table(rows: tuple, device: torch.device) -> torch.Tensor:
    """A tap table as a small int32 tensor on ``device`` (cached: tables
    depend only on the static geometry)."""
    return torch.tensor(rows, dtype=torch.int32, device=device).reshape(-1)


@functools.lru_cache(maxsize=1024)
def _host_table(rows: tuple) -> ctypes.Array:
    """A tap table as host ints: the depthwise entries pass it to their
    kernels by value (cached, so the array outlives every call)."""
    flat = [int(v) for r in rows for v in r]
    return (ctypes.c_int * max(len(flat), 1))(*flat)


@functools.lru_cache(maxsize=1024)
def dw_phase_table(phase_taps: tuple) -> tuple[ctypes.Array, ctypes.Array]:
    """The depthwise input grad's tap table as the host ints its entry
    receives and passes to its kernel by value: ``(rows, starts)``, every
    phase's ``(j, du, dv)`` rows, phase after phase, and the ``PH + 1``
    offsets where each phase's rows start (phase p's are rows
    ``starts[p]`` to ``starts[p + 1]``; a phase without taps has none).
    Cached, so the arrays outlive every call."""
    flat = [v for taps in phase_taps for r in taps for v in r]
    starts = [0]
    for taps in phase_taps:
        starts.append(starts[-1] + len(taps))
    return ((ctypes.c_int * max(len(flat), 1))(*flat),
            (ctypes.c_int * len(starts))(*starts))


def _check_cuda(name: str, *tensors: torch.Tensor) -> torch.dtype:
    """Checks a CUDA call's operands and returns their one type, float32
    or bfloat16 (the kernel instance it launches); raises on any other
    type, on a mix of types, devices, or on a non-contiguous operand."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"{name}: operands of one type, got "
                        f"{sorted(map(str, dtypes))}")
    dtype = dtypes.pop()
    if dtype not in DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes "
                        f"{' or '.join(map(str, DTYPES))}, got {dtype}")
    return dtype


def _run(name: str, dtype: torch.dtype, variant: str, *args) -> None:
    """Launch the entry of kernel ``name`` for operands of ``dtype`` under
    a plan of ``variant`` (the depthwise variant has entries of its own)
    and count it."""
    entry = f"{name}_dw" if variant == DW else name
    err = getattr(_lib(), f"{entry}_{DTYPES[dtype]}")(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1
    for counts, key in ((TYPE_LAUNCHES, f"{name}:{DTYPES[dtype]}"),
                        (VARIANT_LAUNCHES, f"{name}:{variant}")):
        counts[key] = counts.get(key, 0) + 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def _check_taps(name: str, taps, n_planes: int) -> None:
    for sel, du, dv in taps:
        if not (0 <= sel < n_planes and du >= 0 and dv >= 0):
            raise ValueError(f"{name}: bad tap {(sel, du, dv)} for "
                             f"{n_planes} planes/weights")


def tap_gemm(src: torch.Tensor, w: torch.Tensor, taps, oh: int, ow: int,
             plan: Plan | None = None) -> torch.Tensor:
    """Forward multi-tap GEMM.

    src : ([G,] P, B, Hs, Ws, CIN)   phase-split compact source
    w   : ([G,] T, CIN, COUT)        per-tap weight slices, T == len(taps)
    out : ([G,] B, oh, ow, COUT)     in the operands' type (summed in
                                     float32)

    ``plan``: a ``"forward"`` :class:`Plan` (the 64 x 64 tile and its
    split count, or the depthwise variant ``"dw"``, which writes the
    operands' type directly), or None for :func:`analytic_plan`.
    """
    taps = tuple(tuple(int(v) for v in t) for t in taps)
    grouped = src.dim() == 6
    s6, w4 = (src, w) if grouped else (src[None], w[None])
    g, p, b, hs, ws, cin = s6.shape
    g2, t, cin2, cout = w4.shape
    if (g2, cin2, t) != (g, cin, len(taps)):
        raise ValueError(f"tap_gemm: src {tuple(src.shape)} / w "
                         f"{tuple(w.shape)} / {len(taps)} taps disagree")
    _check_taps("tap_gemm", taps, p)
    cuda = _on_cuda("tap_gemm", src)
    dtype = _check_cuda("tap_gemm", s6, w4) if cuda else src.dtype
    prob = Problem("forward", g, (t,), cin, cout, b * oh * ow, ow,
                   DTYPES.get(dtype, "f32"))
    plan = _checked("tap_gemm", prob, plan, src.device, cuda)
    if not cuda:
        return ref.tap_gemm_ref(src, w, taps, oh, ow)
    if plan.variant == DW:
        out = torch.empty((g, b, oh, ow, cout), dtype=dtype,
                          device=src.device)
        if out.numel():
            _run("tap_gemm", dtype, DW, s6.data_ptr(), w4.data_ptr(),
                 ctypes.addressof(_host_table(taps)), out.data_ptr(), g, p,
                 b, hs, ws, t, oh, ow, _stream(src))
        return out if grouped else out[0]
    table = _table(taps, src.device).data_ptr()
    splits = plan.splits
    out = torch.empty((g, b, oh, ow, cout), dtype=torch.float32,
                      device=src.device)
    part = out if splits == 1 else torch.empty(
        (splits, g, b, oh, ow, cout), dtype=torch.float32, device=src.device)
    _run("tap_gemm", dtype, plan.variant, s6.data_ptr(), w4.data_ptr(),
         table, part.data_ptr(), out.data_ptr(), g, p, b, hs, ws, cin, t,
         cout, oh, ow, splits, _stream(src))
    out = out.to(dtype)
    return out if grouped else out[0]


def tap_gemm_phased(src: torch.Tensor, w: torch.Tensor, phase_taps, oh: int,
                    ow: int, plan: Plan | None = None) -> torch.Tensor:
    """All-phases input-grad tap GEMM in ONE launch.

    src : ([G,] B, Hs, Ws, CIN)       globally padded compact dY, shared by
                                      every phase
    w   : ([G,] PH, T, CIN, COUT)     per-phase tap weights, zero-padded to T
    out : ([G,] PH, B, oh, ow, COUT)  phase-major planes in the operands'
                                      type (summed in float32); a phase
                                      without taps is all zeros

    ``phase_taps[p]`` is a tuple of ``(j, du, dv)``: tap j of phase p reads
    the source window at offset (du, dv).  The kernel's tile and split count
    come from ``plan`` (an ``"input_grad"`` :class:`Plan`), or None for
    :func:`analytic_plan`; a tile's blocks from :func:`phased_work`.  The
    depthwise variant ``"dw"`` writes the operands' type directly, every
    phase in one launch, from the table of :func:`dw_phase_table`.
    """
    phase_taps = tuple(tuple(tuple(int(v) for v in r) for r in taps)
                       for taps in phase_taps)
    grouped = src.dim() == 5
    s5, w5 = (src, w) if grouped else (src[None], w[None])
    g, b, hs, ws, cin = s5.shape
    g2, ph, t, cin2, cout = w5.shape
    if (g2, cin2, ph) != (g, cin, len(phase_taps)):
        raise ValueError(f"tap_gemm_phased: src {tuple(src.shape)} / w "
                         f"{tuple(w.shape)} / {len(phase_taps)} phases "
                         "disagree")
    for taps in phase_taps:
        _check_taps("tap_gemm_phased", taps, t)
        if len(taps) > t:
            raise ValueError(f"tap_gemm_phased: {len(taps)} taps for {t} "
                             "weight slots")
    m = b * oh * ow
    counts = tuple(len(taps) for taps in phase_taps)
    cuda = _on_cuda("tap_gemm_phased", src)
    dtype = _check_cuda("tap_gemm_phased", s5, w5) if cuda else src.dtype
    prob = Problem("input_grad", g, counts, cin, cout, m, ow,
                   DTYPES.get(dtype, "f32"))
    plan = _checked("tap_gemm_phased", prob, plan, src.device, cuda)
    if not cuda:
        return ref.tap_gemm_phased_ref(src, w, phase_taps, oh, ow)
    variant, splits = plan.variant, plan.splits
    if variant == DW:
        out = torch.empty((g, ph, b, oh, ow, cout), dtype=dtype,
                          device=src.device)
        if out.numel():
            rows, starts = dw_phase_table(phase_taps)
            _run("tap_gemm_phased", dtype, DW, s5.data_ptr(), w5.data_ptr(),
                 ctypes.addressof(rows), ctypes.addressof(starts),
                 out.data_ptr(), g, ph, b, hs, ws, t, oh, ow, _stream(src))
        return out if grouped else out[0]
    out = torch.empty((g, ph, b, oh, ow, cout), dtype=torch.float32,
                      device=src.device)
    if out.numel() == 0:
        out = out.to(dtype)
        return out if grouped else out[0]
    work, sums, slots = phased_work(counts, cin, splits,
                                    PHASED_TILES[variant].step)
    rows = tuple(v for taps in phase_taps
                 for r in (*taps, *((0, 0, 0),) * (t - len(taps))) for v in r)
    part = out if slots == 0 else torch.empty(
        (slots, g, m, cout), dtype=torch.float32, device=src.device)
    _run("tap_gemm_phased", dtype, variant, s5.data_ptr(), w5.data_ptr(),
         _table(rows, src.device).data_ptr(),
         _table(sum(work, ()), src.device).data_ptr(), len(work),
         _table(sum(sums, ()), src.device).data_ptr(), len(sums),
         part.data_ptr(), out.data_ptr(), g, ph, b, hs, ws, cin, t, cout, oh,
         ow, PHASED_VARIANTS.index(variant), _stream(src))
    out = out.to(dtype)
    return out if grouped else out[0]


def wgrad_splits(blocks: int, rows: int, sms: int, groups: int = 1) -> int:
    """Split-K factor of the forward: enough splits that ``blocks`` output
    tiles fill about two waves of ``sms`` SMs, but never splits of fewer
    than 256 contraction rows (``rows`` = taps*CIN), and at most the grid's
    z limit over ``groups`` (groups and splits share the grid's z)."""
    return max(1, min(_cdiv(2 * sms, blocks), _cdiv(rows, 256),
                      GRID_YZ_MAX // groups))


def forward_splits(m: int, cout: int, taps: int, cin: int, sms: int,
                   groups: int = 1) -> int:
    """Split-K factor of the forward: :func:`wgrad_splits` over its
    ``groups`` x ``m`` x ``cout`` output in 64 x 64 tiles and its
    contraction of ``taps * cin`` rows (a tap's channels, tap after tap),
    at most :data:`MAX_SPLITS` and rounded so that no split is empty once
    each is cut to whole steps (the rounding drops only a split that would
    sum nothing)."""
    tiles = _cdiv(m, TILE_M) * _cdiv(cout, TILE_N) * groups
    return _whole_splits(taps * cin, min(MAX_SPLITS, wgrad_splits(
        tiles, taps * cin, sms, groups)), FORWARD_TILES["64x64"].step)


#: the least contraction rows of a split under the weight grad's and
#: ``matmul``'s plans (4 steps of 16), and the most splits.
MIN_SPLIT_ROWS = 64
MAX_SPLITS = 256


class Tile(NamedTuple):
    """One kernel variant as the split-K plan sees it."""
    rows: int       # output tile rows
    cols: int       # output tile columns
    step: int       # contraction rows per step
    per_sm: int     # blocks an SM holds (registers, shared memory)


#: weight-grad variants (csrc/tap_gemm.cu, wgrad::kernel), 64 threads a
#: block: 64 x 64 with 8 x 8 outputs a thread (16,384 B of shared memory,
#: 126-153 registers) and, for COUT <= 16, 64 x 16 with 4 x 4 (10,240 B,
#: 55-71 registers).  ``per_sm`` is the least over each variant's instances
#: that the card's occupancy calculator gives; ``chip_smoke.py`` holds it
#: to the card.
WGRAD_TILES = {"64x64": Tile(64, 64, 16, 6), "64x16": Tile(64, 16, 16, 14),
               "dw": Tile(1, 1, 1, 5)}

#: the depthwise variant ``"dw"`` of the forward, the input grad and the
#: weight grad (csrc/tap_gemm.cu, ``dw::fwd_kernel``, ``dw::phased_kernel``,
#: ``dw::wgrad_kernel``), for one channel a group (CIN = COUT = 1) and 1 to
#: :data:`DW_MAX_TAPS` taps (7 x 7; an instance of 16 tap registers below
#: 17 taps).  It has no tile: each of :data:`DW_THREADS` threads a block
#: takes a vector of 16 bytes, :data:`DW_VEC` elements of the operand type,
#: of outputs (the forward, the input grad) or pixels (the weight grad), so
#: its :class:`Tile` is ``(1, 1, 1, per_sm)``: a split is cut in whole
#: vectors (:func:`dw_units`).  The forward and the input grad never split;
#: the weight grad splits each group's vectors (:func:`dw_splits`).  The
#: input grad's thread is the forward's over (group, phase, b, oh, vector),
#: and its tap table holds every phase's taps, at most :data:`DW_MAX_TAPS`
#: in all, over at most :data:`DW_MAX_PHASES` phases.  Registers (the build
#: log): the forward 50-51 at 16 taps, 80-86 at 49; the input grad 51 and
#: 84-85; the weight grad 56-62 and 92-95; ``per_sm`` is the least the
#: float32 instances hold, the 49-tap one's (the forward 6, the others 5;
#: the 16-tap ones hold 9), held to the card by ``chip_smoke.py``.
DW = "dw"
DW_MAX_TAPS = 49
DW_THREADS = 128
DW_VEC = {"f32": 4, "bf16": 8}
#: the depthwise input grad's phases (strides up to 8 x 8): its PH + 1
#: phase starts beside the table's 3 x 49 ints make an 848-byte kernel
#: parameter, well inside the 4 KB a launch's parameters may take.
DW_MAX_PHASES = 64
#: the depthwise kernels' roles, in the order of ``tap_dw_blocks_per_sm``.
DW_ROLES = ("forward", "weight_grad", "input_grad")


def split_chunk(rows: int, splits: int, step: int) -> int:
    """Contraction rows of each split but the last, as the kernels cut
    them: ``rows / splits`` rounded up to whole steps."""
    return _cdiv(_cdiv(rows, splits), step) * step


def split_count(tile: Tile, tiles: int, rows: int, sms: int, groups: int,
                min_rows: int = MIN_SPLIT_ROWS) -> int:
    """Split-K factor of the weight grad and ``matmul``: enough splits that
    ``tiles`` output tiles (over all groups) fill the blocks the card holds
    at once (``tile.per_sm`` on each of ``sms`` SMs), but no split under
    ``min_rows`` (:data:`MIN_SPLIT_ROWS`) of the ``rows`` contraction rows,
    at most :data:`MAX_SPLITS`, and within the grid's z limit over
    ``groups``; rounded so that no split is empty once each is cut to whole
    steps (:func:`split_chunk`)."""
    s = max(1, min(tile.per_sm * sms // tiles, rows // min_rows,
                   MAX_SPLITS, GRID_YZ_MAX // groups))
    return _whole_splits(rows, s, tile.step)


def _whole_splits(rows: int, splits: int, step: int) -> int:
    """``splits`` rounded down to a count that leaves no split empty once
    ``rows`` are cut to whole steps."""
    return max(1, _cdiv(rows, max(step, split_chunk(rows, splits, step))))


def wgrad_plan(g: int, t: int, cin: int, cout: int, rows: int, sms: int,
               variant: str | None = None,
               min_rows: int = MIN_SPLIT_ROWS) -> tuple[str, int]:
    """``(variant, splits)`` of a weight grad of ``g`` groups, ``t`` taps,
    ``cin`` x ``cout`` channels and ``rows`` = B*oh*ow contraction rows on
    a card of ``sms`` SMs: the 64 x 16 tile for ``cout <= 16``, else
    64 x 64 (or the given ``variant``), over ``t * cin`` packed (tap,
    channel) output rows; splits of at least ``min_rows``."""
    variant = variant or ("64x16" if cout <= 16 else "64x64")
    tile = WGRAD_TILES[variant]
    tiles = _cdiv(t * cin, tile.rows) * _cdiv(cout, tile.cols) * g
    return variant, split_count(tile, tiles, rows, sms, g, min_rows)


#: input-grad variants (csrc/tap_gemm.cu, phased::kernel on tile::run), 64
#: threads a block: 64 x 64 with 8 x 8 outputs a thread (18,432 B of shared
#: memory), 64 x 16 with 4 x 4 for COUT <= 16 (12,288 B) and 128 x 8 with
#: 2 x 8 for COUT <= 8 (21,504 B).  ``per_sm`` as in :data:`WGRAD_TILES`,
#: held to the card by ``chip_smoke.py``.  The tile entry's ``variant`` is
#: the index in :data:`PHASED_VARIANTS`; the depthwise variant ``"dw"`` (one
#: channel a group) has entries of its own.
PHASED_TILES = {"64x64": Tile(64, 64, 16, 4), "64x16": Tile(64, 16, 16, 8),
                "128x8": Tile(128, 8, 16, 6), "dw": Tile(1, 1, 1, 5)}
PHASED_VARIANTS = ("64x64", "64x16", "128x8")


def phased_plan(g: int, counts, cin: int, cout: int, m: int, sms: int,
                variant: str | None = None,
                min_rows: int = MIN_SPLIT_ROWS) -> tuple[str, int]:
    """``(variant, splits)`` of an input grad of ``g`` groups whose phases
    run ``counts[p]`` taps of ``cin`` channels into ``cout`` channels over
    ``m`` = B*oh*ow output pixels each, on a card of ``sms`` SMs: the
    128 x 8 tile for ``cout <= 8``, 64 x 16 for ``cout <= 16``, else
    64 x 64.  ``splits`` is :func:`split_count` over the longest phase's
    ``counts[p] * cin`` rows and the output tiles of the phases with taps,
    each phase's tiles weighted by its share of the longest phase's rows:
    :func:`phased_work` cuts every phase to the longest phase's chunk
    length, so a shorter phase splits fewer ways (Table II layers 2 and 4,
    phases of 1, 2, 2 and 4 taps, count 2.25 phases, not 4).  A given
    ``variant`` replaces the rule's tile; ``min_rows`` is the split floor."""
    variant = variant or ("128x8" if cout <= 8 else
                          "64x16" if cout <= 16 else "64x64")
    tile = PHASED_TILES[variant]
    longest = max(counts, default=0)
    tiles = _cdiv(_cdiv(m, tile.rows) * _cdiv(cout, tile.cols) * g
                  * sum(counts), max(longest, 1))
    return variant, split_count(tile, max(tiles, 1), longest * cin, sms,
                                g * len(counts), min_rows)


def phased_work(counts, cin: int, splits: int, step: int):
    """The input-grad kernel's blocks for :func:`phased_plan`'s ``splits``:
    ``(work, sums, slots)``.

    ``work`` rows ``(phase, k_begin, k_end, slot)``, one per block z (per
    group): each active phase's ``counts[p] * cin`` contraction rows cut
    into chunks of :func:`split_chunk` of the longest phase (so every block
    walks at most one chunk), then one ``(p, 0, 0, -1)`` row per phase
    without taps, whose blocks store zeros.  A phase of one chunk writes the
    output itself (slot -1); the chunks of a phase that splits write
    partial planes ``slot``, ``slots`` in all, and ``sums`` holds its row
    ``(phase, first slot, count)`` for the fixed-order reduce.  Longer
    chunks come first, so the last blocks the card takes are the short."""
    return _phased_work(tuple(counts), cin, splits, step)


@functools.lru_cache(maxsize=4096)
def _phased_work(counts: tuple, cin: int, splits: int, step: int):
    k_max = max(counts, default=0) * cin
    chunk = split_chunk(k_max, splits, step) if k_max else 0
    work, zeros, sums = [], [], []
    slots = 0
    for p, n in enumerate(counts):
        k = n * cin
        if k == 0:
            zeros.append((p, 0, 0, -1))
            continue
        parts = _cdiv(k, chunk)
        if parts == 1:
            work.append((p, 0, k, -1))
            continue
        sums.append((p, slots, parts))
        work += [(p, i * chunk, min(k, (i + 1) * chunk), slots + i)
                 for i in range(parts)]
        slots += parts
    work.sort(key=lambda r: r[1] - r[2])         # stable: longest first
    return tuple(work + zeros), tuple(sums), slots


#: the forward's tile (csrc/tap_gemm.cu, fwd::kernel on tile::run):
#: 64 x 64 with 8 x 8 outputs a thread, 18,432 B of shared memory, 168
#: registers, 6 blocks an SM (its build log); and the depthwise variant
#: (:data:`DW`), which does not split.  The tile's analytic split rule is
#: :func:`forward_splits`; the tuner's candidates also try
#: :func:`split_count` over this tile.
FORWARD_TILES = {"64x64": Tile(64, 64, 16, 6), "dw": Tile(1, 1, 1, 6)}

#: plan role -> the variants its kernel has: the forward (``tap_gemm``),
#: the input grad (``tap_gemm_phased``), the weight grad (``tap_wgrad``).
ROLE_TILES = {"forward": FORWARD_TILES, "input_grad": PHASED_TILES,
              "weight_grad": WGRAD_TILES}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of a tap kernel: its ``role`` (a key of
    :data:`ROLE_TILES`), tile ``variant`` and split-K count ``splits``.
    The trailing fields are the tuner's record (``kernels/autotune.py``),
    metadata only: ``autotuned`` marks a measured winner, ``measured_us``
    its device time, ``candidates_timed`` how many candidates were timed,
    ``cache`` how the tuner resolved it (``hit``, ``miss``, ``stale`` or
    ``poisoned``).  An analytic plan leaves them at their defaults."""
    role: str
    variant: str
    splits: int
    autotuned: bool = False
    measured_us: float = -1.0
    candidates_timed: int = 0
    cache: str = ""

    @property
    def key(self) -> tuple[str, int]:
        return self.variant, self.splits


class Problem(NamedTuple):
    """What a tap kernel's plan depends on: ``groups``, the taps of each
    phase (``counts``: one entry for the forward and the weight grad), the
    contraction's channels ``cin``, the output's ``cout`` and ``m``, the
    output pixels (the weight grad: its contraction pixels) in rows of
    ``width`` (ow), and the operands' type (``dtype``, a value of
    :data:`DTYPES`: another kernel instance, so a plan timed in one type
    is never served to the other)."""
    role: str
    groups: int
    counts: tuple
    cin: int
    cout: int
    m: int
    width: int
    dtype: str = "f32"

    @property
    def rows(self) -> int:
        """Contraction rows of the longest split walk: the forward's taps x
        CIN, the input grad's longest phase's, the weight grad's pixels."""
        if self.role == "weight_grad":
            return self.m
        return max(self.counts, default=0) * self.cin


def dw_units(prob: Problem) -> int:
    """The vectors of one group under the depthwise variant: B*OH rows of
    ``cdiv(OW, V)``, V = :data:`DW_VEC` of the operand type (what the
    forward's threads take and the weight grad's splits cut)."""
    if prob.width <= 0:
        return 0
    return prob.m // prob.width * _cdiv(prob.width, DW_VEC[prob.dtype])


def dw_splits(prob: Problem, sms: int) -> int:
    """Split count of the depthwise weight grad on a card of ``sms`` SMs:
    enough (split, group) blocks to fill about two waves
    (``WGRAD_TILES["dw"].per_sm`` blocks on each SM), but no split of fewer
    vectors than :data:`DW_THREADS` (one a thread), at most
    :data:`MAX_SPLITS`, and none empty.  The CNN's 16 groups split;
    Mamba2's 2,304 do not."""
    units = dw_units(prob)
    waves = _cdiv(2 * WGRAD_TILES[DW].per_sm * sms, max(prob.groups, 1))
    return _whole_splits(units, max(1, min(waves, units // DW_THREADS,
                                           MAX_SPLITS)), 1)


def analytic_plan(prob: Problem, sms: int) -> Plan:
    """The rule's plan on a card of ``sms`` SMs: the depthwise variant for
    a pass of one channel a group where it can launch (:func:`_dw_gap`;
    split by :func:`dw_splits` for the weight grad), else
    :func:`forward_splits`, :func:`phased_plan` or :func:`wgrad_plan`."""
    g, counts, cin, cout, m = prob[1:6]
    if cin == cout == 1:
        plan = Plan(prob.role, DW, _dw_rule(prob, sms))
        if plan_gap(prob, plan) is None:
            return plan
    if prob.role == "forward":
        return Plan("forward", "64x64",
                    forward_splits(m, cout, counts[0], cin, sms, g))
    if prob.role == "input_grad":
        return Plan("input_grad", *phased_plan(g, counts, cin, cout, m, sms))
    return Plan("weight_grad", *wgrad_plan(g, counts[0], cin, cout, m, sms))


def plan_gap(prob: Problem, plan: Plan) -> str | None:
    """None when ``plan`` can launch ``prob``'s kernel, else why not: its
    role and variant must be the kernel's, ``1 <= splits <=``
    :data:`MAX_SPLITS`, no split empty once cut by :func:`split_chunk`,
    and the grid within the card's limits (:func:`launch_gap`; the input
    grad's z is its :func:`phased_work` rows x groups).  The depthwise
    variant has rules of its own (:func:`_dw_gap`)."""
    if plan.role != prob.role:
        return f"a {plan.role} plan for the {prob.role} kernel"
    tiles = ROLE_TILES[prob.role]
    if plan.variant not in tiles:
        return (f"the {prob.role} kernel has no variant {plan.variant!r} "
                f"(it has {tuple(tiles)})")
    s = plan.splits
    if not isinstance(s, int) or isinstance(s, bool) \
            or not 1 <= s <= MAX_SPLITS:
        return f"splits {s!r} outside 1..{MAX_SPLITS}"
    if plan.variant == DW:
        return _dw_gap(prob, s)
    tile, rows = tiles[plan.variant], prob.rows
    if s > 1 and (rows == 0
                  or _cdiv(rows, split_chunk(rows, s, tile.step)) != s):
        return f"{s} splits of {rows} contraction rows leave a split empty"
    z = s
    if prob.role == "input_grad":
        z = len(phased_work(prob.counts, prob.cin, s, tile.step)[0])
    return launch_gap(prob.m, prob.cout, z * prob.groups, tile.cols)


def _dw_rule(prob: Problem, sms: int) -> int:
    """The depthwise variant's split count: 1 for the forward and the input
    grad, which do not split; :func:`dw_splits` for the weight grad."""
    return dw_splits(prob, sms) if prob.role == "weight_grad" else 1


def _dw_gap(prob: Problem, splits: int) -> str | None:
    """None when the depthwise variant can run ``prob`` in ``splits``
    splits, else why not: one channel a group; 1 to :data:`DW_MAX_TAPS`
    taps (the input grad: at most :data:`DW_MAX_PHASES` phases whose taps
    together, the kernel's one table, are at most :data:`DW_MAX_TAPS`, so
    each phase's are too); a forward or input grad unsplit, no weight-grad
    split empty; and the grid's x (the forward's and the input grad's
    threads over :data:`DW_THREADS`, the weight grad's splits x groups)
    within 2^31 - 1."""
    if (prob.cin, prob.cout) != (1, 1):
        return (f"the dw variant takes one channel a group, not CIN "
                f"{prob.cin} x COUT {prob.cout}")
    if prob.role == "input_grad":
        ph, t = len(prob.counts), sum(prob.counts)
        if not 1 <= ph <= DW_MAX_PHASES:
            return (f"{ph} phases outside the dw input grad's "
                    f"1..{DW_MAX_PHASES}")
        if t > DW_MAX_TAPS:
            return (f"{t} taps over all phases exceed the dw input grad's "
                    f"table of {DW_MAX_TAPS}")
    else:
        ph, t = 1, prob.counts[0]
        if not 1 <= t <= DW_MAX_TAPS:
            return f"{t} taps outside the dw kernels' 1..{DW_MAX_TAPS}"
    if prob.m > INT32_MAX:
        return f"{prob.m} pixels exceed the kernels' 32-bit pixel index"
    units = dw_units(prob)
    if prob.role != "weight_grad":
        if splits != 1:
            return (f"the dw {prob.role.replace('_', ' ')} does not split "
                    f"(splits {splits})")
        blocks = _cdiv(prob.groups * ph * units, DW_THREADS)
    else:
        if splits > 1 and (units == 0 or _cdiv(
                units, split_chunk(units, splits, 1)) != splits):
            return (f"{splits} splits of {units} pixel vectors leave a "
                    "split empty")
        blocks = prob.groups * splits
    if blocks > INT32_MAX:
        return f"{blocks} blocks exceed the grid's x limit"
    return None


def _checked(name: str, prob: Problem, plan: Plan | None,
             device: torch.device, cuda: bool) -> Plan | None:
    """``plan`` checked to launch ``prob`` (raises if it cannot); None
    becomes the analytic plan on a ``cuda`` device's card, and stays None
    on the CPU (a CPU tensor's plain version has no plan)."""
    if plan is None and cuda:
        plan = analytic_plan(prob, _sms(device))
    gap = None if plan is None else plan_gap(prob, plan)
    if gap:
        raise ValueError(f"{name}: {gap}")
    return plan


def _rule_splits(prob: Problem, sms: int, variant: str,
                 min_rows: int) -> int:
    """The occupancy rule's split count for ``variant`` with a split floor
    of ``min_rows`` (the depthwise variant keeps its own floor)."""
    g, counts, cin, cout, m = prob[1:6]
    if variant == DW:
        return _dw_rule(prob, sms)
    if prob.role == "input_grad":
        return phased_plan(g, counts, cin, cout, m, sms, variant,
                           min_rows)[1]
    if prob.role == "weight_grad":
        return wgrad_plan(g, counts[0], cin, cout, m, sms, variant,
                          min_rows)[1]
    tile = FORWARD_TILES[variant]
    tiles = _cdiv(m, tile.rows) * _cdiv(cout, tile.cols) * g
    return split_count(tile, tiles, prob.rows, sms, g, min_rows)


def candidate_plans(prob: Problem, sms: int) -> list[Plan]:
    """The tuner's candidates, in order: :func:`analytic_plan`, the
    occupancy rule (:func:`split_count`) with its split floor at 32 and at
    16 rows instead of :data:`MIN_SPLIT_ROWS`, half and double the
    analytic split count (rounded to leave no split empty), then the
    role's other variants under the rule: a depthwise problem's plans
    include the tiles beside ``"dw"``.  Deduplicated, each valid
    (:func:`plan_gap`)."""
    head = analytic_plan(prob, sms)
    step = ROLE_TILES[prob.role][head.variant].step
    rows = dw_units(prob) if head.variant == DW else prob.rows
    splits = [_rule_splits(prob, sms, head.variant, 32),
              _rule_splits(prob, sms, head.variant, 16),
              _whole_splits(rows, max(1, head.splits // 2), step),
              _whole_splits(rows, min(MAX_SPLITS, 2 * head.splits), step)]
    plans = [head] + [Plan(prob.role, head.variant, s) for s in splits] + [
        Plan(prob.role, v, _rule_splits(prob, sms, v, MIN_SPLIT_ROWS))
        for v in ROLE_TILES[prob.role] if v != head.variant]
    out, seen = [], set()
    for plan in plans:
        if plan.key not in seen and plan_gap(prob, plan) is None:
            seen.add(plan.key)
            out.append(plan)
    return out


def phased_blocks_per_sm(variant: str, vec_a: bool, vec_b: bool,
                         bf16: bool = False) -> int:
    """Blocks of one input-grad instance (float32, or with ``bf16`` the
    bfloat16 one) an SM of the current card holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    blocks = ctypes.c_int(0)
    err = _lib().tap_gemm_phased_blocks_per_sm(
        PHASED_VARIANTS.index(variant), int(bf16), int(vec_a), int(vec_b),
        ctypes.addressof(blocks))
    if err != 0:
        raise RuntimeError(f"tap_gemm_phased_blocks_per_sm: CUDA error {err}")
    return blocks.value


def wgrad_blocks_per_sm(variant: str, vec_a: bool, vec_b: bool,
                        bf16: bool = False) -> int:
    """Blocks of one weight-grad instance (float32, or with ``bf16`` the
    bfloat16 one) an SM of the current card holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    blocks = ctypes.c_int(0)
    err = _lib().tap_wgrad_blocks_per_sm(int(variant == "64x16"), int(bf16),
                                         int(vec_a), int(vec_b),
                                         ctypes.addressof(blocks))
    if err != 0:
        raise RuntimeError(f"tap_wgrad_blocks_per_sm: CUDA error {err}")
    return blocks.value


def dw_blocks_per_sm(role: str, wide: bool, bf16: bool = False) -> int:
    """Blocks of one depthwise instance (the ``role``'s kernel, float32 or
    with ``bf16`` the bfloat16 one; ``wide``: the instance of 49 tap
    registers) an SM of the current card holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    blocks = ctypes.c_int(0)
    err = _lib().tap_dw_blocks_per_sm(DW_ROLES.index(role), int(bf16),
                                      int(wide), ctypes.addressof(blocks))
    if err != 0:
        raise RuntimeError(f"tap_dw_blocks_per_sm: CUDA error {err}")
    return blocks.value


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def tap_wgrad(src: torch.Tensor, dy: torch.Tensor, taps, oh: int, ow: int,
              plan: Plan | None = None) -> torch.Tensor:
    """Weight gradient: float32 ``([G,] T, CIN, COUT)`` summed over batch and
    space (float32 whatever the operands' type, as in the JAX kernel).

    src : ([G,] P, B, Hs, Ws, CIN)   phase-split padded input
    dy  : ([G,] B, oh, ow, COUT)     compact output loss

    ``plan``: a ``"weight_grad"`` :class:`Plan` (a tile and its split
    count, or the depthwise variant ``"dw"`` and its: :func:`dw_splits`),
    or None for :func:`analytic_plan`.
    """
    taps = tuple(tuple(int(v) for v in t) for t in taps)
    grouped = src.dim() == 6
    s6, d5 = (src, dy) if grouped else (src[None], dy[None])
    g, p, b, hs, ws, cin = s6.shape
    g2, b2, oh2, ow2, cout = d5.shape
    if (g2, b2, oh2, ow2) != (g, b, oh, ow):
        raise ValueError(f"tap_wgrad: src {tuple(src.shape)} / dy "
                         f"{tuple(dy.shape)} / ({oh}, {ow}) disagree")
    _check_taps("tap_wgrad", taps, p)
    t = len(taps)
    cuda = _on_cuda("tap_wgrad", src)
    dtype = _check_cuda("tap_wgrad", s6, d5) if cuda else src.dtype
    prob = Problem("weight_grad", g, (t,), cin, cout, b * oh * ow, ow,
                   DTYPES.get(dtype, "f32"))
    plan = _checked("tap_wgrad", prob, plan, src.device, cuda)
    if not cuda:
        return ref.tap_wgrad_ref(src, dy, taps, oh, ow)
    variant, splits = plan.variant, plan.splits
    out = torch.empty((g, t, cin, cout), dtype=torch.float32,
                      device=src.device)
    if out.numel() == 0:
        return out if grouped else out[0]
    part = out if splits == 1 else torch.empty(
        (splits, g, t, cin, cout), dtype=torch.float32, device=src.device)
    if variant == DW:
        _run("tap_wgrad", dtype, DW, s6.data_ptr(), d5.data_ptr(),
             ctypes.addressof(_host_table(taps)), part.data_ptr(),
             out.data_ptr(), g, p, b, hs, ws, t, oh, ow, splits,
             _stream(src))
    else:
        _run("tap_wgrad", dtype, variant, s6.data_ptr(), d5.data_ptr(),
             _table(taps, src.device).data_ptr(), part.data_ptr(),
             out.data_ptr(), g, p, b, hs, ws, cin, t, cout, oh, ow,
             int(variant == "64x16"), splits, _stream(src))
    return out if grouped else out[0]
