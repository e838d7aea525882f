"""Wrappers of the hand-written CUDA tap-GEMM kernels (``csrc/tap_gemm.cu``).

Counterpart of ``repro.kernels.tap_gemm``: the same three multi-tap GEMMs
over phase-split, channels-last compact operands,

  * ``tap_gemm``        forward conv
  * ``tap_gemm_phased`` input grad (transposed mode), all stride phases in
                        one launch
  * ``tap_wgrad``       weight grad (dilated mode), float32 output

with an optional leading group dim on every operand, so a grouped or
depthwise conv is one launch per pass.  On a CUDA tensor a wrapper checks
its operands, launches its kernel (built at first use by
``repro_torch.kernels.build``) or raises; it never falls back.  On a CPU
tensor it returns the plain version from ``repro_torch.kernels.ref``.
``LAUNCHES`` counts kernel launches per wrapper (CUDA only).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

#: kernel launches per wrapper, counted only where the CUDA kernel launches.
LAUNCHES: dict[str, int] = {"tap_gemm": 0, "tap_gemm_phased": 0,
                            "tap_wgrad": 0}

#: the forward's and the input grad's fixed output tile (must match
#: fwd::BM, fwd::BN and BM, BN in csrc/tap_gemm.cu; the weight grad's tiles
#: are :data:`WGRAD_TILES`).
TILE_M, TILE_N = 64, 64
GRID_YZ_MAX = 65_535
INT32_MAX = 2**31 - 1


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_gap(m: int, cout: int, grid_z: int) -> str | None:
    """None when a launch with ``m`` output rows (or contraction rows),
    ``cout`` columns and ``grid_z`` groups (x phases for the input grad)
    fits the kernels' limits, else why not.  The tiles are fixed and no
    halo is staged, so shared memory (18,432 B per forward block, 8,448 B
    per input-grad block, 16,384 B or 10,240 B per weight-grad block)
    never depends on the geometry; only the grid and the 32-bit row index
    can overflow.  The forward's and the weight grad's split counts keep
    their grids' z within the limit (:func:`wgrad_splits`,
    :func:`split_count`)."""
    if m > INT32_MAX:
        return f"{m} rows exceed the kernels' 32-bit row index"
    if _cdiv(cout, TILE_N) > GRID_YZ_MAX:
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
    lib.tap_gemm_f32.argtypes = [_P] * 5 + [_I] * 11 + [_P]
    lib.tap_gemm_phased_f32.argtypes = [_P] * 5 + [_I] * 10 + [_P]
    lib.tap_wgrad_f32.argtypes = [_P] * 5 + [_I] * 12 + [_P]
    lib.tap_wgrad_blocks_per_sm.argtypes = [_I] * 3 + [_P]
    for fn in (lib.tap_gemm_f32, lib.tap_gemm_phased_f32, lib.tap_wgrad_f32,
               lib.tap_wgrad_blocks_per_sm):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1024)
def _table(rows: tuple, device: torch.device) -> torch.Tensor:
    """A tap table as a small int32 tensor on ``device`` (cached: tables
    depend only on the static geometry)."""
    return torch.tensor(rows, dtype=torch.int32, device=device).reshape(-1)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _run(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


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


def tap_gemm(src: torch.Tensor, w: torch.Tensor, taps, oh: int,
             ow: int) -> torch.Tensor:
    """Forward multi-tap GEMM.

    src : ([G,] P, B, Hs, Ws, CIN)   phase-split compact source
    w   : ([G,] T, CIN, COUT)        per-tap weight slices, T == len(taps)
    out : ([G,] B, oh, ow, COUT)
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
    if not _on_cuda("tap_gemm", src):
        return ref.tap_gemm_ref(src, w, taps, oh, ow)
    _check_cuda("tap_gemm", s6, w4)
    m = b * oh * ow
    gap = launch_gap(m, cout, g)
    if gap:
        raise ValueError(f"tap_gemm: {gap}")
    splits = forward_splits(m, cout, t, cin, _sms(src.device), g)
    out = torch.empty((g, b, oh, ow, cout), dtype=torch.float32,
                      device=src.device)
    part = out if splits == 1 else torch.empty(
        (splits, g, b, oh, ow, cout), dtype=torch.float32, device=src.device)
    _run("tap_gemm", _lib().tap_gemm_f32, s6.data_ptr(), w4.data_ptr(),
         _table(taps, src.device).data_ptr(), part.data_ptr(),
         out.data_ptr(), g, p, b, hs, ws, cin, t, cout, oh, ow, splits,
         _stream(src))
    return out if grouped else out[0]


def tap_gemm_phased(src: torch.Tensor, w: torch.Tensor, phase_taps, oh: int,
                    ow: int) -> torch.Tensor:
    """All-phases input-grad tap GEMM in ONE launch.

    src : ([G,] B, Hs, Ws, CIN)       globally padded compact dY, shared by
                                      every phase
    w   : ([G,] PH, T, CIN, COUT)     per-phase tap weights, zero-padded to T
    out : ([G,] PH, B, oh, ow, COUT)  phase-major planes; a phase without
                                      taps is all zeros

    ``phase_taps[p]`` is a tuple of ``(j, du, dv)``: tap j of phase p reads
    the source window at offset (du, dv).
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
    if not _on_cuda("tap_gemm_phased", src):
        return ref.tap_gemm_phased_ref(src, w, phase_taps, oh, ow)
    _check_cuda("tap_gemm_phased", s5, w5)
    m = b * oh * ow
    gap = launch_gap(m, cout, g * ph)
    if gap:
        raise ValueError(f"tap_gemm_phased: {gap}")
    counts = tuple(len(taps) for taps in phase_taps)
    rows = tuple(v for taps in phase_taps
                 for r in (*taps, *((0, 0, 0),) * (t - len(taps))) for v in r)
    out = torch.empty((g, ph, b, oh, ow, cout), dtype=torch.float32,
                      device=src.device)
    _run("tap_gemm_phased", _lib().tap_gemm_phased_f32, s5.data_ptr(),
         w5.data_ptr(), _table(counts, src.device).data_ptr(),
         _table(rows, src.device).data_ptr(), out.data_ptr(),
         g, ph, b, hs, ws, cin, t, cout, oh, ow, _stream(src))
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
    contraction of ``taps * cin`` rows (a tap's channels, tap after tap)."""
    tiles = _cdiv(m, TILE_M) * _cdiv(cout, TILE_N) * groups
    return wgrad_splits(tiles, taps * cin, sms, groups)


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
WGRAD_TILES = {"64x64": Tile(64, 64, 16, 6), "64x16": Tile(64, 16, 16, 14)}


def split_chunk(rows: int, splits: int, step: int) -> int:
    """Contraction rows of each split but the last, as the kernels cut
    them: ``rows / splits`` rounded up to whole steps."""
    return _cdiv(_cdiv(rows, splits), step) * step


def split_count(tile: Tile, tiles: int, rows: int, sms: int,
                groups: int) -> int:
    """Split-K factor of the weight grad and ``matmul``: enough splits that
    ``tiles`` output tiles (over all groups) fill the blocks the card holds
    at once (``tile.per_sm`` on each of ``sms`` SMs), but no split under
    :data:`MIN_SPLIT_ROWS` of the ``rows`` contraction rows, at most
    :data:`MAX_SPLITS`, and within the grid's z limit over ``groups``;
    rounded so that no split is empty once each is cut to whole steps
    (:func:`split_chunk`)."""
    s = max(1, min(tile.per_sm * sms // tiles, rows // MIN_SPLIT_ROWS,
                   MAX_SPLITS, GRID_YZ_MAX // groups))
    return max(1, _cdiv(rows, max(tile.step, split_chunk(rows, s,
                                                          tile.step))))


def wgrad_plan(g: int, t: int, cin: int, cout: int, rows: int,
               sms: int) -> tuple[str, int]:
    """``(variant, splits)`` of a weight grad of ``g`` groups, ``t`` taps,
    ``cin`` x ``cout`` channels and ``rows`` = B*oh*ow contraction rows on
    a card of ``sms`` SMs: the 64 x 16 tile for ``cout <= 16``, else
    64 x 64, over ``t * cin`` packed (tap, channel) output rows."""
    variant = "64x16" if cout <= 16 else "64x64"
    tile = WGRAD_TILES[variant]
    tiles = _cdiv(t * cin, tile.rows) * _cdiv(cout, tile.cols) * g
    return variant, split_count(tile, tiles, rows, sms, g)


def wgrad_blocks_per_sm(variant: str, vec_a: bool, vec_b: bool) -> int:
    """Blocks of one weight-grad instance an SM of the current card holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    blocks = ctypes.c_int(0)
    err = _lib().tap_wgrad_blocks_per_sm(int(variant == "64x16"), int(vec_a),
                                         int(vec_b), ctypes.addressof(blocks))
    if err != 0:
        raise RuntimeError(f"tap_wgrad_blocks_per_sm: CUDA error {err}")
    return blocks.value


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def tap_wgrad(src: torch.Tensor, dy: torch.Tensor, taps, oh: int,
              ow: int) -> torch.Tensor:
    """Weight gradient: float32 ``([G,] T, CIN, COUT)`` summed over batch and
    space.

    src : ([G,] P, B, Hs, Ws, CIN)   phase-split padded input
    dy  : ([G,] B, oh, ow, COUT)     compact output loss
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
    if not _on_cuda("tap_wgrad", src):
        return ref.tap_wgrad_ref(src, dy, taps, oh, ow)
    _check_cuda("tap_wgrad", s6, d5)
    t = len(taps)
    rows = b * oh * ow
    gap = launch_gap(rows, cout, g)
    if gap:
        raise ValueError(f"tap_wgrad: {gap}")
    variant, splits = wgrad_plan(g, t, cin, cout, rows, _sms(src.device))
    out = torch.empty((g, t, cin, cout), dtype=torch.float32,
                      device=src.device)
    if out.numel() == 0:
        return out if grouped else out[0]
    part = out if splits == 1 else torch.empty(
        (splits, g, t, cin, cout), dtype=torch.float32, device=src.device)
    _run("tap_wgrad", _lib().tap_wgrad_f32, s6.data_ptr(), d5.data_ptr(),
         _table(taps, src.device).data_ptr(), part.data_ptr(),
         out.data_ptr(), g, p, b, hs, ws, cin, t, cout, oh, ow,
         int(variant == "64x16"), splits, _stream(src))
    return out if grouped else out[0]
