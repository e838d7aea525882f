#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Phases, one JSON object per line on stdout (``--out`` also writes them to
PATH):

  1. device   -- the card's name and power limit (``nvidia-smi``), library
                 versions; TF32 is switched off for every library call.
  2. build    -- ``nvcc`` builds the CUDA kernels from ``src/repro_torch/csrc``.
  3. kernels  -- for each of the paper's Table II layers (batch 2, float32)
                 and the three convs of the training run (batch 32), and
                 each tap-GEMM kernel: the kernel against its plain
                 PyTorch version on the same operands (largest error relative
                 to the largest plain value, tolerance ``REL_TOL``), then the
                 device time per call of the kernel, the plain version and
                 the library call for the same pass (a CUDA graph of 10
                 back-to-back calls replayed between CUDA events, median of
                 10), the host time per kernel call, and the least time the
                 card could take (``bound_us``).
  4. layers   -- each Table II layer through ``conv2d(x, w, spec, "pallas")``
                 and ``.backward()``, against ``policy="lax"``; each kernel
                 launches exactly once per pass.
  5. train    -- ``python -m repro_torch.train.cnn_bp --policy pallas`` at its
                 defaults (200 steps, batch 32) must reach eval accuracy > 0.9
                 with all three kernels launched; its first 20 losses agree
                 with a ``lax`` run from the same initialization; a shorter
                 run under the default ``auto`` policy.
  6. summary  -- every ported kernel with its launches in the training run.

Then a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase raises, so the script exits non-zero and prints no result;
it also does so without a CUDA device or without the package beside it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

#: kernel vs plain version: max |kernel - plain| / max |plain| (float32,
#: contractions of up to 24,642 terms summed in another order).
REL_TOL = 1e-4
#: conv2d under "pallas" vs under "lax" on the card, same measure.
LAYER_TOL = 1e-4
#: first 20 training losses, pallas vs lax from one initialization.
LOSS_TOL = 1e-4
#: H100 SXM float32 peak outside the tensor cores and memory rate (data sheet).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

KERNELS = {
    "tap_gemm": "src/repro/kernels/tap_gemm.py:173",
    "tap_gemm_phased": "src/repro/kernels/tap_gemm.py:226",
    "tap_wgrad": "src/repro/kernels/tap_gemm.py:285",
}
SOURCE = "src/repro_torch/csrc/tap_gemm.cu"


class Smoke:
    def __init__(self, out: pathlib.Path | None):
        self.out = open(out, "w") if out else None

    def emit(self, phase: str, **fields) -> None:
        line = json.dumps({"phase": phase, **fields})
        print(line, flush=True)
        if self.out:
            self.out.write(line + "\n")
            self.out.flush()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(torch, fn, batches: int = 10, calls: int = 10,
            warm: int = 3) -> float:
    """Device time per call: ``calls`` back-to-back calls, captured in one
    CUDA graph after ``warm`` calls, replayed ``batches`` times between two
    CUDA events; the median replay over ``calls``.  A replay runs the device
    work without the host's cost of each call, so a small kernel reads its
    own time, not its launch cost.  Operands stay warm in L2 (the same
    tensors every call)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    return statistics.median(times)


def host_ms(torch, fn, calls: int = 100) -> float:
    """Host time per call of ``fn`` called back to back without waiting for
    the device: Python, the wrapper's checks and the launch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def rel_err(torch, got, want) -> tuple[float, float]:
    check(got.shape == want.shape, f"shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff / max(scale, 1e-30), diff


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, nbytes_: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes_ / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(smoke, torch, F, nn_grad, ops, tg, ref, shapes, dev):
    """Each kernel at each shape against its plain version.  ``shapes``
    holds ``(label, per-group ConvDims, groups, summed)``; the rows with
    ``summed`` make up the totals of the final ``kernels`` line."""
    agg = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
               "bytes": 0.0, "max_abs_err": 0.0} for k in KERNELS}
    for i, (layer, d, g, summed) in enumerate(shapes):
        gen = torch.Generator().manual_seed(i)
        x = torch.randn(d.B, d.C * g, d.H_i, d.W_i, generator=gen).to(dev)
        w = torch.randn(d.N * g, d.C, d.K_h, d.K_w, generator=gen).to(dev)
        dy = torch.randn(d.B, d.N * g, d.H_o, d.W_o, generator=gen).to(dev)
        stride, pad = (d.s_h, d.s_w), (d.P_h, d.P_w)
        macs = g * d.N * d.C          # per output pixel and tap

        src, wt, taps = ops.forward_operands(x, w, d, g)
        fwd = (lambda: tg.tap_gemm(src, wt, taps, d.H_o, d.W_o),
               lambda: ref.tap_gemm_ref(src, wt, taps, d.H_o, d.W_o),
               lambda: F.conv2d(x, w, stride=stride, padding=pad, groups=g),
               2.0 * d.B * d.H_o * d.W_o * macs * len(taps),
               nbytes(src, wt), {})
        gsrc, ws, pp = ops.input_grad_operands(dy, w, d, g)
        n_taps = sum(len(t) for t in pp.phase_taps)
        dgrad = (lambda: tg.tap_gemm_phased(gsrc, ws, pp.phase_taps, pp.n_qh,
                                            pp.n_qw),
                 lambda: ref.tap_gemm_phased_ref(gsrc, ws, pp.phase_taps,
                                                 pp.n_qh, pp.n_qw),
                 lambda: nn_grad.conv2d_input(x.shape, w, dy, stride=stride,
                                              padding=pad, groups=g),
                 2.0 * d.B * pp.n_qh * pp.n_qw * macs * n_taps,
                 # only the weight rows the taps read: the stacks of
                 # phases without taps are zeros the kernel never loads
                 nbytes(gsrc) + 4 * n_taps * macs,
                 {"active_phases": sum(1 for t in pp.phase_taps if t)})
        wsrc, dyn, wtaps = ops.weight_grad_operands(x, dy, d, g)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tiles = (tg._cdiv(d.C, tg.TILE_M) * tg._cdiv(d.N, tg.TILE_N)
                 * len(wtaps) * g)
        wgrad = (lambda: tg.tap_wgrad(wsrc, dyn, wtaps, d.H_o, d.W_o),
                 lambda: ref.tap_wgrad_ref(wsrc, dyn, wtaps, d.H_o, d.W_o),
                 lambda: nn_grad.conv2d_weight(x, w.shape, dy, stride=stride,
                                               padding=pad, groups=g),
                 2.0 * d.B * d.H_o * d.W_o * macs * len(wtaps),
                 nbytes(wsrc, dyn), {"splits": tg.wgrad_splits(
                     tiles, d.B * d.H_o * d.W_o, sms)})

        for name, (kern, plain, lib, flops, in_bytes, extra) in zip(
                KERNELS, (fwd, dgrad, wgrad)):
            before = tg.launch_counts()[name]
            got = kern()
            launches = tg.launch_counts()[name] - before
            want = plain()
            torch.cuda.synchronize()
            err, abs_err = rel_err(torch, got, want)
            if name == "tap_wgrad":
                again = kern()
                check(bool(torch.equal(got, again)),
                      f"{name} differs run to run at {layer}")
            by = in_bytes + nbytes(got)
            b_s, b_by = bound(flops, by)
            rec = {"kernel": name, "layer": layer, "groups": g,
                   "max_rel_err": err, "max_abs_err": abs_err,
                   "tol": REL_TOL, "launches_per_call": launches,
                   "kernel_ms": time_ms(torch, kern),
                   "kernel_host_ms": host_ms(torch, kern),
                   "plain_ms": time_ms(torch, plain),
                   "library_ms": time_ms(torch, lib),
                   "bound_us": b_s * 1e6, "bound_by": b_by,
                   "gflop": flops / 1e9, "mbytes": by / 1e6, **extra}
            rec["roofline_share"] = rec["bound_us"] / 1e3 / rec["kernel_ms"]
            smoke.emit("kernels", **rec)
            check(launches == 1, f"{name}: {launches} launches for one call")
            check(err <= REL_TOL, f"{name} at {layer}: relative error {err} "
                                  f"> {REL_TOL}")
            if not summed:
                continue
            a = agg[name]
            for k in ("ms", "plain_ms", "library_ms"):
                a[k] += rec["kernel_ms" if k == "ms" else k]
            a["flops"] += flops
            a["bytes"] += by
            a["max_abs_err"] = max(a["max_abs_err"], abs_err)
    return agg


def cnn_shapes(ConvDims):
    """The three convs of ``repro_torch.train.cnn_bp`` at its defaults
    (batch 32, 16x16 input): the shapes its training run gives the
    kernels.  Per-group dims; the depthwise layer has 16 groups of 1."""
    return [("cnn.c1 16/3/16/3/2/1", ConvDims(B=32, C=3, H_i=16, W_i=16,
                                              N=16, K_h=3, K_w=3, S=2,
                                              P_h=1, P_w=1), 1, False),
            ("cnn.dw 8/16/16/3/1/1 g16", ConvDims(B=32, C=1, H_i=8, W_i=8,
                                                  N=1, K_h=3, K_w=3, S=1,
                                                  P_h=1, P_w=1), 16, False),
            ("cnn.c2 8/16/32/3/2/1", ConvDims(B=32, C=16, H_i=8, W_i=8,
                                              N=32, K_h=3, K_w=3, S=2,
                                              P_h=1, P_w=1), 1, False)]


def phase_layers(smoke, torch, conv, tg, ConvSpec, table2, dev):
    """Each Table II layer through the normal entry point, vs lax."""
    for i, (layer, d) in enumerate(table2):
        gen = torch.Generator().manual_seed(100 + i)
        x0 = torch.randn(d.B, d.C, d.H_i, d.W_i, generator=gen).to(dev)
        w0 = torch.randn(d.N, d.C, d.K_h, d.K_w, generator=gen).to(dev)
        dy = torch.randn(d.B, d.N, d.H_o, d.W_o, generator=gen).to(dev)
        spec = ConvSpec.make(stride=d.s_h, padding=d.P_h)
        outs = {}
        for policy in ("pallas", "lax"):
            x = x0.clone().requires_grad_(True)
            w = w0.clone().requires_grad_(True)
            conv.reset_dispatch_events()
            tg.reset_launch_counts()
            y = conv.conv2d(x, w, spec, policy)
            y.backward(dy)
            torch.cuda.synchronize()
            outs[policy] = (y.detach(), x.grad, w.grad,
                            tg.launch_counts(), conv.dispatch_events())
        errs = [rel_err(torch, a, b)[0]
                for a, b in zip(outs["pallas"][:3], outs["lax"][:3])]
        counts, events = outs["pallas"][3], outs["pallas"][4]
        smoke.emit("layers", layer=layer, rel_err_y=errs[0],
                   rel_err_dx=errs[1], rel_err_dw=errs[2], tol=LAYER_TOL,
                   launches=counts, dispatch=events)
        check(counts == {k: 1 for k in KERNELS},
              f"{layer}: launches {counts}, want one per pass")
        check(max(errs) <= LAYER_TOL, f"{layer}: pallas vs lax {errs}")
        check(outs["lax"][3] == {k: 0 for k in KERNELS},
              "lax policy launched a tap-GEMM kernel")


def phase_train(smoke, torch, conv, tg, cnn_bp, dev):
    """The trainer's CLI at its defaults under pallas, then lax and auto."""
    conv.reset_dispatch_events()
    tg.reset_launch_counts()
    res = cnn_bp.main(["--policy", "pallas", "--device", str(dev)])  # floor
    counts = tg.launch_counts()
    events = conv.dispatch_events()
    smoke.emit("train", policy="pallas", steps=len(res["losses"]),
               eval_acc=res["eval_acc"], seconds=res["seconds"],
               first_loss=res["losses"][0], last_loss=res["losses"][-1],
               launches=counts, dispatch=events)
    check(res["eval_acc"] > 0.9, f"eval accuracy {res['eval_acc']} <= 0.9")
    check(all(counts[k] > 0 for k in KERNELS),
          f"a kernel was never launched on the main path: {counts}")
    check(set(events) == {"forward:pallas", "input_grad:pallas",
                          "weight_grad:pallas"}, f"dispatch {events}")

    lax = cnn_bp.train("lax", steps=20, device=dev)
    diff = max(abs(a - b) for a, b in zip(res["losses"][:20], lax["losses"]))
    smoke.emit("train", policy="lax", steps=20, max_loss_diff_vs_pallas=diff,
               tol=LOSS_TOL, seconds=lax["seconds"])
    check(diff <= LOSS_TOL, f"pallas vs lax losses differ by {diff}")

    conv.reset_dispatch_events()
    auto = cnn_bp.train("auto", steps=50, device=dev)
    events = conv.dispatch_events()
    smoke.emit("train", policy="auto", steps=50, eval_acc=auto["eval_acc"],
               last_loss=auto["losses"][-1], seconds=auto["seconds"],
               dispatch=events)
    check(all(map(lambda v: v == v and abs(v) < 1e3, auto["losses"])),
          "auto run produced non-finite losses")
    check(events.get("forward:pallas", 0) > 0
          and events.get("forward:bp_phase", 0) > 0,
          f"auto should run strided convs on pallas, the depthwise stride-1 "
          f"conv on bp_phase: {events}")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the phase lines to this file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    from torch.nn import grad as nn_grad

    from repro_torch.configs import paper_cnn
    from repro_torch.core import conv
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.core.im2col_ref import ConvDims
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import tap_gemm as tg
    from repro_torch.train import cnn_bp

    smoke = Smoke(args.out)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    smoke.emit("device", nvidia_smi=smi, kind=kind,
               count=torch.cuda.device_count(), torch=torch.__version__,
               cuda=torch.version.cuda,
               cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
               matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    t0 = time.perf_counter()
    libs = build.build()
    ptxas = [ln.strip() for log in build.build_dir().glob("*.log")
             for ln in log.read_text().splitlines()
             if re.search(r"registers|spill|Compiling entry", ln)]
    smoke.emit("build", seconds=time.perf_counter() - t0,
               libraries={k: str(v) for k, v in libs.items()}, ptxas=ptxas)

    table2 = [("/".join(map(str, layer)), paper_cnn.dims(layer))
              for layer in paper_cnn.TABLE2_LAYERS]
    dev = torch.device("cuda")
    agg = phase_kernels(smoke, torch, F, nn_grad, ops, tg, ref,
                        [(label, d, 1, True) for label, d in table2]
                        + cnn_shapes(ConvDims), dev)
    phase_layers(smoke, torch, conv, tg, ConvSpec, table2, dev)
    counts = phase_train(smoke, torch, conv, tg, cnn_bp, dev)
    smoke.emit("summary", launches=counts)

    kernels = []
    for name, replaces in KERNELS.items():
        a = agg[name]
        b_s, b_by = bound(a["flops"], a["bytes"])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": a["max_abs_err"], "ms": a["ms"],
            "plain_ms": a["plain_ms"], "bound_ms": b_s * 1e3,
            "bound_by": b_by, "library_ms": a["library_ms"],
            "shapes": "sum over the 5 Table II layers, batch 2, float32"})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
