#!/usr/bin/env python3
"""Host time of one ``conv2d`` call of the PyTorch/CUDA port against the
same call in another checkout (its parent), both in ONE process on one
card, window by window in turns.

    python3 tools/conv_host_ms.py --parent DIR [--rounds 3000] [--out PATH]

The checkout holding this script is the child.  ``DIR`` is a checkout of
the parent (``git archive`` of the parent commit unpacked into a
git-ignored directory); its ``src/repro_torch`` is copied into a temporary
directory as the package ``repro_torch_parent`` (every ``repro_torch``
name rewritten), so both import side by side and share the host, the
card, the CUDA context and, where the kernel sources are equal, the built
kernel libraries.  Separate processes drift by tens of microseconds from
one to the next on a one-card machine, which shares its host's cores;
windows of one process, taken in turns, do not.

At each of the paper's five Table II layers (batch 2, float32,
``policy="pallas"``, analytic plans, telemetry and fault injection off)
it times the host side of one ``conv2d`` forward (no grad) and of one
forward + backward (weight grad only, as the images need none): each
call alone on the host clock, without waiting for the card (Python, the
dispatch, the wrapper's checks and the launches; the card is waited for
every 50 rounds, outside the timed calls).  Each of ``--rounds`` rounds
(a third as many for forward + backward) times one call of the
library's ``F.conv2d`` on the same operands (``lib``), then one call of
each side, the side going first alternating from round to round, so the
host's drift falls on both sides alike.  Per layer it prints each side's
median call, the median and quartiles of the rounds' child-minus-parent
differences in microseconds, and each side's median ratio to its
round's ``lib`` call.

Then it counts, with ``cProfile``, the Python function calls one forward
makes on each side at the first layer, lists the functions whose call
counts differ (what the child adds to or takes from the path), and times
on this host, with ``timeit``, a call of each piece a disarmed child
adds to a pass (``added_ns_a_call``; ``nothing`` is the cost of the
empty call each is wrapped in).

Prints the card's name and power limit first, one JSON line per layer,
and one JSON line of the call counts; ``--out`` also writes them as JSON
lines.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import cProfile
import importlib
import json
import pathlib
import pstats
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
PARENT_PKG = "repro_torch_parent"


def load_parent(checkout: pathlib.Path, tmp: pathlib.Path):
    """Import ``checkout``'s ``src/repro_torch`` as :data:`PARENT_PKG`."""
    dst = tmp / PARENT_PKG
    shutil.copytree(checkout / "src" / "repro_torch", dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path in dst.rglob("*.py"):
        path.write_text(re.sub(r"\brepro_torch\b", PARENT_PKG,
                               path.read_text()))
    sys.path.insert(0, str(tmp))
    return importlib.import_module(PARENT_PKG)


def side(pkg: str):
    """The modules of one side: conv, ConvSpec, config, build."""
    conv = importlib.import_module(f"{pkg}.core.conv")
    spec = importlib.import_module(f"{pkg}.core.convspec").ConvSpec
    config = importlib.import_module(f"{pkg}.core.config").config
    build = importlib.import_module(f"{pkg}.kernels.build")
    config.update(autotune="off", plan_cache_dir=None)
    return conv, spec, build


def paired_rounds(torch, library, parent, child, rounds: int,
                  sync_every: int = 50) -> dict[str, list[float]]:
    """Host microseconds of each call, by side, over ``rounds`` rounds of
    one ``library`` call and one call of each side, the side going first
    alternating; the card is waited for every ``sync_every`` rounds,
    outside the timed calls."""
    t = {"lib": [], "parent": [], "child": []}
    clock = time.perf_counter_ns
    for r in range(rounds):
        if r % sync_every == 0:
            torch.cuda.synchronize()
        order = (("lib", library), ("parent", parent), ("child", child)) \
            if r % 2 == 0 else (("lib", library), ("child", child),
                                ("parent", parent))
        for nm, fn in order:
            t0 = clock()
            fn()
            t[nm].append((clock() - t0) / 1e3)
    torch.cuda.synchronize()
    return t


def added_calls_ns(pkg: str, d) -> dict[str, float]:
    """Nanoseconds a call, on this host, of what a disarmed child adds to
    one pass: the fault site, the null span, the bus's emit, a closure
    made and called."""
    import timeit
    inject = importlib.import_module(f"{pkg}.ft.inject")
    trace = importlib.import_module(f"{pkg}.obs.trace")
    events = importlib.import_module(f"{pkg}.obs.events")
    def span():
        with trace.dispatch_span("forward", "pallas", d):
            pass

    stmts = {
        "fault_point": lambda: inject.fault_point("pallas.forward.launch"),
        "dispatch_span": span,
        "emit": lambda: events.emit("dispatch", "forward:pallas"),
        "closure": lambda: (lambda eng: eng)(d),
        "nothing": lambda: None,
    }
    out = {}
    for name, fn in stmts.items():
        n = 100_000
        out[name] = min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e9
    return out


def call_counts(fn, calls: int = 200) -> dict[str, float]:
    """Python function calls per ``fn()`` by ``file:function`` (the
    package prefix and line numbers dropped, so both sides line up)."""
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    out: dict[str, float] = {}
    for (file, _, name), (_, nc, *_) in pstats.Stats(prof).stats.items():
        file = re.sub(r".*/(repro_torch(_parent)?)/", "", file)
        key = f"{file}:{name}"
        out[key] = out.get(key, 0.0) + nc / calls
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True)
    ap.add_argument("--rounds", type=int, default=3000)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("conv_host_ms: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sys.path.insert(0, str(ROOT / "src"))
    records = []
    with tempfile.TemporaryDirectory(prefix="conv_host_ms_") as tmp:
        load_parent(args.parent.resolve(), pathlib.Path(tmp))
        child, parent = side("repro_torch"), side(PARENT_PKG)
        # Equal kernel sources hash to one build directory: build once.
        parent[2].BUILD_ROOT = child[2].BUILD_ROOT
        layers = importlib.import_module(
            "repro_torch.configs.paper_cnn").TABLE2_LAYERS
        dev = torch.device("cuda")
        sides = {"parent": parent, "child": child}
        profile_fns = {}
        for i, layer in enumerate(layers):
            h, c, n, k, s, p = layer
            gen = torch.Generator().manual_seed(i)
            x = torch.randn(2, c, h, h, generator=gen).to(dev)
            w = torch.randn(n, c, k, k, generator=gen).to(dev) \
                .requires_grad_(True)
            fns = {}

            def library():
                with torch.no_grad():
                    return F.conv2d(x, w, stride=s, padding=p)
            for name, (conv, spec_cls, _) in sides.items():
                spec = spec_cls.make(stride=s, padding=p)

                def forward(conv=conv, spec=spec, x=x, w=w):
                    with torch.no_grad():
                        return conv.conv2d(x, w, spec, "pallas")

                def train(conv=conv, spec=spec, x=x, w=w):
                    y = conv.conv2d(x, w, spec, "pallas")
                    return torch.autograd.grad(y.sum(), [w])
                fns[name] = {"forward": forward, "fwd_bwd": train}
            if i == 0:
                profile_fns = {nm: fns[nm]["forward"] for nm in sides}
            for fn in (library, *(f for nm in sides
                                  for f in fns[nm].values())):
                for _ in range(20):
                    fn()
            rec = {"layer": "/".join(map(str, layer)), "nvidia_smi": smi}
            for kind, rounds in (("forward", args.rounds),
                                 ("fwd_bwd", args.rounds // 3)):
                t = paired_rounds(torch, library, fns["parent"][kind],
                                  fns["child"][kind], rounds)
                diff = sorted(c - p for c, p in zip(t["child"], t["parent"]))
                rec[f"{kind}_rounds"] = rounds
                for nm in ("parent", "child"):
                    rec[f"{kind}_{nm}_median_us"] = statistics.median(t[nm])
                    rec[f"{kind}_{nm}_over_lib"] = statistics.median(
                        a / b for a, b in zip(t[nm], t["lib"]))
                rec[f"{kind}_child_minus_parent_us"] = {
                    "median": statistics.median(diff),
                    "q1": diff[len(diff) // 4], "q3": diff[3 * len(diff) // 4]}
                if kind == "forward":
                    rec["lib_median_us"] = statistics.median(t["lib"])
            print(json.dumps(rec), flush=True)
            records.append(rec)
        counts = {nm: call_counts(fn) for nm, fn in profile_fns.items()}
        keys = sorted(set(counts["parent"]) | set(counts["child"]))
        changed = {k: [round(counts["parent"].get(k, 0.0), 3),
                       round(counts["child"].get(k, 0.0), 3)]
                   for k in keys if abs(counts["parent"].get(k, 0.0)
                                        - counts["child"].get(k, 0.0)) > 0.01}
        h, c, n, k, s, p = layers[0]
        d = child[0].make_dims((2, c, h, h), (n, c, k, k), s, p)
        rec = {"python_calls_per_forward": {
            nm: round(sum(v.values()), 3) for nm, v in counts.items()},
            "layer": records[0]["layer"], "changed_parent_child": changed,
            "added_ns_a_call": added_calls_ns("repro_torch", d),
            "nvidia_smi": smi}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
