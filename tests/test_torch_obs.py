"""Telemetry of the port (``repro_torch.obs``) on the CPU: the counterparts
of ``tests/test_obs.py`` -- the disarmed path records nothing, the bus
agrees with the legacy counters, spans nest and export as Perfetto JSON
(``scripts/validate_trace.py``), the metrics stream -- and, against the JAX
package, the event kinds, the conv span annotations, and the keys of
``report()`` and of the ``train_step`` / ``serve_tick`` lines."""

import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core import conv as jconv  # noqa: E402
from repro.core.config import config as jconfig  # noqa: E402
from repro.core.convspec import ConvSpec as JSpec  # noqa: E402
from repro.core.convspec import ConvTransposeSpec as JTSpec  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402,F401  (metrics read it)

from repro_torch import obs  # noqa: E402
from repro_torch.ckpt import checkpoint as CKPT  # noqa: E402
from repro_torch.core import conv  # noqa: E402
from repro_torch.core.config import config  # noqa: E402
from repro_torch.core.convspec import ConvSpec, ConvTransposeSpec  # noqa: E402,E501
from repro_torch.ft import inject  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from scripts.validate_trace import validate_trace  # noqa: E402

SPEC = ConvSpec.make(stride=2, padding=1)


@pytest.fixture(autouse=True)
def _clean():
    saved, jsaved = config.snapshot(), jconfig.snapshot()
    obs.reset_all()
    yield
    config.update(**saved)
    jconfig.update(**jsaved)
    obs.reset_all()
    jobs.reset_all()


def _x(b=1):
    return torch.from_numpy(np.random.RandomState(0).randn(b, 3, 16, 16)
                            .astype(np.float32))


def _w():
    return torch.from_numpy((np.random.RandomState(1).randn(8, 3, 3, 3)
                             * 0.1).astype(np.float32))


class _NoFloat:
    """A metric value that fails the test if it is ever read."""

    def __float__(self):
        raise AssertionError("a disarmed run read a metric")


# ---------------------------------------------------------------------------
# Disarmed: telemetry off records nothing
# ---------------------------------------------------------------------------

def test_disarmed_records_nothing():
    assert not obs.enabled()
    conv.conv2d(_x(), _w(), SPEC, "bp_phase")
    assert conv.dispatch_events()
    assert obs.events.events() == [] == obs.events.events("dispatch")
    assert obs.events.counters("dispatch") == {}
    obs.events.emit("dispatch", "anything")
    obs.events.emit("not-a-kind", "anything")     # not even checked
    assert obs.events.events() == []


def test_disarmed_span_is_shared_null_singleton():
    assert not obs.trace.active()
    assert obs.trace.span("a", k=1) is obs.trace.span("b")
    d = conv.spec_dims((1, 3, 16, 16), (8, 3, 3, 3), SPEC)
    assert obs.trace.dispatch_span("forward", "bp_phase", d) \
        is obs.trace.span("c")
    assert obs.trace.export() is None


def test_disarmed_metrics_read_and_write_nothing():
    before = obs.metrics.lines_written()     # the last stream's count
    obs.metrics.train_step(0, {"loss": _NoFloat(), "grad_norm": _NoFloat()})
    obs.metrics.record_latency(0.1)
    obs.metrics.serve_tick(None)
    assert obs.metrics.lines_written() == before
    assert not obs.metrics.active()
    assert obs.metrics.summary()["latencies"] == 0


# ---------------------------------------------------------------------------
# The bus: legacy counters == bus views, exactly
# ---------------------------------------------------------------------------

def test_bus_matches_dispatch_events():
    with config.override(telemetry=True):
        assert obs.enabled()
        conv.conv2d(_x(), _w(), SPEC, "bp_phase")
        conv.conv2d(_x(), _w(), SPEC, "lax")
        legacy = conv.dispatch_events()
        assert legacy and obs.events.counters("dispatch") == legacy
        rep = obs.report()
        assert rep["consistent"], rep["divergences"]
        assert rep["events_by_kind"]["dispatch"] == sum(legacy.values())
    assert not obs.enabled()


def test_bus_sees_the_degradation_arc():
    with config.override(telemetry=True,
                         fault_spec="pallas.forward.launch:raise",
                         fault_seed=0):
        conv.conv2d(_x(), _w(), SPEC, "pallas")
        bus = obs.events.counters("dispatch")
        assert bus == conv.dispatch_events()
        assert bus["forward:pallas->bp_phase"] == 1
        fired = obs.events.events("fault")
        assert fired and fired[0]["tags"]["action"] == "raise"
        assert obs.report()["consistent"]


def test_plan_events_are_on_the_bus():
    from repro_torch.kernels import ops
    with config.override(telemetry=True):
        ops._count_event("forward_autotune_miss")
        assert obs.events.counters("plan") == ops.plan_events() == {
            "forward_autotune_miss": 1}
        ops.reset_plan_events()
        assert obs.events.counters("plan") == {}
        assert obs.report()["consistent"]


def test_legacy_reset_drops_bus_kind():
    with config.override(telemetry=True):
        conv.conv2d(_x(), _w(), SPEC, "bp_phase")
        obs.events.emit("train", "marker")
        conv.reset_dispatch_events()
        assert obs.events.counters("dispatch") == {} == \
            conv.dispatch_events()
        assert [e["name"] for e in obs.events.events()] == ["marker"]
        assert obs.report()["consistent"]


def test_report_flags_divergence():
    with config.override(telemetry=True):
        obs.events.emit("dispatch", "forward:ghost")
        rep = obs.report()
        assert not rep["consistent"]
        assert any("ghost" in d for d in rep["divergences"])


def test_unknown_kind_raises_when_enabled():
    with config.override(telemetry=True):
        with pytest.raises(ValueError, match="unregistered event kind"):
            obs.events.emit("nope", "x")


def test_bus_overflow_is_counted_not_silent(monkeypatch):
    monkeypatch.setattr(obs.events, "MAX_EVENTS", 3)
    with config.override(telemetry=True):
        for i in range(5):
            obs.events.emit("train", f"e{i}")
        assert len(obs.events.events()) == 3
        assert obs.events.dropped() == 2
        rep = obs.report()
        assert rep["events_dropped"] == 2 and rep["consistent"]


def test_reset_all_covers_every_surface():
    with config.override(telemetry=True,
                         fault_spec="pallas.forward.launch:raise"):
        conv.conv2d(_x(), _w(), SPEC, "pallas")
        CKPT._record_skip("step_x", "test")
        assert conv.dispatch_events() and inject.fired_events()
        assert conv.quarantined_engines() and obs.events.events()
        obs.reset_all()
        assert conv.dispatch_events() == {} and inject.fired_events() == []
        assert not conv.quarantined_engines()
        assert CKPT.skipped_checkpoints() == []
        assert obs.events.events() == [] and obs.events.dropped() == 0


# ---------------------------------------------------------------------------
# Against JAX: kinds, annotations, report and line keys
# ---------------------------------------------------------------------------

def test_event_kinds_equal_jax():
    """The same kinds (``halo`` too) with the same descriptions; the
    emitting-module column names the port's files."""
    assert list(obs.events.KINDS) == list(jobs.events.KINDS)
    for kind, (_, desc) in obs.events.KINDS.items():
        assert desc == jobs.events.KINDS[kind][1]
    assert obs.events.MAX_EVENTS == jobs.events.MAX_EVENTS


GEOMS = [
    ("strided", (2, 3, 16, 16), (8, 3, 3, 3), dict(stride=2, padding=1)),
    ("asym", (1, 4, 17, 12), (6, 4, 3, 2), dict(stride=(2, 3), padding=1)),
    ("dilated", (1, 3, 16, 16), (8, 3, 3, 3),
     dict(stride=2, padding=2, dilation=2)),
    ("grouped", (2, 8, 12, 12), (8, 2, 3, 3),
     dict(stride=2, padding=1, groups=4)),
    ("transposed", (1, 8, 8, 8), (8, 4, 3, 3),
     dict(stride=2, padding=1, output_padding=1)),
    ("transposed_dilated", (2, 6, 5, 7), (6, 2, 3, 3),
     dict(stride=(2, 3), padding=2, dilation=2, groups=2)),
]


@pytest.mark.parametrize("name,xs,ws,kw", GEOMS, ids=[g[0] for g in GEOMS])
def test_conv_annotations_equal_jax(name, xs, ws, kw):
    if name.startswith("transposed"):
        d = conv.transpose_dims(xs, ws, ConvTransposeSpec.make(**kw))
        jd = jconv.transpose_dims(xs, ws, JTSpec.make(**kw))
    else:
        d = conv.spec_dims(xs, ws, ConvSpec.make(**kw))
        jd = jconv.spec_dims(xs, ws, JSpec.make(**kw))
    t = name.startswith("transposed")
    assert obs.trace.conv_annotations(d, transposed=t) == \
        jobs.trace.conv_annotations(jd, transposed=t)
    if t:
        taps = conv.transpose_tap_counts(d)
        ann = obs.trace.conv_annotations(d, transposed=True)
        assert ann["taps"] == {"real": taps["real"],
                               "materialized": taps["zero_inserted"]}


def test_report_keys_equal_jax():
    with config.override(telemetry=True), jconfig.override(telemetry=True):
        mine, theirs = obs.report(), jobs.report()
    assert set(mine) == set(theirs)
    for key in ("trace", "metrics", "legacy", "events_by_kind"):
        assert set(mine[key]) == set(theirs[key]), key
    assert set(obs.finalize()) == set(jobs.finalize())


class _Engine:
    engine_kind = "static"
    max_batch = 4
    counters = {"decode_steps": 5, "completed": 2, "timed_out": 1,
                "failed": 0}
    stats = {"lane_steps": 12, "tokens": 20, "decode_s": 0.5}


def _lines(tmp_path, pkg, cfg, name):
    out = tmp_path / name
    with cfg.override(telemetry=True, metrics_path=str(out)):
        for lat in (0.1, 0.2, 0.3):
            pkg.metrics.record_latency(lat)
        pkg.metrics.train_step(0, {"loss": 1.5, "grad_norm": 0.2,
                                   "lr": 1e-3, "guard_bad": 0.0,
                                   "guard_streak": 0.0,
                                   "guard_clipped": 0.0}, step_s=0.01)
        pkg.metrics.serve_tick(_Engine())
    return [json.loads(ln) for ln in out.read_text().splitlines()]


def test_metrics_lines_equal_jax(tmp_path):
    conv.conv2d(_x(), _w(), SPEC, "bp_phase")
    jconv.conv2d(jnp.asarray(_x().numpy()), jnp.asarray(_w().numpy()),
                 stride=2, padding=1, policy="bp_phase")
    mine = _lines(tmp_path, obs, config, "t.jsonl")
    theirs = _lines(tmp_path, jobs, jconfig, "j.jsonl")
    assert [ln["kind"] for ln in mine] == ["train_step", "serve_tick"]
    for a, b in zip(mine, theirs):
        assert set(a) == set(b)
        for k in set(a) - {"ts", "plan_cache_hit_rate"}:
            assert a[k] == b[k], k
    assert mine[0]["dispatch_mix"] == {"bp_phase": 1}
    assert mine[1]["p50_s"] == 0.2 and mine[1]["occupancy"] == 0.6


def test_metrics_read_tensors_only_when_active(tmp_path):
    out = tmp_path / "m.jsonl"
    with config.override(telemetry=True, metrics_path=str(out)):
        obs.metrics.train_step(3, {"loss": torch.tensor(1.25),
                                   "guard_bad": torch.tensor(0.0)})
    line = json.loads(out.read_text())
    assert line["loss"] == 1.25 and line["guard_bad"] == 0.0
    assert line["plan_cache_hit_rate"] is None    # no plan on the CPU


# ---------------------------------------------------------------------------
# Spans: nesting, annotations, Perfetto export, profiler pass-through
# ---------------------------------------------------------------------------

def test_trace_export_validates(tmp_path):
    out = tmp_path / "trace.json"
    with config.override(telemetry=True, trace_path=str(out)):
        with obs.trace.span("outer", step=0):
            with obs.trace.span("inner"):
                conv.conv2d(_x(), _w(), SPEC, "bp_phase")
        assert obs.trace.export() == str(out)
    doc = json.loads(out.read_text())
    problems, stats = validate_trace(doc)
    assert problems == []
    assert stats["b_names"][:3] == ["outer", "inner",
                                    "conv:forward:bp_phase"]
    assert doc["otherData"]["producer"] == "repro_torch.obs.trace"


def test_spans_enter_the_profilers_record_function(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with config.override(telemetry=True, trace_path=str(tmp_path / "t")):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.trace.span("train:step", step=0):
                conv.conv2d(_x(), _w(), SPEC, "bp_phase")
    names = {e.key for e in prof.key_averages()}
    assert {"train:step", "conv:forward:bp_phase"} <= names


def test_async_checkpoint_span_has_its_own_lane(tmp_path):
    out = tmp_path / "trace.json"
    with config.override(telemetry=True, trace_path=str(out)):
        with obs.trace.span("train:step", step=0):
            CKPT.save(str(tmp_path / "ck"), 0, {"x": np.ones(2)},
                      blocking=False)
        CKPT.wait()
        CKPT.restore(str(tmp_path / "ck"), device="cpu")
        obs.trace.export()
        assert [e["name"] for e in obs.events.events("ckpt")] == \
            ["write", "restore"]
    doc = json.loads(out.read_text())
    assert validate_trace(doc)[0] == []
    lanes = {e["name"]: e["tid"] for e in doc["traceEvents"]}
    assert lanes["ckpt:write"] != lanes["train:step"]


def test_serving_spans_events_and_ticks(tmp_path):
    from repro_torch.launch import serve as tserve
    from repro_torch.serve.continuous import ContinuousEngine
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.request import Request
    cfg = tserve.get_smoke_config("smollm-360m")
    params = tserve.init_params(cfg, 0, "cpu")
    for cls in (ContinuousEngine, Engine):
        t, m = tmp_path / f"{cls.__name__}.json", tmp_path / "m.jsonl"
        with config.override(telemetry=True, trace_path=str(t),
                             metrics_path=str(m)):
            eng = cls(cfg, params, max_batch=2, max_len=16)
            for rid in range(3):
                eng.submit(Request(rid=rid, prompt=[1, 2, 3], max_new=3))
            eng.run()
            rep = obs.finalize()
            serve_ev = [e["name"] for e in obs.events.events("serve")]
        problems, stats = validate_trace(json.loads(t.read_text()))
        assert problems == [] and rep["consistent"]
        lines = [json.loads(ln) for ln in m.read_text().splitlines()]
        assert len(lines) == eng.counters["decode_steps"] and all(
            ln["kind"] == "serve_tick" for ln in lines)
        assert serve_ev.count("finalize:completed") == 3
        spans = set(stats["b_names"])
        if cls is ContinuousEngine:
            assert {"serve:prefill", "serve:insert", "serve:decode"} <= spans
            assert serve_ev.count("admit") == serve_ev.count("insert") == 3
            assert lines[-1]["completed"] == 3   # ticks after the release
        else:
            assert {"serve:prefill", "serve:decode"} <= spans
            assert serve_ev.count("wave") == 2
        obs.reset_all()
