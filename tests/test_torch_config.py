"""The port's runtime config (``repro_torch.core.config``) against the JAX
package's (``repro.core.config``) for the fields they share (the tuner's,
the model knobs, and fault injection and telemetry): defaults, env
parsing, validation errors; then the frozen surface, scoped overrides, the
tuner's memo invalidation, and the injector and telemetry re-synced on a
change."""

import pytest

torch = pytest.importorskip("torch")

from repro.core import config as jcfg  # noqa: E402

from repro_torch.core import config as tcfg  # noqa: E402
from repro_torch.core.config import config  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402

SHARED = ("autotune", "autotune_top_k", "autotune_reps", "plan_cache_dir",
          "ssd_chunk", "blockwise_kv_threshold", "remat", "fault_spec",
          "fault_seed", "telemetry", "trace_path", "metrics_path")


@pytest.fixture(autouse=True)
def _restore_config():
    saved = config.snapshot()
    yield
    config.update(**saved)


def _shared(cfg) -> dict:
    return {name: getattr(cfg, name) for name in SHARED}


def test_fields_and_env_names_equal_jax():
    assert set(tcfg.FIELDS) == set(SHARED)
    assert tcfg.AUTOTUNE_MODES == jcfg.AUTOTUNE_MODES
    for name in SHARED:
        mine, theirs = tcfg.FIELDS[name], jcfg.FIELDS[name]
        assert (mine.env, mine.default, mine.plan_affecting) == \
            (theirs.env, theirs.default, theirs.plan_affecting), name


@pytest.mark.parametrize("env", [
    {},
    {"REPRO_AUTOTUNE": "cached"},
    {"REPRO_AUTOTUNE": "measure", "REPRO_AUTOTUNE_TOP_K": "7",
     "REPRO_AUTOTUNE_REPS": "2", "REPRO_PLAN_CACHE_DIR": "/plans"},
    {"REPRO_PLAN_CACHE_DIR": ""},            # empty -> None
    {"REPRO_AUTOTUNE": "bogus"},             # env values are not checked
    {"REPRO_AUTOTUNE_TOP_K": "0"},
    {"REPRO_BLOCKWISE_THRESHOLD": "256", "REPRO_REMAT": "none"},
    {"REPRO_REMAT": ""},                     # empty -> None
    {"REPRO_SSD_CHUNK": "64"},
    {"REPRO_FAULT_SPEC": "pallas.*:raise@step3", "REPRO_FAULT_SEED": "7",
     "REPRO_TELEMETRY": "1", "REPRO_TRACE_PATH": "/t.json",
     "REPRO_METRICS_PATH": "/m.jsonl"},
    {"REPRO_FAULT_SPEC": "", "REPRO_TELEMETRY": "off",
     "REPRO_TRACE_PATH": "", "REPRO_METRICS_PATH": ""},   # empty -> None
    {"REPRO_TELEMETRY": " No ", "REPRO_FAULT_SEED": "-3"},
    {"REPRO_TELEMETRY": "anything"},         # not a false word -> True
], ids=["empty", "cached", "all", "empty_dir", "unchecked", "zero_k",
        "attention", "empty_remat", "ssd_chunk", "faults_telemetry",
        "empty_obs", "telemetry_no", "telemetry_word"])
def test_env_parsing_equals_jax(env):
    assert _shared(tcfg.GlobalConfig(env=env)) == \
        _shared(jcfg.GlobalConfig(env=env))


@pytest.mark.parametrize("env", [{"REPRO_AUTOTUNE_TOP_K": "x"},
                                 {"REPRO_AUTOTUNE_REPS": "1.5"},
                                 {"REPRO_BLOCKWISE_THRESHOLD": "big"},
                                 {"REPRO_SSD_CHUNK": "q"},
                                 {"REPRO_FAULT_SEED": "1.5"}])
def test_unparsable_env_raises_like_jax(env):
    with pytest.raises(ValueError):
        jcfg.GlobalConfig(env=env)
    with pytest.raises(ValueError):
        tcfg.GlobalConfig(env=env)


@pytest.mark.parametrize("kw", [
    dict(autotune="fast"), dict(autotune=None), dict(autotune_top_k=0),
    dict(autotune_top_k=-2), dict(autotune_top_k=True),
    dict(autotune_top_k="3"), dict(autotune_reps=0), dict(autotune_reps=2.0),
    dict(plan_cache_dir=3), dict(blockwise_kv_threshold=0),
    dict(blockwise_kv_threshold=512.0), dict(remat=1), dict(ssd_chunk=0),
    dict(ssd_chunk=16.0), dict(fault_spec=3),
    dict(fault_spec="bogus.site:raise"), dict(fault_spec="ckpt.write:boom"),
    dict(fault_spec="ckpt.write:raise~p2"), dict(fault_seed=True),
    dict(fault_seed=1.5), dict(telemetry=1), dict(telemetry="yes"),
    dict(trace_path=3), dict(metrics_path=b"m"),
], ids=lambda kw: "-".join(f"{k}={v!r}" for k, v in kw.items()))
def test_update_validation_errors_equal_jax(kw):
    mine, theirs = tcfg.GlobalConfig(env={}), jcfg.GlobalConfig(env={})
    with pytest.raises(ValueError) as want:
        theirs.update(**kw)
    with pytest.raises(ValueError) as got:
        mine.update(**kw)
    assert str(got.value) == str(want.value)
    assert _shared(mine) == _shared(tcfg.GlobalConfig(env={}))


def test_valid_updates_equal_jax():
    mine, theirs = tcfg.GlobalConfig(env={}), jcfg.GlobalConfig(env={})
    kw = dict(autotune="cached", autotune_top_k=2, autotune_reps=5,
              plan_cache_dir="/plans", ssd_chunk=64,
              blockwise_kv_threshold=2048, remat="none",
              fault_spec="pallas.*:raise@step3;grad.values:nan@5",
              fault_seed=-2, telemetry=True, trace_path="/t.json",
              metrics_path="/m.jsonl")
    mine.update(**kw)
    theirs.update(**kw)
    assert _shared(mine) == _shared(theirs) == kw


def test_unknown_field_and_direct_assignment_raise():
    with pytest.raises(ValueError, match="unknown config field"):
        config.update(interpret=False)
    with pytest.raises(AttributeError, match="no field"):
        config.vmem_budget_bytes
    with pytest.raises(AttributeError, match="frozen"):
        config.autotune = "measure"


def test_snapshot_is_a_plain_copy():
    snap = config.snapshot()
    assert set(snap) == set(SHARED)
    snap["autotune"] = "measure"
    assert config.autotune == tcfg.GlobalConfig().autotune


def test_a_bad_value_stores_nothing():
    before = config.snapshot()
    with pytest.raises(ValueError):
        config.update(autotune_top_k=9, autotune_reps=0)
    assert config.snapshot() == before


def test_override_restores_on_exit_and_on_exception():
    before = config.snapshot()
    with config.override(autotune="cached", plan_cache_dir="/p") as c:
        assert c is config and config.autotune == "cached"
    assert config.snapshot() == before
    with pytest.raises(RuntimeError):
        with config.override(autotune="measure", autotune_top_k=2):
            assert config.autotune_top_k == 2
            raise RuntimeError("boom")
    assert config.snapshot() == before


@pytest.mark.parametrize("field,value", [
    ("autotune", "cached"), ("autotune_top_k", 9), ("autotune_reps", 7),
    ("plan_cache_dir", "/elsewhere")])
def test_plan_affecting_change_clears_the_memo(field, value):
    autotune._MEMO["k"] = "plan"
    config.update(**{field: getattr(config, field)})    # same value
    assert autotune._MEMO == {"k": "plan"}
    config.update(**{field: value})
    assert autotune._MEMO == {}


def test_fault_and_telemetry_changes_resync_their_modules(tmp_path):
    from repro_torch import obs
    from repro_torch.ft import inject
    config.update(fault_spec="ckpt.write:raise", fault_seed=4)
    assert inject.armed_rules() and inject._RNG.random() == \
        __import__("random").Random(4).random()
    config.update(fault_spec=None)
    assert not inject.armed_rules()
    with config.override(telemetry=True, trace_path=str(tmp_path / "t"),
                         metrics_path=str(tmp_path / "m")):
        assert obs.enabled() and obs.trace.active() and obs.metrics.active()
    assert not (obs.enabled() or obs.trace.active() or obs.metrics.active())
