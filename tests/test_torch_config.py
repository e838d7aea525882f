"""The port's runtime config (``repro_torch.core.config``) against the JAX
package's (``repro.core.config``) for the fields they share: defaults, env
parsing, validation errors; then the frozen surface, scoped overrides and
the tuner's memo invalidation."""

import pytest

torch = pytest.importorskip("torch")

from repro.core import config as jcfg  # noqa: E402

from repro_torch.core import config as tcfg  # noqa: E402
from repro_torch.core.config import config  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402

SHARED = ("autotune", "autotune_top_k", "autotune_reps", "plan_cache_dir",
          "ssd_chunk", "blockwise_kv_threshold", "remat")


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
], ids=["empty", "cached", "all", "empty_dir", "unchecked", "zero_k",
        "attention", "empty_remat", "ssd_chunk"])
def test_env_parsing_equals_jax(env):
    assert _shared(tcfg.GlobalConfig(env=env)) == \
        _shared(jcfg.GlobalConfig(env=env))


@pytest.mark.parametrize("env", [{"REPRO_AUTOTUNE_TOP_K": "x"},
                                 {"REPRO_AUTOTUNE_REPS": "1.5"},
                                 {"REPRO_BLOCKWISE_THRESHOLD": "big"},
                                 {"REPRO_SSD_CHUNK": "q"}])
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
    dict(ssd_chunk=16.0),
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
              blockwise_kv_threshold=2048, remat="none")
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
