"""Fault injection and runtime degradation of the port
(``repro_torch.ft.inject``, ``repro_torch.core.conv._execute``), on the
CPU: the counterparts of ``tests/test_faults.py``.

Against the JAX package: the fault-spec grammar (rules and errors), the
registries, and the degradation arc itself -- one ``flaky`` engine
registered in both packages (``bp_phase`` that raises ``InjectedFault`` on
a schedule), driven through 8 ``conv2d`` grad calls, with
``dispatch_events()``, ``runtime_failures()`` and ``quarantined_engines()``
equal after every call.  On the port's own ``pallas`` engine (its plain
versions here): degradation with the weight re-derived for the survivor,
quarantine and probe, the chaos drill and its losses against a JAX loop,
the coverage of every site, the plan cache's sites and poisoning, the
checkpoint writer's fault, the guard's ``grad.values`` step and the
continuous engine's failed lanes.
"""

import dataclasses
import pathlib
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import conv as jconv  # noqa: E402
from repro.core.config import config as jconfig  # noqa: E402
from repro.ft import inject as jinject  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.ckpt import checkpoint as CKPT  # noqa: E402
from repro_torch.core import conv  # noqa: E402
from repro_torch.core.config import config  # noqa: E402
from repro_torch.core.convspec import ConvSpec, ConvTransposeSpec  # noqa: E402,E501
from repro_torch.core.im2col_ref import ConvDims  # noqa: E402
from repro_torch.ft import inject  # noqa: E402
from repro_torch.ft.inject import InjectedFault, parse_fault_spec  # noqa: E402,E501
from repro_torch.kernels import autotune, ops, timing  # noqa: E402
from repro_torch.kernels import tap_gemm as tg  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import chaos  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
H100 = autotune.Card("NVIDIA H100 80GB HBM3", (9, 0), 132)


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends with both injectors disarmed, the clock
    at 0 and every introspection surface of the port clean."""
    saved, jsaved = config.snapshot(), jconfig.snapshot()
    config.update(fault_spec=None)
    inject.set_step(0)
    obs.reset_all()
    yield
    config.update(**saved)
    config.update(fault_spec=None)
    jconfig.update(**jsaved)
    jconfig.update(fault_spec=None)
    inject.set_step(0)
    jinject.set_step(0)
    obs.reset_all()


def _x(b=2, c=3, h=16):
    return torch.from_numpy(np.random.RandomState(0).randn(b, c, h, h)
                            .astype(np.float32))


def _w(n=8, c=3, k=3):
    return torch.from_numpy((np.random.RandomState(1).randn(n, c, k, k)
                             * 0.1).astype(np.float32))


def _grads(x, w, policy, spec=None, transpose=False):
    """y and (dx, dw) of sum(y**2) under ``policy``."""
    x = x.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    spec = spec or ConvSpec.make(stride=2, padding=1)
    fn = conv.conv2d_transpose if transpose else conv.conv2d
    y = fn(x, w, spec, policy)
    return (y.detach(), *torch.autograd.grad(y.square().sum(), [x, w]))


def _rel(a, b) -> float:
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


# ---------------------------------------------------------------------------
# The grammar and the registries, against JAX
# ---------------------------------------------------------------------------

VALID = ["pallas.*:raise@step3;grad.values:nan@5;ckpt.write:raise~p0.5",
         "serve.decode:raise@step3", "*:raise@step999999",
         "plan_cache.*:raise", " ckpt.read:nan ; ;serve.prefill:raise~p1",
         "pallas.[fw]*:raise@7~p0.25", ""]
INVALID = ["nonexistent.site:raise", "pallas.*:explode", "pallas.*",
           "ckpt.write:raise@stepx", "ckpt.write:raise~p1.5",
           "serve.decode:raise@-1", "grad.values:nan;bogus:raise"]


@pytest.mark.parametrize("spec", VALID)
def test_parse_equals_jax(spec):
    got = [dataclasses.astuple(r) for r in parse_fault_spec(spec)]
    want = [dataclasses.astuple(r) for r in jinject.parse_fault_spec(spec)]
    assert got == want


@pytest.mark.parametrize("spec", INVALID)
def test_parse_errors_equal_jax(spec):
    with pytest.raises(ValueError) as want:
        jinject.parse_fault_spec(spec)
    with pytest.raises(ValueError) as got:
        parse_fault_spec(spec)
    assert str(got.value) == str(want.value)


def test_sites_and_actions_equal_jax():
    assert inject.KNOWN_SITES == jinject.KNOWN_SITES
    assert inject.ACTIONS == jinject.ACTIONS
    assert len(inject.KNOWN_SITES) == 11


def test_config_validates_before_storing():
    with pytest.raises(ValueError, match="matches no known site"):
        config.update(fault_spec="bogus.site:raise")
    assert config.fault_spec is None and not inject.armed_rules()


def test_config_arms_and_disarms_injector():
    config.update(fault_spec="ckpt.write:raise", fault_seed=3)
    assert inject.armed_rules() == parse_fault_spec("ckpt.write:raise")
    config.update(fault_spec=None)
    assert not inject.armed_rules()


def test_probability_stream_is_seeded():
    """A '~pP' rule fires on the same calls for the same (spec, seed)."""
    def pattern(seed):
        config.update(fault_spec=None)           # re-arm: a fresh stream
        config.update(fault_spec="ckpt.read:raise~p0.5", fault_seed=seed)
        hits = []
        for _ in range(32):
            try:
                inject.fault_point("ckpt.read")
                hits.append(0)
            except InjectedFault:
                hits.append(1)
        return hits
    a, b, c = pattern(1), pattern(1), pattern(2)
    assert a == b and a != c and 0 < sum(a) < 32


# ---------------------------------------------------------------------------
# Disarmed: nothing is recorded
# ---------------------------------------------------------------------------

def test_fault_point_is_identity_when_disarmed():
    tree = {"a": torch.ones(3)}
    assert inject.fault_point("grad.values", value=tree) is tree
    assert inject.fault_point("ckpt.write") is None
    assert inject.value_fault_steps("grad.values") is None
    assert inject.fired_events() == [] and inject.seen_sites() == set()


def test_unknown_site_only_checked_when_armed():
    assert inject.fault_point("not.a.site", value=1) == 1
    config.update(fault_spec="ckpt.write:raise")
    with pytest.raises(ValueError, match="unregistered fault site"):
        inject.fault_point("not.a.site")


def test_nan_action_poisons_floating_tensors_only():
    config.update(fault_spec="grad.values:nan@step4")
    tree = {"f": torch.ones(2), "i": torch.ones(2, dtype=torch.int32)}
    assert inject.fault_point("grad.values", value=tree) is tree  # step 0
    inject.set_step(4)
    out = inject.fault_point("grad.values", value=tree)
    assert torch.isnan(out["f"]).all() and torch.equal(out["i"], tree["i"])
    assert inject.fired_events() == [{"site": "grad.values", "action": "nan",
                                      "step": 4, "pattern": "grad.values"}]


# ---------------------------------------------------------------------------
# The degradation arc, against JAX, through one flaky engine in both
# ---------------------------------------------------------------------------

#: call index -> the passes of the flaky engine that raise in that call.
FLAKY_FAILS = {"forward": {0, 3}, "input_grad": {1},
               "weight_grad": set(range(8))}


@pytest.fixture
def flaky():
    """``flaky`` registered in both packages: ``bp_phase``'s passes,
    raising each package's ``InjectedFault`` where :data:`FLAKY_FAILS`
    says; ``state["call"]`` is the index of the conv2d call."""
    state = {"call": 0}

    def wrap(fn, pass_name, fault_cls, rule):
        def run(*args):
            if state["call"] in FLAKY_FAILS[pass_name]:
                raise fault_cls(f"pallas.{pass_name}.launch", rule)
            return fn(*args)
        return run

    for mod, fault in ((conv, inject), (jconv, jinject)):
        bp = mod.ENGINES["bp_phase"]
        rule = fault.FaultRule("flaky", "raise")
        mod.register_engine(
            "flaky",
            *(wrap(getattr(bp, p), p, fault.InjectedFault, rule)
              for p in ("forward", "input_grad", "weight_grad")))
    yield state
    conv.ENGINES.pop("flaky")
    jconv.ENGINES.pop("flaky")


def _strip(failures):
    return [{k: v for k, v in f.items() if k != "error"} for f in failures]


def _arc_step(x, w):
    """One grad call through ``flaky`` in each package; the port's and
    JAX's (y, dw)."""
    y, _, dw = _grads(x, w, "flaky")
    jx, jw = jnp.asarray(x.numpy()), jnp.asarray(w.numpy())

    def loss(ww):
        return jnp.sum(jconv.conv2d(jx, ww, stride=2, padding=1,
                                    policy="flaky") ** 2)
    jdw = jax.grad(loss)(jw)
    return dw, np.asarray(jdw)


@pytest.mark.parametrize("probe_after", [3, 2])
def test_degradation_arc_equals_jax_call_by_call(flaky, probe_after,
                                                 monkeypatch):
    monkeypatch.setattr(conv, "QUARANTINE_PROBE_AFTER", probe_after)
    monkeypatch.setattr(jconv, "QUARANTINE_PROBE_AFTER", probe_after)
    jconv.reset_dispatch_events()
    x, w = _x(), _w()
    for call in range(8):
        flaky["call"] = call
        dw, jdw = _arc_step(x, w)
        np.testing.assert_allclose(dw.numpy(), jdw, rtol=1e-4, atol=1e-4)
        assert conv.dispatch_events() == jconv.dispatch_events(), call
        assert _strip(conv.runtime_failures()) == \
            _strip(jconv.runtime_failures()), call
        assert conv.quarantined_engines() == jconv.quarantined_engines(), \
            call
    ev = conv.dispatch_events()
    assert ev["forward:flaky:recovered"] == 1
    # weight_grad fails at every probe: re-armed, never recovered.
    assert "weight_grad:flaky:recovered" not in ev
    assert ev["weight_grad:flaky:probe"] >= 1
    assert [q["pass"] for q in conv.quarantined_engines()] == ["weight_grad"]
    if probe_after == 2:
        assert ev["forward:flaky:probe"] == 2     # one failed, one recovered


def test_every_engine_failing_raises_the_first_exception_like_jax(
        flaky, monkeypatch):
    """``lax`` is terminal: with ``bp_phase`` and ``lax`` broken too, the
    flaky engine's InjectedFault (the first exception) propagates, in both
    packages, with the same failures recorded."""
    def bad(*a, **k):
        raise RuntimeError("engine down")

    for mod in (conv, jconv):
        for name in ("bp_phase", "lax"):
            monkeypatch.setitem(mod.ENGINES, name, dataclasses.replace(
                mod.ENGINES[name], forward=bad))
    jconv.reset_dispatch_events()
    flaky["call"] = 0
    with pytest.raises(InjectedFault):
        conv.conv2d(_x(), _w(), ConvSpec.make(stride=2, padding=1), "flaky")
    with pytest.raises(jinject.InjectedFault):
        jconv.conv2d(jnp.asarray(_x().numpy()), jnp.asarray(_w().numpy()),
                     stride=2, padding=1, policy="flaky")
    assert _strip(conv.runtime_failures()) == _strip(
        jconv.runtime_failures())
    assert [f["engine"] for f in conv.runtime_failures()] == \
        ["flaky", "bp_phase", "lax"]
    assert conv.dispatch_events() == jconv.dispatch_events() == {}


def test_absorbs_only_injected_faults_on_the_card():
    rule = inject.FaultRule("pallas.*", "raise")
    fault = InjectedFault("pallas.forward.launch", rule)
    err = RuntimeError("tap_gemm: CUDA launch failed")
    assert inject.absorbs(fault, "cuda") and inject.absorbs(fault, "cpu")
    assert not inject.absorbs(err, "cuda")
    assert not inject.absorbs(err, torch.device("cuda", 0))
    assert inject.absorbs(err, "cpu")


@pytest.mark.parametrize("injected", [False, True])
def test_on_the_card_only_an_injected_fault_degrades(injected,
                                                     monkeypatch):
    """On the card (stood in for by what ``inject.absorbs`` answers for a
    CUDA device) a kernel pass that raises anything but an injected fault
    propagates unchanged and leaves no trace: no failure edge, no
    quarantine, no plan poisoned, no dispatch event.  An injected fault
    still degrades to ``bp_phase``."""
    absorbs = inject.absorbs
    monkeypatch.setattr(inject, "absorbs",
                        lambda exc, device: absorbs(exc, "cuda"))
    err = (InjectedFault("pallas.forward.launch",
                         inject.FaultRule("pallas.*", "raise"))
           if injected else RuntimeError("tap_gemm: CUDA launch failed"))

    def broken(*a, **k):
        raise err

    poisoned = []
    monkeypatch.setattr(conv, "_poison_plan_entry",
                        lambda *a: poisoned.append(a))
    monkeypatch.setitem(conv.ENGINES, "pallas", dataclasses.replace(
        conv.ENGINES["pallas"], forward=broken))
    x, w, spec = _x(), _w(), ConvSpec.make(stride=2, padding=1)
    if not injected:
        with pytest.raises(RuntimeError, match="launch failed"):
            conv.conv2d(x, w, spec, "pallas")
        assert conv.runtime_failures() == []
        assert conv.quarantined_engines() == []
        assert conv.dispatch_events() == {} and poisoned == []
        return
    y = conv.conv2d(x, w, spec, "pallas")
    ref = conv.conv2d(x, w, spec, "bp_phase")
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
    assert [f["engine"] for f in conv.runtime_failures()] == ["pallas"]
    assert conv.dispatch_events()["forward:pallas->bp_phase"] == 1
    assert len(poisoned) == 1


# ---------------------------------------------------------------------------
# The port's pallas engine (plain versions on the CPU)
# ---------------------------------------------------------------------------

CASES = {
    "strided": (_x(), _w(), ConvSpec.make(stride=2, padding=1), False),
    "dilated": (_x(), _w(), ConvSpec.make(stride=2, padding=2, dilation=2),
                False),
    "grouped": (_x(c=4, h=12), _w(n=6, c=2),
                ConvSpec.make(stride=2, padding=1, groups=2), False),
    "transposed": (_x(c=8, h=8), _w(n=8, c=4),
                   ConvTransposeSpec.make(stride=2, padding=1,
                                          output_padding=1), True),
}


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_pallas_fault_degrades_to_bp_phase_exactly(case):
    """Every pass faulted at its launch site re-runs on bp_phase: y, dx and
    dw equal the unarmed pallas run's within 1e-6 (relative to the
    largest value), the weight re-derived for the survivor (the dilated
    kernel for bp_phase; its grad un-dilated)."""
    x, w, spec, transpose = CASES[case]
    want = _grads(x, w, "pallas", spec, transpose)
    assert not any("->" in k for k in conv.dispatch_events())
    conv.reset_dispatch_events()
    config.update(fault_spec="pallas.*:raise")
    got = _grads(x, w, "pallas", spec, transpose)
    for g, t in zip(got, want):
        assert g.shape == t.shape and _rel(g, t) <= 1e-6
    sfx = "_T" if transpose else ""
    ev = conv.dispatch_events()
    for p in ("forward", "input_grad", "weight_grad"):
        assert ev[f"{p}{sfx}:pallas->bp_phase"] == 1
        assert ev[f"{p}{sfx}:bp_phase"] == 1
    assert len(inject.fired_events()) == 3
    assert {f["survivor"] for f in conv.runtime_failures()} == {"bp_phase"}


def test_faulted_pass_runs_nothing_of_the_kernel_engine(monkeypatch):
    """The launch site comes before the plan and the kernel call: a
    faulted pass never reaches ``tap_gemm`` (its plain version here)."""
    calls = []
    real = tg.tap_gemm
    monkeypatch.setattr(tg, "tap_gemm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    config.update(fault_spec="pallas.forward.launch:raise")
    conv.conv2d(_x(), _w(), ConvSpec.make(stride=2, padding=1), "pallas")
    assert calls == []
    config.update(fault_spec=None)
    conv.clear_quarantine()
    conv.conv2d(_x(), _w(), ConvSpec.make(stride=2, padding=1), "pallas")
    assert calls == [1]


def test_quarantine_skip_probe_recover(monkeypatch):
    monkeypatch.setattr(conv, "QUARANTINE_PROBE_AFTER", 2)
    x, w = _x(), _w()
    spec = ConvSpec.make(stride=2, padding=1)
    config.update(fault_spec="pallas.forward.launch:raise@step0")
    conv.conv2d(x, w, spec, "pallas")
    assert conv.quarantined_engines()
    config.update(fault_spec=None)
    for step in range(1, 4):                     # 2 skips, then the probe
        inject.set_step(step)
        conv.conv2d(x, w, spec, "pallas")
    ev = conv.dispatch_events()
    assert ev["forward:pallas:quarantined"] == 2
    assert ev["forward:pallas:probe"] == ev["forward:pallas:recovered"] == 1
    assert ev["forward:pallas"] == 1 and ev["forward:bp_phase"] == 3
    assert not conv.quarantined_engines()


def test_failed_probe_rearms_quarantine(monkeypatch):
    monkeypatch.setattr(conv, "QUARANTINE_PROBE_AFTER", 1)
    config.update(fault_spec="pallas.forward.launch:raise")
    for step in range(3):                        # fail, skip, probe-fail
        inject.set_step(step)
        conv.conv2d(_x(), _w(), ConvSpec.make(stride=2, padding=1), "pallas")
    ev = conv.dispatch_events()
    assert ev["forward:pallas:probe"] == 1
    assert "forward:pallas:recovered" not in ev
    assert conv.quarantined_engines()[0]["skips"] == 0


def test_reset_clears_quarantine_and_failures():
    config.update(fault_spec="pallas.forward.launch:raise")
    conv.conv2d(_x(), _w(), ConvSpec.make(stride=2, padding=1), "pallas")
    assert conv.runtime_failures() and conv.quarantined_engines()
    conv.reset_dispatch_events()
    assert not conv.runtime_failures() and not conv.quarantined_engines()


def test_the_quarantine_key_has_no_dtype_and_no_groups():
    """JAX's ``_dims_key``: a geometry quarantined in float32 is skipped in
    float64 too."""
    config.update(fault_spec="pallas.forward.launch:raise@step0")
    spec = ConvSpec.make(stride=2, padding=1)
    conv.conv2d(_x(), _w(), spec, "pallas")
    inject.set_step(1)
    conv.conv2d(_x().double(), _w().double(), spec, "pallas")
    assert conv.dispatch_events()["forward:pallas:quarantined"] == 1
    assert conv.quarantined_engines()[0]["dims"] == \
        (2, 3, 16, 16, 8, 3, 3, 2, 2)


def test_a_crashing_pallas_pass_asks_to_poison_its_plan(monkeypatch):
    calls = []
    monkeypatch.setattr(conv, "_poison_plan_entry",
                        lambda *a: calls.append(a))
    config.update(fault_spec="pallas.input_grad.launch:raise")
    x, w = _x(), _w()
    _grads(x, w, "pallas")
    d = conv.spec_dims(x.shape, w.shape, ConvSpec.make(stride=2, padding=1))
    assert calls == [("input_grad", False, d, 1, torch.device("cpu"),
                      torch.float32)]


@pytest.fixture
def card(tmp_path, monkeypatch):
    """The stand-in card of tests/test_torch_autotune.py, a private plan
    cache and a fake replay timer: the tuner's whole path runs on the
    CPU."""
    monkeypatch.setattr(tg, "_sms", lambda device: H100.sms)
    monkeypatch.setattr(autotune, "card", lambda device: H100)
    monkeypatch.setattr(autotune, "build_id", lambda: "build-a")
    monkeypatch.setattr(timing, "replay_ms",
                        lambda fn, batches, calls=10, warm=3: [0.01])
    config.update(autotune="measure", autotune_top_k=2, autotune_reps=1,
                  plan_cache_dir=str(tmp_path))
    autotune.clear_memo()
    ops.reset_plan_events()
    yield tmp_path
    autotune.clear_memo()
    ops.reset_plan_events()


D = ConvDims(B=1, C=4, H_i=8, W_i=8, N=4, K_h=3, K_w=3, S=2, P_h=1, P_w=1)


def _tune(role="forward"):
    analytic = tg.analytic_plan(ops.problem(role, D, 1), H100.sms)
    return autotune.tuned_plan(role, D, 1, torch.device("cpu"), analytic)


def test_poison_plan_entry_marks_the_cached_plan(card):
    _tune()
    key = autotune.plan_key("forward", D, 1, H100)
    for mode, poisoned in (("off", False), ("cached", True)):
        config.update(autotune=mode)
        conv._poison_plan_entry("forward", False, D, 1,
                                torch.device("cuda"), torch.float32)
        store = autotune._load_store()
        assert bool(store["entries"][key].get("poisoned")) is poisoned
    autotune.clear_memo()
    assert _tune().cache == "poisoned"
    assert ops.plan_events()["forward_autotune_poisoned"] == 1


def test_measure_fault_skips_the_candidate(card):
    config.update(fault_spec="autotune.measure:raise")
    plan = _tune()
    assert plan is not None and not plan.autotuned
    assert ops.plan_events()["forward_autotune_measure_failed"] == 2


def test_plan_cache_faults_are_a_cold_cache_and_a_warning(card):
    _tune()
    autotune.clear_memo()
    config.update(fault_spec="plan_cache.read:raise")
    assert _tune().cache == "miss"               # the store read as empty
    autotune.clear_memo()
    config.update(fault_spec="plan_cache.write:raise")
    with pytest.warns(RuntimeWarning, match="plan cache not persisted"):
        autotune._save_store({"schema": autotune.CACHE_SCHEMA,
                              "entries": {}})


# ---------------------------------------------------------------------------
# Site coverage
# ---------------------------------------------------------------------------

def test_every_known_site_is_exercised(card, tmp_path):
    """Arm a never-firing rule (every fault_point records its site without
    changing behaviour), drive every failure domain once, and require all
    of KNOWN_SITES."""
    config.update(fault_spec="*:raise@step999999")
    inject.reset_events()
    _grads(_x(), _w(), "pallas")                   # the three launches
    _tune()                                        # read, measure, write
    CKPT.save(str(tmp_path / "ck"), 0, {"x": np.ones(2)})
    CKPT.restore(str(tmp_path / "ck"), device="cpu")
    params, opt, good = _toy_setup()
    TS.make_train_step(_ToyCfg(), adamw.AdamWConfig(), loss=_toy_loss,
                       guard=True)(params, opt, good, 0)
    _serve(n=1)
    assert inject.seen_sites() == set(inject.KNOWN_SITES)
    assert inject.fired_events() == []


# ---------------------------------------------------------------------------
# The train step's grad.values site and the guard
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _ToyCfg:
    name: str = "toy"


def _toy_loss(params, batch, cfg):
    loss = ((batch["x"] @ params["w"] - batch["y"]) ** 2).mean()
    return loss, {"loss": loss}


def _toy_setup():
    params = {"w": torch.ones(4, 2)}
    good = {"x": torch.ones(8, 4), "y": torch.zeros(8, 2)}
    return params, adamw.init_state(params), good


def test_grad_values_nan_drops_exactly_its_step():
    config.update(fault_spec="grad.values:nan@step2")
    step_fn = TS.make_train_step(_ToyCfg(), adamw.AdamWConfig(peak_lr=0.1),
                                 loss=_toy_loss, guard=True)
    p, o, good = _toy_setup()
    bad = []
    for step in range(4):
        inject.set_step(step)
        p, o, m = step_fn(p, o, good, step)
        bad.append(int(m["guard_bad"]))
    assert bad == [0, 0, 1, 0]
    assert bool(torch.isfinite(p["w"]).all())
    assert inject.fired_events() == [{"site": "grad.values", "action": "nan",
                                      "step": 2, "pattern": "<train step>"}]


# ---------------------------------------------------------------------------
# Checkpoints: the writer's fault is re-raised
# ---------------------------------------------------------------------------

def test_async_write_fault_reraised_on_wait(tmp_path):
    config.update(fault_spec="ckpt.write:raise")
    CKPT.save(str(tmp_path), 1, {"x": np.ones(2)}, blocking=False)
    with pytest.raises(InjectedFault):
        CKPT.wait()
    config.update(fault_spec=None)
    CKPT.save(str(tmp_path), 2, {"x": np.ones(2)}, blocking=False)
    CKPT.wait()
    assert CKPT.latest_steps(str(tmp_path)) == [2]


def test_async_write_fault_reraised_on_next_save(tmp_path):
    config.update(fault_spec="ckpt.write:raise")
    CKPT.save(str(tmp_path), 1, {"x": np.ones(2)}, blocking=False)
    config.update(fault_spec=None)
    with pytest.raises(InjectedFault):
        CKPT.save(str(tmp_path), 2, {"x": np.ones(2)})
    CKPT.wait()
    assert CKPT.latest_steps(str(tmp_path)) == []


def test_read_fault_raises_from_restore(tmp_path):
    CKPT.save(str(tmp_path), 1, {"x": np.ones(2)})
    config.update(fault_spec="ckpt.read:raise")
    with pytest.raises(InjectedFault):
        CKPT.restore(str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# Serving: a failed lane fails alone
# ---------------------------------------------------------------------------

def _serve(n=4, max_new=6):
    from repro_torch.launch import serve as tserve
    from repro_torch.serve.continuous import ContinuousEngine
    from repro_torch.serve.request import Request
    cfg = tserve.get_smoke_config("smollm-360m")
    eng = ContinuousEngine(cfg, tserve.init_params(cfg, 0, "cpu"),
                           max_batch=2, max_len=24)
    for rid in range(n):
        prompt = np.random.RandomState(rid).randint(1, cfg.vocab, 5)
        eng.submit(Request(rid=rid, prompt=prompt.tolist(), max_new=max_new))
    return {r.rid: r for r in eng.run()}, eng


def test_decode_fault_fails_only_its_lanes():
    want, _ = _serve()
    config.update(fault_spec="serve.decode:raise@step3")
    got, eng = _serve()
    # Decode step 3 runs requests 0 and 1 (2 lanes): both fail with the
    # tokens of the prefill and decode steps 1-2; 2 and 3 are untouched.
    assert [got[r].status for r in range(4)] == ["failed", "failed", "ok",
                                                 "ok"]
    for r in (0, 1):
        assert got[r].out == want[r].out[:3]
    for r in (2, 3):
        assert got[r].out == want[r].out and len(got[r].out) == 6
    s = eng.run_summary()
    assert s["failed"] == 2 and s["completed"] == 2 and s["admitted"] == 4
    assert [f["step"] for f in inject.fired_events()] == [3, 3]


def test_prefill_fault_fails_only_its_request():
    config.update(fault_spec="serve.prefill:raise~p0.5", fault_seed=0)
    got, eng = _serve()
    failed = [r for r in got.values() if r.status == "failed"]
    assert failed and all(r.out == [] for r in failed)
    assert all(len(r.out) == 6 for r in got.values() if r.status == "ok")
    assert eng.counters["failed"] == len(failed) == len(
        inject.fired_events())


# ---------------------------------------------------------------------------
# The chaos drill
# ---------------------------------------------------------------------------

def test_chaos_drill_passes_on_the_cpu():
    res = chaos.main(["--steps", "10", "--batch", "8", "--device", "cpu"])
    assert res["n_pallas"] == {"forward": 3, "input_grad": 2,
                               "weight_grad": 3}
    assert res["bad_steps"] == [5] and len(res["losses"]) == 10
    assert conv.QUARANTINE_PROBE_AFTER == 3     # restored
    assert config.fault_spec is None and not inject.armed_rules()


def test_chaos_losses_match_a_jax_loop_under_bp_phase():
    """The drill's losses against a JAX loop from the same parameters and
    batches under ``bp_phase``, its step 5 dropped too (NaN grads, no
    update); within 1e-4."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import train_cnn_bp as ex
    finally:
        sys.path.remove(str(ROOT / "examples"))
    from repro_torch.tree import tree_map
    jparams = tree_map(lambda t: jnp.asarray(t.numpy()),
                       chaos.drill_params("cpu"))
    res = chaos.main(["--steps", "10", "--batch", "8", "--device", "cpu"])

    _, loss_fn = ex.make_model("bp_phase")
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    rng = np.random.RandomState(0)
    losses = []
    for step in range(10):
        x, y = ex.synthetic_task(rng, 8)
        loss, g = grad_fn(jparams, x, y)
        if step != 5:
            jparams = jax.tree.map(lambda p, gg: p - 0.05 * gg, jparams, g)
        losses.append(float(loss))
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-4, atol=1e-4)


def test_chaos_with_telemetry_validates_its_trace(tmp_path):
    sys.path.insert(0, str(ROOT))
    try:
        from scripts.validate_trace import validate_trace
    finally:
        sys.path.remove(str(ROOT))
    import json
    t, m = tmp_path / "t.json", tmp_path / "m.jsonl"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = chaos.main(["--steps", "10", "--batch", "8", "--device", "cpu",
                          "--trace", str(t), "--metrics", str(m)])
    assert res["obs"]["consistent"]
    problems, stats = validate_trace(json.loads(t.read_text()))
    assert problems == []
    assert any(n.startswith("conv:forward:pallas") for n in stats["b_names"])
    assert not config.telemetry and not obs.enabled()
