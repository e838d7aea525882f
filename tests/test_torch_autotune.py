"""Measured autotuning of the tap kernels' plans (``repro_torch.kernels.
autotune``), on the CPU: counterparts of ``tests/test_autotune.py``'s cases,
the JAX package's state machine step by step against the port's, and the
plan reports against JAX's.

No kernel runs here: the card is a stand-in (``Card``, 132 SMs) and the
timer a fake, so every path of the tuner but the timing itself -- the
candidates, the persistent cache, revalidation, the counters -- is the one
a card takes.  ``tests/test_torch_cuda.py`` times real candidates.
"""

import json
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.core import conv as jconv  # noqa: E402
from repro.core.config import config as jconfig  # noqa: E402
from repro.core.convspec import ConvSpec as JSpec  # noqa: E402
from repro.core.convspec import ConvTransposeSpec as JTSpec  # noqa: E402
from repro.core.im2col_ref import ConvDims as JDims  # noqa: E402
from repro.kernels import autotune as jat  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch.configs import paper_cnn  # noqa: E402
from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.core.config import config  # noqa: E402
from repro_torch.core.convspec import ConvSpec, ConvTransposeSpec  # noqa: E402,E501
from repro_torch.core.im2col_ref import ConvDims  # noqa: E402
from repro_torch.kernels import autotune, ops  # noqa: E402
from repro_torch.kernels import tap_gemm as tg  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

H100 = autotune.Card("NVIDIA H100 80GB HBM3", (9, 0), 132)
DEV = torch.device("cuda")       # never touched: the card is a stand-in
D = ConvDims(B=1, C=4, H_i=8, W_i=8, N=4, K_h=3, K_w=3, S=2, P_h=1, P_w=1)

#: the 12 shapes chip_smoke.py gives the tap kernels: Table II (batch 2),
#: the CNN's three convs, the autoencoder's two encoder convs and the
#: mirror convs of its two decoder layers, as (label, dims, groups).
SHAPES = [row[:3] for row in
          [("/".join(map(str, layer)), paper_cnn.dims(layer), 1)
           for layer in paper_cnn.TABLE2_LAYERS]
          + chip_smoke.cnn_shapes(ConvDims)
          + chip_smoke.ae_shapes(ConvDims, tconv, ConvTransposeSpec)]
IDS = [row[0].split()[0] for row in SHAPES]


class FakeTimer:
    """Stands in for ``measure_plan``: each call returns a smaller time than
    the last (the last candidate timed wins) and records what it timed."""

    def __init__(self, start: float = 100.0):
        self.next, self.timed = start, []

    def __call__(self, role, d, *args, **kw):
        self.timed.append((role, args))
        self.next -= 1.0
        return self.next


def _never(*a, **k):
    raise AssertionError("timed a candidate")


@pytest.fixture(autouse=True)
def _tuned(tmp_path, monkeypatch):
    """A private plan cache, autotune=measure, the stand-in card and build;
    config restored and the memo and counters dropped afterwards."""
    saved = config.snapshot()
    config.update(autotune="measure", autotune_top_k=3, autotune_reps=1,
                  plan_cache_dir=str(tmp_path))
    monkeypatch.setattr(tg, "_sms", lambda device: H100.sms)
    monkeypatch.setattr(autotune, "card", lambda device: H100)
    monkeypatch.setattr(autotune, "build_id", lambda: "build-a")
    monkeypatch.setattr(autotune, "measure_plan", FakeTimer())
    _fresh()
    yield tmp_path
    config.update(**saved)
    _fresh()


def _fresh():
    autotune.clear_memo()
    ops.reset_plan_events()


def _store(path=None) -> dict:
    return json.load(open(path or autotune.cache_path()))


def _write(store: dict) -> None:
    with open(autotune.cache_path(), "w") as f:
        json.dump(store, f)


def _rules(role, d, g):
    """The analytic plan: the depthwise variant for a pass of one channel
    a group (unsplit, but the weight grad's dw_splits), else
    forward_splits / phased_plan / wgrad_plan called as the wrappers call
    them."""
    prob = ops.problem(role, d, g)
    if d.C == d.N == 1:
        return "dw", (tg.dw_splits(prob, H100.sms) if role == "weight_grad"
                      else 1)
    if role == "forward":
        return "64x64", tg.forward_splits(prob.m, prob.cout, prob.counts[0],
                                          prob.cin, H100.sms, g)
    if role == "input_grad":
        return tg.phased_plan(g, prob.counts, prob.cin, prob.cout, prob.m,
                              H100.sms)
    return tg.wgrad_plan(g, prob.counts[0], prob.cin, prob.cout, prob.m,
                         H100.sms)


# ---------------------------------------------------------------------------
# Candidates and plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("role", ops.PLAN_ROLES)
@pytest.mark.parametrize("layer,d,g", SHAPES, ids=IDS)
def test_candidate_head_is_the_analytic_plan(layer, d, g, role):
    """At every shape chip_smoke.py runs: the head of the shortlist is the
    analytic plan, every candidate launches, none repeats, the variant is
    tried only among the role's own, and the shortlist is cut to k."""
    cands = ops.plan_candidates(role, d, g, k=100, device=DEV)
    assert cands[0].key == _rules(role, d, g)
    prob = ops.problem(role, d, g)
    assert all(tg.plan_gap(prob, c) is None for c in cands)
    assert len({c.key for c in cands}) == len(cands)
    assert {c.variant for c in cands} <= set(tg.ROLE_TILES[role])
    assert all(c.role == role and not c.autotuned for c in cands)
    assert ops.plan_candidates(role, d, g, device=DEV) == cands[:3]


@pytest.mark.parametrize("layer,d,g", SHAPES, ids=IDS)
def test_off_plans_equal_the_rules(layer, d, g):
    """With autotune off, every pass's plan is the analytic rule's, at
    every shape, and the tuner is never asked."""
    config.update(autotune="off")
    for role in ops.PLAN_ROLES:
        plan = ops.pass_plan(role, d, g, DEV)
        assert plan.key == _rules(role, d, g) and plan.cache == ""
    assert autotune._MEMO == {} and ops.plan_events() == {}


def test_candidate_order_follows_the_rules():
    """ae.enc1's weight grad: the analytic split floor of 64 rows, then
    floors of 32 and 16, half and double, then the 64x16 tile."""
    layer, d, g = SHAPES[IDS.index("ae.enc1")]
    prob = ops.problem("weight_grad", d, g)
    rows = prob.m
    cands = ops.plan_candidates("weight_grad", d, g, k=100, device=DEV)
    head = cands[0]
    want = [head.key]
    for s in (tg.wgrad_plan(g, 9, d.C, d.N, rows, H100.sms, None, 32)[1],
              tg.wgrad_plan(g, 9, d.C, d.N, rows, H100.sms, None, 16)[1],
              tg._whole_splits(rows, head.splits // 2, 16),
              tg._whole_splits(rows, 2 * head.splits, 16)):
        if (head.variant, s) not in want:
            want.append((head.variant, s))
    want.append(tg.wgrad_plan(g, 9, d.C, d.N, rows, H100.sms, "64x16"))
    assert [c.key for c in cands] == want


def test_unknown_role_raises():
    for call in (lambda: ops.plan_candidates("sideways", D, device=DEV),
                 lambda: ops.plan_from_entry("sideways", D, 1, ["64x64", 1]),
                 lambda: ops.pass_plan("sideways", D, 1, DEV),
                 lambda: autotune._run_fn("sideways", D, 1, None, "cpu")):
        with pytest.raises(ValueError, match="unknown plan role"):
            call()


@pytest.mark.parametrize("role,plan,match", [
    ("forward", tg.Plan("input_grad", "64x64", 1), "input_grad plan"),
    ("forward", tg.Plan("forward", "64x16", 1), "no variant"),
    ("weight_grad", tg.Plan("weight_grad", "128x8", 1), "no variant"),
    ("forward", tg.Plan("forward", "64x64", 0), "outside"),
    ("forward", tg.Plan("forward", "64x64", tg.MAX_SPLITS + 1), "outside"),
    ("forward", tg.Plan("forward", "64x64", 4), "empty"),
    ("input_grad", tg.Plan("input_grad", "64x16", 3), "empty"),
    ("weight_grad", tg.Plan("weight_grad", "64x64", 5), "empty"),
], ids=["role", "fwd_variant", "wgrad_variant", "zero", "too_many",
        "fwd_empty", "phased_empty", "wgrad_empty"])
def test_invalid_plans_raise(role, plan, match):
    """A plan is checked before launch, on the CPU too: D's forward
    contracts 36 rows (4 splits of 16 leave one empty), its input grad's
    longest phase 16, its weight grad 16 pixels."""
    assert ops.launch_gap(role, D, 1, plan) is not None
    x = torch.randn(D.B, D.C, D.H_i, D.W_i)
    w = torch.randn(D.N, D.C, D.K_h, D.K_w)
    dy = torch.randn(D.B, D.N, D.H_o, D.W_o)
    call = {"forward": lambda: ops.conv2d_forward(x, w, D, 1, plan),
            "input_grad": lambda: ops.conv2d_input_grad(dy, w, D, 1, plan),
            "weight_grad": lambda: ops.conv2d_weight_grad(x, dy, D, 1,
                                                          plan)}[role]
    with pytest.raises(ValueError, match=match):
        call()


def test_grid_z_limit_holds_for_plans():
    """Splits and groups share the grid's z: a depthwise conv of 40,000
    groups launches its forward unsplit, not in 2 splits."""
    prob = ops.problem("forward", D, 40_000)
    assert tg.plan_gap(prob, tg.Plan("forward", "64x64", 1)) is None
    assert "grid z = 80000" in tg.plan_gap(prob,
                                           tg.Plan("forward", "64x64", 2))


# ---------------------------------------------------------------------------
# Measurement picks a winner from the shortlist
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("role", ops.PLAN_ROLES)
def test_measure_picks_the_fastest_candidate(role, monkeypatch):
    timer = FakeTimer()
    monkeypatch.setattr(autotune, "measure_plan", timer)
    d = SHAPES[IDS.index("ae.enc1")][1]
    cands = ops.plan_candidates(role, d, 1, device=DEV)
    plan = ops.pass_plan(role, d, 1, DEV)
    assert plan.key == cands[-1].key            # the fake's fastest
    assert plan.autotuned and plan.cache == "miss"
    assert plan.candidates_timed == len(cands) == len(timer.timed)
    assert plan.measured_us == timer.next
    assert [t[1][1].key for t in timer.timed] == [c.key for c in cands]
    assert ops.plan_events() == {f"{role}_autotune_miss": 1}
    assert ops.pass_plan(role, d, 1, DEV) is plan        # memo


@pytest.mark.parametrize("fails", [1, 3], ids=["one", "all"])
def test_a_candidate_that_raises_is_counted_and_skipped(fails, monkeypatch):
    timer = FakeTimer()

    def flaky(role, d, g, plan, device, reps=None, dtype=None):
        if len(timer.timed) < fails:
            timer.timed.append(None)
            raise RuntimeError("capture failed")
        return timer(role, d, g, plan, device)
    monkeypatch.setattr(autotune, "measure_plan", flaky)
    plan = ops.pass_plan("weight_grad", D, 1, DEV)
    cands = ops.plan_candidates("weight_grad", D, 1, device=DEV)
    assert ops.plan_events()["weight_grad_autotune_measure_failed"] == \
        min(fails, len(cands))
    if fails >= len(cands):                 # analytic, annotated, unsaved
        assert plan.key == cands[0].key and not plan.autotuned
        assert plan.cache == "miss"
        assert not pathlib.Path(autotune.cache_path()).exists()
    else:
        assert plan.autotuned and plan.candidates_timed == len(cands) - 1


# ---------------------------------------------------------------------------
# Persistent cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("role", ops.PLAN_ROLES)
def test_persistent_round_trip(role, tmp_path, monkeypatch):
    first = ops.pass_plan(role, D, 1, DEV)
    path = autotune.cache_path()
    assert path.startswith(str(tmp_path))
    store = _store()
    assert store["schema"] == autotune.CACHE_SCHEMA
    (entry,) = store["entries"].values()
    assert entry == {"plan": list(first.key), "measured_us":
                     first.measured_us, "candidates_timed":
                     first.candidates_timed}
    _fresh()                            # a new process: the disk stays
    monkeypatch.setattr(autotune, "measure_plan", _never)
    second = ops.pass_plan(role, D, 1, DEV)
    assert second.cache == "hit" and second.autotuned
    assert second.key == first.key
    assert second.measured_us == first.measured_us
    assert second.candidates_timed == first.candidates_timed
    assert ops.plan_events() == {f"{role}_autotune_hit": 1}


def test_cached_mode_serves_winners_without_timing(monkeypatch):
    ops.pass_plan("forward", D, 1, DEV)             # measure + persist
    monkeypatch.setattr(autotune, "measure_plan", _never)
    with config.override(autotune="cached"):
        hit = ops.pass_plan("forward", D, 1, DEV)
        assert hit.cache == "hit" and hit.autotuned
        other = ConvDims(B=1, C=4, H_i=10, W_i=10, N=4, K_h=3, K_w=3, S=2,
                         P_h=1, P_w=1)              # never measured
        miss = ops.pass_plan("forward", other, 1, DEV)
        assert miss.cache == "miss" and not miss.autotuned
        assert miss.key == _rules("forward", other, 1)
    assert len(_store()["entries"]) == 1            # the store never grew


def test_off_mode_bypasses_the_tuner(monkeypatch):
    monkeypatch.setattr(autotune, "tuned_plan", _never)
    config.update(autotune="off")
    plan = ops.pass_plan("forward", D, 1, DEV)
    assert not plan.autotuned and plan.cache == ""
    rep = ops.plan_report(D, 1, DEV)
    assert all("autotune" not in rep[r] for r in ops.PLAN_ROLES)
    assert not pathlib.Path(autotune.cache_path()).exists()


def test_cache_key_separates_role_dims_groups_card_and_build(monkeypatch):
    k = autotune.plan_key("forward", D, 1, H100)
    d2 = ConvDims(B=1, C=4, H_i=10, W_i=8, N=4, K_h=3, K_w=3, S=2,
                  P_h=1, P_w=1)
    others = {autotune.plan_key("weight_grad", D, 1, H100),
              autotune.plan_key("forward", d2, 1, H100),
              autotune.plan_key("forward", D, 2, H100),
              autotune.plan_key("forward", D, 1, H100._replace(
                  name="NVIDIA A100-SXM4-80GB", capability=(8, 0), sms=108)),
              autotune.plan_key("forward", D, 1, H100._replace(sms=114)),
              autotune.plan_key("forward", D, 1, H100._replace(
                  capability=(9, 1)))}
    monkeypatch.setattr(autotune, "build_id", lambda: "build-b")
    others.add(autotune.plan_key("forward", D, 1, H100))
    assert k not in others and len(others) == 7
    # explicit high-side pads equal to the symmetric sentinel's spell the
    # same problem
    explicit = ConvDims(B=1, C=4, H_i=8, W_i=8, N=4, K_h=3, K_w=3, S=2,
                        P_h=1, P_w=1, P_h_hi=1, P_w_hi=1)
    monkeypatch.setattr(autotune, "build_id", lambda: "build-a")
    assert autotune.plan_key("forward", explicit, 1, H100) == k


def test_a_plan_timed_on_another_card_is_not_served(monkeypatch):
    first = ops.pass_plan("input_grad", D, 1, DEV)
    _fresh()
    monkeypatch.setattr(autotune, "card", lambda device: H100._replace(
        name="NVIDIA H100 PCIe", sms=114))
    monkeypatch.setattr(tg, "_sms", lambda device: 114)
    again = ops.pass_plan("input_grad", D, 1, DEV)
    assert again.cache == "miss" and first.cache == "miss"
    assert len(_store()["entries"]) == 2


@pytest.mark.parametrize("damage", ["corrupt", "schema", "entries"])
def test_a_damaged_file_is_a_cold_cache(damage):
    ops.pass_plan("forward", D, 1, DEV)
    store = _store()
    if damage == "corrupt":
        open(autotune.cache_path(), "w").write("{not json")
    else:
        if damage == "schema":
            store["schema"] = autotune.CACHE_SCHEMA + 1
        else:
            store["entries"] = ["not", "a", "dict"]
        _write(store)
    _fresh()
    plan = ops.pass_plan("forward", D, 1, DEV)    # no crash: cold
    assert plan.autotuned and plan.cache == "miss"
    assert _store()["entries"]                     # and re-persisted


@pytest.mark.parametrize("bad", [
    ["64x64", 999],            # no longer launches (empty splits)
    ["256x256", 1],            # no such variant
    ["64x64", 0],              # degenerate
    ["64x64", True],           # a bool is not a count
    ["x", "y"],                # garbage types
    [],                        # wrong arity
    "garbage",                 # not a pair
    None,                      # missing
])
def test_stale_entry_re_tunes(bad):
    ops.pass_plan("forward", D, 1, DEV)
    store = _store()
    (key,) = store["entries"]
    store["entries"][key]["plan"] = bad
    _write(store)
    _fresh()
    plan = ops.pass_plan("forward", D, 1, DEV)
    assert plan.autotuned and plan.cache == "stale"
    assert ops.plan_events() == {"forward_autotune_stale": 1}
    assert _store()["entries"][key]["plan"] == list(plan.key)   # healed


def test_garbage_entry_payload_is_stale():
    ops.pass_plan("forward", D, 1, DEV)
    store = _store()
    (key,) = store["entries"]
    store["entries"][key] = ["not", "an", "entry"]
    _write(store)
    _fresh()
    assert ops.pass_plan("forward", D, 1, DEV).cache == "stale"
    store["entries"][key] = {"plan": ["64x64", 1], "measured_us": "fast"}
    _write(store)
    _fresh()
    assert ops.pass_plan("forward", D, 1, DEV).cache == "stale"


def test_poisoned_entry(monkeypatch):
    """cached: the analytic plan, annotated; measure: re-tunes, and the
    fresh winner overwrites the mark."""
    ops.pass_plan("weight_grad", D, 1, DEV)
    key = autotune.poison_plan("weight_grad", D, 1, DEV)
    assert _store()["entries"][key]["poisoned"] is True
    _fresh()
    with config.override(autotune="cached"):
        plan = ops.pass_plan("weight_grad", D, 1, DEV)
        assert plan.cache == "poisoned" and not plan.autotuned
        assert plan.key == _rules("weight_grad", D, 1)
    assert ops.plan_events() == {"weight_grad_autotune_poisoned": 1}
    plan = ops.pass_plan("weight_grad", D, 1, DEV)
    assert plan.cache == "poisoned" and plan.autotuned
    assert "poisoned" not in _store()["entries"][key]
    assert ops.plan_events() == {"weight_grad_autotune_poisoned": 2}


def test_unwritable_cache_dir_warns_and_still_plans(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    config.update(plan_cache_dir=str(blocker / "sub"))
    with pytest.warns(RuntimeWarning, match="not persisted"):
        plan = ops.pass_plan("forward", D, 1, DEV)
    assert plan.autotuned and plan.cache == "miss"


def test_default_cache_dir_follows_xdg(monkeypatch, tmp_path):
    config.update(plan_cache_dir=None)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert autotune.cache_path() == str(
        tmp_path / "xdg" / "repro_torch" / "plan_cache" / "plan_cache.json")
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert autotune.default_cache_dir() == str(
        tmp_path / "home" / ".cache" / "repro_torch" / "plan_cache")


# ---------------------------------------------------------------------------
# Reports and resolution
# ---------------------------------------------------------------------------

def test_plan_report_carries_autotune_fields():
    rep = ops.plan_report(D, 1, DEV)
    for role in ops.PLAN_ROLES:
        at = rep[role]["autotune"]
        assert at["autotuned"] is True and at["cache"] == "miss"
        assert at["measured_us"] > 0 and at["candidates_timed"] >= 1
        assert (rep[role]["variant"], rep[role]["splits"]) in {
            c.key for c in ops.plan_candidates(role, D, 1, device=DEV)}
    assert rep["pallas_path"]
    autotune.clear_memo()
    rep2 = tconv.conv_plan_report((D.B, D.C, D.H_i, D.W_i),
                                  (D.N, D.C, D.K_h, D.K_w), 2, 1,
                                  device=DEV)
    assert all(rep2[r]["autotune"]["cache"] == "hit"
               for r in ops.PLAN_ROLES)
    cpu = ops.plan_report(D, 1, "cpu")
    assert all(cpu[r]["variant"] is None and "autotune" not in cpu[r]
               for r in ops.PLAN_ROLES)


def test_auto_resolves_with_the_tuned_plans():
    res = tconv.resolve_policy(D, "auto", device=DEV)
    assert all(v["engine"] == "pallas" for v in res.values()), res
    assert ops.plan_events() == {**{f"{r}_autotune_miss": 1
                                    for r in ops.PLAN_ROLES},
                                 **{f"{r}_pallas": 1
                                    for r in ops.PLAN_ROLES}}


def test_auto_judges_a_pass_by_the_tuned_plans_launch_gap(monkeypatch):
    """A tuned plan that would overflow the grid's z (2 splits of 40,000
    groups) sends ``auto`` off the kernel with that reason; the analytic
    plan (1 split) keeps it on."""
    d = ConvDims(B=1, C=64, H_i=8, W_i=8, N=1, K_h=3, K_w=3, S=2, P_h=1,
                 P_w=1)
    monkeypatch.setattr(autotune, "tuned_plan",
                        lambda role, d, g, device, analytic, dtype=None:
                        tg.Plan(role, analytic.variant, 2))
    engine, reason = tconv.resolve_engine("auto", "forward", d, False,
                                          40_000, DEV)
    assert engine == "bp_phase" and "grid z = 80000" in reason
    config.update(autotune="off")
    assert tconv.resolve_engine("auto", "forward", d, False, 40_000,
                                DEV)[0] == "pallas"


def test_transposed_passes_tune_under_their_mirror_role():
    spec = ConvTransposeSpec.make(stride=2, padding=1, output_padding=1)
    rep = tconv.policy_report((2, 4, 4, 4), (4, 3, 3, 3), spec, "pallas",
                              device=DEV)
    assert rep["transpose"] and rep["pallas_path"]
    d = tconv.transpose_dims((2, 4, 4, 4), (4, 3, 3, 3), spec)
    keys = {autotune.plan_key(r, d, 1, H100) for r in ops.PLAN_ROLES}
    assert keys <= set(autotune._MEMO)
    assert rep["plan"]["input_grad"]["autotune"]["cache"] == "miss"


def test_cpu_tensors_never_reach_the_tuner(monkeypatch):
    monkeypatch.setattr(autotune, "tuned_plan", _never)
    assert ops.pass_plan("forward", D, 1, "cpu") is None
    x = torch.randn(2, 4, 8, 8, requires_grad=True)
    w = torch.randn(4, 4, 3, 3, requires_grad=True)
    tconv.conv2d(x, w, ConvSpec.make(stride=2, padding=1),
                 "pallas").sum().backward()
    spec = ConvTransposeSpec.make(stride=2, padding=1, output_padding=1)
    tconv.conv2d_transpose(x, w, spec, "pallas").sum().backward()
    # The planner decides each pass of both convs (the transposed one's
    # under its mirror roles); the tuner is never asked.
    assert ops.plan_events() == {f"{r}_pallas": 2 for r in ops.PLAN_ROLES}
    assert autotune._MEMO == {}


# ---------------------------------------------------------------------------
# The JAX package's state machine, step by step
# ---------------------------------------------------------------------------

def _jax_plan(role, d):
    if role == "forward":
        return jops.forward_plan(d)
    if role == "weight_grad":
        return jops.weight_grad_plan(d)
    return jops.input_grad_plan(d).tile


#: (mode, what happens to the store first, whether the memo is dropped)
SCRIPT = [("measure", None, True), ("measure", None, True),
          ("cached", None, True), ("cached", "corrupt", True),
          ("measure", None, True), ("measure", "garbage", True),
          ("measure", "poison", False), ("cached", "poison", False),
          ("measure", None, True), ("cached", None, True)]


@pytest.mark.parametrize("role", ops.PLAN_ROLES)
def test_state_machine_matches_jax(role, tmp_path, monkeypatch):
    """The same script (measure, cached, corrupt, garbage, poison,
    re-measure) through JAX's ``tuned_plan`` and the port's, with one fake
    timer: the ``*_autotune_*`` counters and ``cache`` states agree at
    every step."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    saved = jconfig.snapshot()
    jconfig.update(autotune="measure", autotune_top_k=3, autotune_reps=1,
                   plan_cache_dir=str(jdir))
    config.update(plan_cache_dir=str(tdir))
    monkeypatch.setattr(jat, "measure_plan", FakeTimer())
    jd = JDims(B=1, C=4, H_i=8, W_i=8, N=4, K_h=3, K_w=3, S=2, P_h=1, P_w=1)
    jops.clear_tile_plan_cache()
    jat.clear_memo()
    jops.reset_plan_events()
    _fresh()

    def damage(what):
        if what == "poison":
            jat.poison_plan(role, jops._canonical(jd))  # the planned key
            autotune.poison_plan(role, D, 1, DEV)
        for path, field in ((jat.cache_path(), "tile"),
                            (autotune.cache_path(), "plan")):
            if what == "corrupt":
                open(path, "w").write("{not json")
            elif what == "garbage":
                store = json.load(open(path))
                for entry in store["entries"].values():
                    entry[field] = "garbage"
                json.dump(store, open(path, "w"))

    try:
        for step, (mode, what, drop) in enumerate(SCRIPT):
            jconfig.update(autotune=mode)
            config.update(autotune=mode)
            if what:
                damage(what)
            if drop:
                jops.clear_tile_plan_cache()
                jat.clear_memo()
                autotune.clear_memo()
            want = _jax_plan(role, jd)
            got = ops.pass_plan(role, D, 1, DEV)
            jev = {k: v for k, v in jops.plan_events().items()
                   if "_autotune_" in k}
            assert (got.cache, got.autotuned, ops.plan_events()) == \
                (want.cache, want.autotuned, jev), (step, mode, what)
    finally:
        jconfig.update(**saved)
        jops.clear_tile_plan_cache()
        jat.clear_memo()
        jops.reset_plan_events()


# ---------------------------------------------------------------------------
# Reports against JAX's
# ---------------------------------------------------------------------------

TABLE2 = [("/".join(map(str, layer)), layer)
          for layer in paper_cnn.TABLE2_LAYERS]


@pytest.mark.parametrize("policy", ["auto", "pallas", "bp_phase",
                                    "fwd=lax,dgrad=pallas,wgrad=auto"])
@pytest.mark.parametrize("label,layer", TABLE2, ids=[t[0] for t in TABLE2])
def test_policy_report_matches_jax(label, layer, policy):
    """Engine resolution and the taps of ``policy_report`` and
    ``conv_plan_report`` equal JAX's at the Table II layers (the port's
    report without a device: the resolution every plan shares)."""
    b, (h, c, n, k, s, p) = 2, layer
    x_shape, w_shape = (b, c, h, h), (n, c, k, k)
    config.update(autotune="off")
    got = tconv.policy_report(x_shape, w_shape,
                              ConvSpec.make(stride=s, padding=p), policy)
    with jconfig.override(autotune="off"):
        want = jconv.policy_report(x_shape, w_shape,
                                   JSpec.make(stride=s, padding=p), policy)
        jplan = jconv.conv_plan_report(x_shape, w_shape, s, p)
    assert {k: v["engine"] for k, v in got["passes"].items()} == \
        {k: v["engine"] for k, v in want["passes"].items()}
    assert got["pallas_path"] == want["pallas_path"]
    assert got["transpose"] is want["transpose"] is False
    assert got["plan"]["kernel_taps"] == want["plan"]["kernel_taps"]
    mine = tconv.conv_plan_report(x_shape, w_shape, s, p)
    assert mine["kernel_taps"] == jplan["kernel_taps"]
    assert mine["phases"] == jplan["phases"]
    assert tconv.output_shape(tconv.spec_dims(
        x_shape, w_shape, ConvSpec.make(stride=s, padding=p))) == \
        jconv.output_shape(jconv.spec_dims(
            x_shape, w_shape, JSpec.make(stride=s, padding=p)))


@pytest.mark.parametrize("policy", ["auto", "pallas", "traditional"])
def test_transposed_policy_report_matches_jax(policy):
    """The mirror of Table II layer 2 as a transposed conv: its engines and
    its zero-insertion tap accounting equal JAX's."""
    x_shape, w_shape = (2, 64, 56, 56), (64, 64, 3, 3)
    kw = dict(stride=2, padding=1, output_padding=1)
    config.update(autotune="off")
    got = tconv.policy_report(x_shape, w_shape,
                              ConvTransposeSpec.make(**kw), policy)
    with jconfig.override(autotune="off"):
        want = jconv.policy_report(x_shape, w_shape, JTSpec.make(**kw),
                                   policy)
    assert {k: v["engine"] for k, v in got["passes"].items()} == \
        {k: v["engine"] for k, v in want["passes"].items()}
    assert got["transpose"] is want["transpose"] is True
    assert got["taps"] == want["taps"]
    assert got["plan"]["kernel_taps"] == want["plan"]["kernel_taps"]
    assert got["pallas_path"] == want["pallas_path"]
