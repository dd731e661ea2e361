"""The port's closed observability loop (``repro_torch.obs.{slo,control}``,
``Scheduler.admit_cap`` / ``preempt_override``, ``Autotuner.retune``)
against the reference's on the CPU: every case of ``tests/test_obs_loop.py``
runs on both packages with the same inputs and must give the same answer.

The reference's hysteresis property test draws its breach patterns with
hypothesis (not installed here); the same independent model is held here to
fixed patterns instead. The forced-overload differential runs reduced
gemma-2b in fp32 with one set of weights on the paged scheduler under
``preempt="swap"``: with the queue-wait SLO firing and admissions capped the
streams equal the uncontrolled run's, in each package, and the port's equal
the reference's (on the CPU exactly; the card's gate, where a capped
admission changes GEMM widths, is the near-tie rule of ``chip_smoke.py``).
"""

import dataclasses
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.obs as R_OBS
import repro.runtime.autotune as R_AT
import repro.serve as R_SERVE
import repro_torch.obs as T_OBS
import repro_torch.runtime.autotune as T_AT
import repro_torch.serve as T_SERVE
from repro import configs as RC
from repro.models import transformer as RT
from repro_torch import configs as TC
from repro_torch import convert

PKGS = {"reference": (R_OBS, R_AT, R_SERVE), "port": (T_OBS, T_AT, T_SERVE)}


def _ns(name):
    """One package's loop: its obs names, ``Autotuner``, ``Scheduler`` and
    ``SchedulerConfig``."""
    obs, at, serve = PKGS[name]
    return types.SimpleNamespace(
        name=name, Autotuner=at.Autotuner, Scheduler=serve.Scheduler,
        SchedulerConfig=serve.SchedulerConfig,
        **{k: getattr(obs, k) for k in obs.__all__})


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return _ns(request.param)


# --------------------------------------------------------------------------
# rule validation + extraction
# --------------------------------------------------------------------------

def test_rule_validation(pkg):
    Rule = pkg.Rule
    for kw in (dict(key="k", op="!="), dict(key="k", source="median"),
               dict(key="k", fire_after=0), dict(key="k", clear_after=0),
               {}):                         # needs key or value_fn
        with pytest.raises(ValueError):
            Rule("r", **kw)


def test_rule_sources_and_value_fn(pkg):
    Rule = pkg.Rule
    values, rates = {"a": 5.0}, {"a": 2.0}
    assert Rule("v", key="a").extract(values, rates) == 5.0
    assert Rule("r", key="a", source="rate").extract(values, rates) == 2.0
    assert Rule("m", key="missing").extract(values, rates) is None
    fn = Rule("f", value_fn=lambda v, r: v["a"] + r["a"])
    assert fn.extract(values, rates) == 7.0


# --------------------------------------------------------------------------
# hysteresis: exact fire/clear semantics
# --------------------------------------------------------------------------

def test_monitor_fires_on_nth_breach_clears_on_mth_ok(pkg):
    # SLO holds when value < 0; 1.0 breaches, -1.0 conforms
    m = pkg.Monitor(pkg.Rule("r", key="k", op="<", threshold=0.0,
                             fire_after=3, clear_after=2))
    assert [m.observe(1.0) for _ in range(2)] == [None, None]
    assert m.observe(1.0) == "fire"         # 3rd consecutive breach
    assert m.firing
    assert m.observe(1.0) is None           # already firing: no re-fire
    assert m.observe(-1.0) is None
    assert m.observe(-1.0) == "clear"       # 2nd consecutive OK
    assert not m.firing


def test_monitor_streak_resets(pkg):
    m = pkg.Monitor(pkg.Rule("r", key="k", op="<", threshold=0.0,
                             fire_after=2, clear_after=2))
    # a breach streak broken by a conforming sample never fires
    assert [m.observe(v) for v in (1.0, -1.0, 1.0, 1.0)] == \
        [None, None, None, "fire"]
    # an ok streak broken by a breach keeps firing
    assert [m.observe(v) for v in (-1.0, 1.0, -1.0, -1.0)] == \
        [None, None, None, "clear"]


def _hysteresis_model(seq, fire_after, clear_after):
    """Independent model: fire on the sample completing the fire_after-th
    consecutive breach while not firing, clear on the clear_after-th
    consecutive OK while firing."""
    firing, breaches, oks, out = False, 0, 0, []
    for breach in seq:
        if breach:
            breaches, oks = breaches + 1, 0
            fire = not firing and breaches == fire_after
            firing = firing or fire
            out.append("fire" if fire else None)
        else:
            oks, breaches = oks + 1, 0
            clear = firing and oks == clear_after
            firing = firing and not clear
            out.append("clear" if clear else None)
    return out


def _patterns():
    """Fixed breach patterns: the empty one, all breach, all ok,
    alternation, runs of every length 1-5 and 60 seeded random draws."""
    rng = np.random.default_rng(2)
    pats = [[], [True] * 9, [False] * 9, [True, False] * 8]
    for n in range(1, 6):
        pats.append(([True] * n + [False] * n) * 3)
    pats += [list(rng.random(int(rng.integers(1, 61))) < p)
             for p in (0.3, 0.5, 0.7) for _ in range(20)]
    return pats


@pytest.mark.parametrize("fire_after,clear_after",
                         [(1, 1), (1, 4), (2, 3), (3, 2), (4, 1), (4, 4)])
def test_monitor_hysteresis_fixed_patterns(pkg, fire_after, clear_after):
    """Against the independent model on fixed patterns: transitions
    alternate fire -> clear and land exactly where the model puts them."""
    for seq in _patterns():
        m = pkg.Monitor(pkg.Rule("r", key="k", op="<", threshold=0.0,
                                 fire_after=fire_after,
                                 clear_after=clear_after))
        got = [m.observe(1.0 if b else -1.0) for b in seq]
        assert got == _hysteresis_model(seq, fire_after, clear_after)
        transitions = [t for t in got if t]
        assert transitions == (["fire", "clear"]
                               * len(transitions))[:len(transitions)]
        assert m.firing == (transitions[-1:] == ["fire"])


# --------------------------------------------------------------------------
# SLO manager: events, metrics, subscribers
# --------------------------------------------------------------------------

def test_slo_manager_transitions_metrics_and_subscribers(pkg):
    reg = pkg.Registry()
    tr = pkg.Tracer(enabled=True)
    mgr = pkg.SLOManager([pkg.Rule("lat", key="ms", op="<", threshold=10.0,
                                   fire_after=2, clear_after=1)],
                         registry=reg, tracer=tr)
    calls = []

    class Sub:
        def on_fire(self, rule, value):
            calls.append(("fire", rule.name, value))

        def on_clear(self, rule, value):
            calls.append(("clear", rule.name, value))

    mgr.subscribe(Sub())
    assert reg.snapshot()["obs.slo.lat.firing"] == 0    # pre-declared
    assert mgr.evaluate({"ms": 50.0}, {}) == []
    assert mgr.evaluate({"ms": 50.0}, {}) == ["lat:fire"]
    assert mgr.evaluate({"ms": 50.0}, {}) == []         # no re-fire
    assert mgr.evaluate({"ms": 1.0}, {}) == ["lat:clear"]
    snap = reg.snapshot()
    assert (snap["obs.slo.lat.fired"], snap["obs.slo.lat.cleared"],
            snap["obs.slo.lat.breaches"], snap["obs.slo.lat.firing"]) == \
        (1, 1, 3, 0)
    assert calls == [("fire", "lat", 50.0), ("clear", "lat", 1.0)]
    assert [(e.name, e.track) for e in tr.events] == \
        [("slo-fire", "slo"), ("slo-clear", "slo")]


def test_slo_manager_missing_key_skips_hysteresis(pkg):
    mgr = pkg.SLOManager([pkg.Rule("lat", key="ms", op="<", threshold=10.0,
                                   fire_after=2)], registry=pkg.Registry(),
                         tracer=pkg.Tracer(enabled=False))
    assert mgr.evaluate({"ms": 50.0}, {}) == []
    assert mgr.evaluate({}, {}) == []       # no state change
    assert mgr.evaluate({"ms": 50.0}, {}) == ["lat:fire"]


def test_slo_manager_rejects_duplicate_rule_names(pkg):
    with pytest.raises(ValueError):
        pkg.SLOManager([pkg.Rule("r", key="a"), pkg.Rule("r", key="b")],
                       registry=pkg.Registry(),
                       tracer=pkg.Tracer(enabled=False))


def test_default_serve_rules(pkg):
    """The default rule set: names, keys, thresholds and sources."""
    rules = pkg.default_serve_rules(queue_wait_s=0.1, occupancy_floor=0.5)
    assert [(r.name, r.key, r.op, r.threshold, r.source) for r in rules] \
        == [("queue_wait", "serve.queue_head_wait_s", "<", 0.1, "value"),
            ("ttft_p95", "serve.ttft_ms.p95", "<", 2000.0, "value"),
            ("itl_p95", "serve.itl_ms.p95", "<", 500.0, "value"),
            ("swap_rejected", "paging.swap_rejected", "<", 1.0, "rate"),
            ("occupancy_floor", "serve.mean_occupancy", ">=", 0.5,
             "value")]


# --------------------------------------------------------------------------
# backpressure controller: save/restore semantics
# --------------------------------------------------------------------------

class _FakeSched:
    """The knob surface BackpressureController actuates on."""

    def __init__(self, paged=True):
        self.admit_cap = None
        self.preempt_override = None
        self.slots = types.SimpleNamespace(paged=paged)

    @property
    def preempt_policy(self):
        return self.preempt_override or "recompute"


def test_backpressure_saves_and_restores_exactly(pkg):
    reg = pkg.Registry()
    sched = _FakeSched(paged=True)
    ctrl = pkg.BackpressureController(sched, admit_cap=2, preempt="swap",
                                      registry=reg,
                                      tracer=pkg.Tracer(enabled=False))
    rule = pkg.Rule("queue_wait", key="k", op="<", threshold=0.0)
    ctrl.on_fire(rule, 1.0)
    assert ctrl.engaged
    assert (sched.admit_cap, sched.preempt_override) == (2, "swap")
    ctrl.on_fire(rule, 2.0)                 # idempotent while engaged
    assert sched.admit_cap == 2
    ctrl.on_clear(rule, 0.0)
    assert not ctrl.engaged
    assert (sched.admit_cap, sched.preempt_override) == (None, None)
    snap = reg.snapshot()
    assert (snap["obs.control.backpressure.engaged"],
            snap["obs.control.backpressure.released"],
            snap["obs.control.backpressure.active"]) == (1, 1, 0)


def test_backpressure_ignores_other_rules_and_contiguous_preempt(pkg):
    sched = _FakeSched(paged=False)
    ctrl = pkg.BackpressureController(sched, registry=pkg.Registry(),
                                      tracer=pkg.Tracer(enabled=False))
    other = pkg.Rule("ttft_p95", key="k", op="<", threshold=0.0)
    ctrl.on_fire(other, 1.0)
    assert not ctrl.engaged and sched.admit_cap is None
    ctrl.on_clear(other, 0.0)               # not engaged: a no-op
    ctrl.on_fire(pkg.Rule("queue_wait", key="k", op="<", threshold=0.0),
                 1.0)
    assert sched.admit_cap == 1
    assert sched.preempt_override is None   # no swap on contiguous pools


def test_backpressure_rejects_starving_cap(pkg):
    with pytest.raises(ValueError):
        pkg.BackpressureController(_FakeSched(), admit_cap=0,
                                   registry=pkg.Registry())


def test_build_serve_loop_wiring(pkg):
    smp, slo, ctrls = pkg.build_serve_loop(_FakeSched(), install=False,
                                           queue_wait_s=0.1)
    assert len(ctrls) == 1
    assert isinstance(ctrls[0], pkg.BackpressureController)
    assert slo.monitors["queue_wait"].rule.threshold == 0.1
    smp.tick()      # a sample with no serve.* keys: a clean no-op
    assert slo.firing == {name: False for name in slo.monitors}


def test_scheduler_knobs_in_stats(pkg, model):
    """admit_cap and preempt_override surface in stats() as the reference
    names them, and a cap of 1 admits one request per tick."""
    cfg, params = model[pkg.name]
    sched = pkg.Scheduler(cfg, params, pkg.SchedulerConfig(
        num_slots=4, max_len=32, prefill_chunk=8, allocator="paged",
        block_size=8, cache_requests=False))
    st = sched.stats()
    assert (st["admit_cap"], st["preempt_policy"]) == (-1, "recompute")
    sched.admit_cap, sched.preempt_override = 1, "swap"
    st = sched.stats()
    assert (st["admit_cap"], st["preempt_policy"]) == (1, "swap")
    sched.submit([np.arange(i, i + 4, dtype=np.int32) for i in range(3)],
                 max_new_tokens=2)
    live = []
    for _ in range(3):
        sched.step()
        live.append(sched.live)
    assert live[:2] == [1, 2]
    sched.drain()


# --------------------------------------------------------------------------
# the control invariant: forced-overload differential
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    """{package: (config, params)} of reduced fp32 gemma-2b, one set of
    weights from PRNGKey(0)."""
    rcfg = dataclasses.replace(RC.reduced_config("gemma-2b"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(TC.reduced_config("gemma-2b"),
                               dtype=torch.float32)
    tree = jax.tree_util.tree_map(
        np.array, RT.init_model(jax.random.PRNGKey(0), rcfg))
    return {"reference": (rcfg, jax.tree_util.tree_map(jnp.asarray, tree)),
            "port": (tcfg, convert.params_from_numpy(tcfg, tree,
                                                     device="cpu"))}


def _overload(pkg, cfg, params, controlled):
    """The reference test's forced overload: 8 requests on a paged pool of
    6 slots and 5 blocks of 8 under preempt='swap'; controlled, a
    queue-wait rule at 0.1 ms fires and caps admissions at 1 per tick.
    Returns (streams by rid, (slo, ctrl, sched) or None, stats)."""
    rng = np.random.default_rng(0)
    max_prompt, tail_new, block = 12, 32, 8
    max_len = max_prompt + tail_new + 8
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, max_prompt + 1))
               .astype(np.int32) for _ in range(8)]
    mnts = [int(rng.integers(8, tail_new + 1)) for _ in prompts]
    sc = pkg.SchedulerConfig(
        num_slots=6, max_len=max_len, prefill_chunk=8, cache_requests=False,
        allocator="paged", block_size=block,
        num_blocks=(2 * max_len // block - 1) // 2, preempt="swap")
    sched = pkg.Scheduler(cfg, params, sc)
    loop = None
    if controlled:
        smp = pkg.Sampler()
        slo = pkg.SLOManager(
            [pkg.Rule("queue_wait", key="serve.queue_head_wait_s", op="<",
                      threshold=1e-4, fire_after=2, clear_after=2)],
            tracer=pkg.Tracer(enabled=False))
        ctrl = pkg.BackpressureController(sched, admit_cap=1, preempt="swap",
                                          tracer=pkg.Tracer(enabled=False))
        smp.add_listener(slo.on_sample)
        slo.subscribe(ctrl)
        prev = pkg.set_sampler(smp)
        loop = (slo, ctrl, sched)
    try:
        for p, m in zip(prompts, mnts):
            sched.submit([p], max_new_tokens=m)
        done = sched.drain()
    finally:
        if controlled:
            pkg.set_sampler(prev)
    return {c.rid: c.tokens.tolist() for c in done}, loop, sched.stats()


def test_forced_overload_backpressure_streams_unchanged(pkg, model):
    """Greedy streams with the loop engaged (the SLO fires, admissions are
    capped under swap preemption, it clears on drain) equal the
    uncontrolled run's; the port's equal the reference's."""
    cfg, params = model[pkg.name]
    fired0 = pkg.REGISTRY.counter("obs.slo.queue_wait.fired").value
    base, _, st0 = _overload(pkg, cfg, params, controlled=False)
    ctl, (slo, ctrl, sched), st = _overload(pkg, cfg, params,
                                            controlled=True)
    assert ctl == base, "the controller changed the token streams"
    assert pkg.REGISTRY.counter("obs.slo.queue_wait.fired").value \
        - fired0 >= 1, "the SLO never fired under forced overload"
    assert not slo.monitors["queue_wait"].firing and not ctrl.engaged
    assert sched.admit_cap is None and sched.preempt_override is None
    assert st0["preempted"] >= 1 and st0["recomputed_decode_steps"] == 0
    if pkg.name == "port":
        ref_base, _, ref_st0 = _overload(_ns("reference"),
                                         *model["reference"],
                                         controlled=False)
        assert base == ref_base
        for key in ("preempted", "swapped_out", "swapped_in",
                    "decode_steps", "chunk_steps"):
            assert st0[key] == ref_st0[key], key


# --------------------------------------------------------------------------
# online autotune: retune semantics + controller
# --------------------------------------------------------------------------

def _fast_thunk(_cand):
    return lambda: 0


def test_retune_applies_only_on_improvement(pkg, tmp_path):
    tuner = pkg.Autotuner(str(tmp_path / "cache.json"))
    tuner.put("k.knob", 16, us=0.0)         # unbeatable incumbent: kept
    assert tuner.retune("k.knob", [16, 32], _fast_thunk) == (16, False)
    tuner.put("k.knob", 16, us=1e12)        # terrible incumbent: replaced
    value, improved = tuner.retune("k.knob", [16, 32], _fast_thunk)
    assert improved and value in (16, 32)
    assert tuner.get("k.knob") == value
    assert tuner._cache["k.knob"]["us"] < 1e12


def test_retune_all_fail_keeps_incumbent_never_raises(pkg, tmp_path):
    tuner = pkg.Autotuner(str(tmp_path / "cache.json"))

    def broken(_cand):
        def thunk():
            raise RuntimeError("bad candidate")
        return thunk

    assert tuner.retune("k.knob", [1, 2], broken) == (None, False)
    tuner.put("k.knob", 8, us=5.0)
    assert tuner.retune("k.knob", [1, 2], broken) == (8, False)
    assert set(tuner._cache["k.knob"]["resweep_failed"]) == {"1", "2"}
    assert tuner.get("k.knob") == 8         # incumbent value untouched


def test_autotune_controller_cooldown_and_apply(pkg):
    reg = pkg.Registry()

    class FakeTuner:
        def __init__(self):
            self.calls = 0
            self.result = (32, True)

        def retune(self, key, candidates, make_thunk):
            self.calls += 1
            return self.result

    tuner = FakeTuner()
    applied = []
    ctrl = pkg.AutotuneController(tuner, "k.knob", [16, 32], _fast_thunk,
                                  apply=applied.append, cooldown_s=3600.0,
                                  registry=reg,
                                  tracer=pkg.Tracer(enabled=False))
    rule = pkg.dispatch_imbalance_rule("run[b32]")
    ctrl.on_fire(pkg.Rule("queue_wait", key="k", op="<", threshold=0.0),
                 1.0)                       # another rule: ignored
    assert tuner.calls == 0
    ctrl.on_fire(rule, 2.0)
    assert tuner.calls == 1 and applied == [32]
    ctrl.on_fire(rule, 2.0)                 # inside the cooldown: skipped
    assert tuner.calls == 1
    ctrl.on_clear(rule, 0.5)                # nothing to undo
    ctrl._last_sweep = None                 # the cooldown expired
    tuner.result = (16, False)              # no improvement: not applied
    ctrl.on_fire(rule, 2.0)
    assert tuner.calls == 2 and applied == [32]
    snap = reg.snapshot()
    assert (snap["obs.control.autotune.resweeps"],
            snap["obs.control.autotune.applied"]) == (2, 1)


def test_dispatch_imbalance_rule_value_fn(pkg):
    rule = pkg.dispatch_imbalance_rule("run[b32]", ratio=1.0,
                                       min_execute_ms=1.0)
    c = "runtime.dispatch.bucket.run[b32].compile_ms"
    e = "runtime.dispatch.bucket.run[b32].execute_ms"
    assert rule.extract({c: 50.0, e: 0.5}, {}) is None  # no signal yet
    assert rule.extract({}, {}) is None
    v = rule.extract({c: 25.0, e: 10.0}, {})
    assert v == pytest.approx(2.5)
    assert not rule.holds(v)                # first use 2.5x execute: breach
    assert rule.holds(rule.extract({c: 5.0, e: 10.0}, {}))


def _slow_twice(x):
    time.sleep(0.002)
    return x * 2


def test_dispatch_bucket_stats_feed_the_rule():
    """The port's dispatcher records each bucket's first-use and execute
    host ms under the names the rule reads."""
    from repro_torch.runtime.dispatch import Dispatcher

    d = Dispatcher()
    for _ in range(3):
        d.run(_slow_twice, (torch.ones(4, 3),))
    snap = T_OBS.REGISTRY.snapshot()
    key = "runtime.dispatch.bucket._slow_twice[b4]"
    assert snap[f"{key}.misses"] == 1 and snap[f"{key}.hits"] == 2
    assert snap[f"{key}.execute_ms"] >= 4.0
    rule = T_OBS.dispatch_imbalance_rule("_slow_twice[b4]")
    assert rule.extract(snap, {}) == pytest.approx(
        snap[f"{key}.compile_ms"] / snap[f"{key}.execute_ms"])
