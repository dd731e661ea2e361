"""The port's live metric sampler (``repro_torch.obs.sampler``) against the
reference's (``repro.obs.sampler``) on the CPU.

Both samplers read registries that hold the same values, are ticked the same
way and read one shared fake clock, so every sample (stamp, tick, values,
rates), every derived series and every export must be equal exactly: the
port's module is a copy of the reference's. The sampler part of
``tests/test_obs.py`` is the template; its cases run here on both packages.
"""

import json

import numpy as np
import pytest

from repro.obs import metrics as RM
from repro.obs import sampler as RS
from repro.obs import trace as RT
from repro_torch.obs import metrics as TM
from repro_torch.obs import sampler as TS
from repro_torch.obs import trace as TT


class _Clock:
    """``time.perf_counter`` stand-in: a stamp the test moves by hand."""

    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now


class _Prov:
    """A registry provider: numbers, a string and a bool (the sampler keeps
    only the numbers)."""

    def __init__(self, n):
        self.n = n

    def metrics(self):
        return {"done": self.n, "rate": self.n / 4.0, "mode": "swap",
                "on": True}


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for mod in (RS, TS, RT, TT):
        monkeypatch.setattr(mod, "time", c)
    return c


def _pair(**kw):
    """(reference registry, sampler), (port registry, sampler), built alike.
    ``tracer`` in ``kw`` builds one tracer per package."""
    out = []
    for M, S, T in ((RM, RS, RT), (TM, TS, TT)):
        reg = M.Registry()
        args = dict(kw)
        if args.pop("tracer", False):
            args["tracer"] = T.Tracer(enabled=True)
        out.append((reg, S.Sampler(registry=reg, **args)))
    return out


def _sample(s):
    return None if s is None else (s.t, s.tick, s.values, s.rates)


@pytest.mark.parametrize("kw", [dict(), dict(every_ticks=2),
                                dict(every_ticks=3, min_interval_s=0.2),
                                dict(wall_clock=True, min_interval_s=1.0),
                                dict(capacity=4)],
                         ids=["every", "every2", "every3_min", "wall",
                              "ring4"])
def test_samples_equal_the_reference(clock, kw):
    pairs = _pair(**kw)
    rng = np.random.default_rng(len(kw))
    # the providers are held here: the registries keep them weakly
    held = [[_Prov(0)] for _ in pairs]
    for (reg, _), h in zip(pairs, held):
        reg.register_provider("x", h[0])
    for i in range(24):
        n, g, v = (int(rng.integers(0, 9)), float(rng.normal()),
                   float(rng.random()))
        for (reg, _), h in zip(pairs, held):
            reg.counter("k.events").inc(n)
            reg.gauge("k.level").set(g)
            reg.histogram("k.ms").observe(v)
            if i == 12:                     # a re-registered provider
                h.append(_Prov(1))          # restarts its counters
                reg.register_provider("x", h[-1])
            h[-1].n += n
        clock.now += float(rng.choice([0.0, 0.004, 0.25, 1.5]))
        want, got = (_sample(smp.tick("test")) for _, smp in pairs)
        assert got == want, i
    (_, rs), (_, ts) = pairs
    assert [_sample(s) for s in ts.samples] == \
        [_sample(s) for s in rs.samples]
    assert ts.samples and "mode" not in ts.samples[-1].values
    assert "x.on" not in ts.samples[-1].values
    for key in ("k.events", "k.level", "x.done", "k.ms.count", "missing"):
        for source in ("value", "rate"):
            assert ts.series(key, source) == rs.series(key, source)
        for skip in (0, 1, 3):
            assert ts.steady_rate(key, skip) == rs.steady_rate(key, skip)
    assert ts.metrics() == rs.metrics()


def test_counter_reset_leaves_no_negative_rate(clock):
    """A counter that falls between samples is a reset: its rate is absent
    from both samplers, and comes back on the next sample."""
    pairs = _pair()
    held = []
    for reg, _ in pairs:
        held.append(_Prov(100))
        reg.register_provider("x", held[-1])
    for _, smp in pairs:
        smp.tick()
    clock.now += 0.5
    fresh = []
    for reg, _ in pairs:
        fresh.append(_Prov(3))
        reg.register_provider("x", fresh[-1])
    got = [smp.tick() for _, smp in pairs]
    assert _sample(got[1]) == _sample(got[0])
    assert got[1].values["x.done"] == 3 and "x.done" not in got[1].rates
    clock.now += 0.5
    for p in fresh:
        p.n = 7
    got = [smp.tick() for _, smp in pairs]
    assert _sample(got[1]) == _sample(got[0])
    assert got[1].rates["x.done"] == pytest.approx(8.0)


def test_export_and_counter_tracks_equal_the_reference(clock, tmp_path):
    pairs = _pair(tracer=True, counter_tracks=(("k.n", "value"),
                                               ("k.n", "rate")))
    for step in range(3):
        for reg, _ in pairs:
            reg.counter("k.n").inc(2 + step)
        clock.now += 0.25
        for _, smp in pairs:
            smp.tick()
    lines = []
    for name, (_, smp) in zip(("ref", "port"), pairs):
        path = tmp_path / f"{name}.jsonl"
        smp.export_jsonl(str(path))
        lines.append([json.loads(x) for x in path.read_text().splitlines()])
    assert lines[1] == lines[0] and len(lines[1]) == 3
    events = [[(e.name, e.track, e.ph, e.ts, e.args)
               for e in smp.tracer.events] for _, smp in pairs]
    assert events[1] == events[0]
    assert {e[0] for e in events[1]} == {"k.n", "k.n/s"}


def test_module_hook_installs_and_uninstalls():
    """set_sampler / tick / get_sampler of each package drive its own
    installed sampler alike, and the installed sampler reports itself."""
    for M, S in ((RM, RS), (TM, TS)):
        reg = M.Registry()
        smp = S.Sampler(registry=reg)
        prev = S.set_sampler(smp)
        try:
            S.tick("test")
            S.tick("test")
            assert smp.ticks == 2 and S.get_sampler() is smp
            assert reg.snapshot()["obs.sampler.ticks"] == 2
        finally:
            S.set_sampler(prev)
        assert S.get_sampler() is prev
        S.tick("test")
        assert smp.ticks == 2


def test_every_ticks_is_validated():
    for S in (RS, TS):
        with pytest.raises(ValueError, match="every_ticks"):
            S.Sampler(registry=None, every_ticks=0)
