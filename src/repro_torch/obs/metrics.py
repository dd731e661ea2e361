"""Copy of the reference package's ``obs.metrics`` (pure Python).

Metrics registry: counters, gauges and histograms under stable
dotted names.

The paper's whole case is made by *measurement* — per-kernel speedup,
synchronization overhead, energy split (Figs. 6-8) — and the runtime
reproduces that discipline at serving scale. Before this module every
component grew its own ``stats()`` dict with ad-hoc keys; the registry
gives them one namespace (``serve.decode_steps``,
``paging.blocks_free``, ``runtime.dispatch.compile_ms``) so benchmarks,
the autotuner and an SLO scheduler read one snapshot instead
of five dicts.

Two kinds of sources coexist:

  * owned metrics — ``registry.counter/gauge/histogram(name)`` returns a
    live object the caller mutates (the dispatcher's compile counters).
  * providers     — a component registers itself under a prefix
    (``register_provider("serve", scheduler)``) and its ``metrics()``
    method is called at snapshot time, so the legacy ``stats()`` dicts
    keep being the single source of truth and the registry is a *view*
    over them (nothing double-counts).

Providers are held by weakref: benchmarks churn through Scheduler
instances, and a dead provider silently drops out of the snapshot. A
prefix re-registered by a newer instance wins (latest-owner semantics —
exactly what a long-lived process redeploying a scheduler wants).

``REGISTRY`` is the process-wide default; components default to it so
one ``snapshot()`` sees the whole stack, but every constructor accepts a
private ``Registry`` for isolation (tests).
"""

from __future__ import annotations

import collections
import json
import os
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple


class Counter:
    """Monotonic event count (``serve.decode_steps``)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1):
        self.value += n


class Gauge:
    """Point-in-time level (``paging.blocks_free``)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v):
        self.value = v


class Histogram:
    """Distribution of observations (``runtime.dispatch.compile_ms``):
    exact count/sum/min/max plus a bounded window of the most recent
    observations for percentiles (host-side, O(window) memory)."""

    __slots__ = ("count", "total", "min", "max", "_window")

    def __init__(self, window: int = 512):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._window: "collections.deque[float]" = collections.deque(
            maxlen=window)

    def observe(self, v: float):
        v = float(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self._window.append(v)

    @staticmethod
    def _pick(xs: List[float], p: float) -> float:
        i = min(int(round(p / 100.0 * (len(xs) - 1))), len(xs) - 1)
        return xs[i]

    def percentile(self, p: float) -> float:
        """p in [0, 100] over the recent window; 0.0 when empty."""
        if not self._window:
            return 0.0
        return self._pick(sorted(self._window), p)

    def summary(self) -> Dict[str, float]:
        """Flat summary. ``count``/``sum`` are the MONOTONIC lifetime
        totals (not the percentile window's): the sampler differentiates
        them into rates, and a bursty phase that blows past the window
        must still account for every observation. Percentiles (p50/p95)
        are over the recent window only (one shared sort — summary is on
        the sampler's per-sample path)."""
        if not self.count:
            return {"count": 0, "sum": 0.0, "p50": 0.0, "p95": 0.0,
                    "max": 0.0}
        xs = sorted(self._window)
        return {"count": self.count, "sum": round(self.total, 3),
                "p50": round(self._pick(xs, 50), 3),
                "p95": round(self._pick(xs, 95), 3),
                "max": round(self.max, 3)}


class Registry:
    """Get-or-create typed metrics + weakref providers, one namespace."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        # prefix -> (weakref to provider object, method name)
        self._providers: Dict[str, Tuple[weakref.ref, str]] = {}

    # -- owned metrics ---------------------------------------------------

    def _get(self, name: str, kind):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = kind()
        elif not isinstance(m, kind):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"asked for {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    # -- providers (legacy stats() dicts as views) -----------------------

    def register_provider(self, prefix: str, obj: Any,
                          method: str = "metrics"):
        """At snapshot time call ``obj.<method>()`` (a flat dict) and
        merge it under ``<prefix>.<key>``. Weakly referenced: a dead
        provider drops out; re-registering a prefix replaces the owner."""
        self._providers[prefix] = (weakref.ref(obj), method)

    def unregister_provider(self, prefix: str):
        self._providers.pop(prefix, None)

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """One flat {dotted-name: value} view over owned metrics and
        every live provider. Histograms flatten to .count/.sum/.p50/.max
        sub-keys. Deterministically sorted."""
        out: Dict[str, Any] = {}
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                for k, v in m.summary().items():
                    out[f"{name}.{k}"] = v
            else:
                out[name] = m.value
        dead: List[str] = []
        for prefix, (ref, method) in self._providers.items():
            obj = ref()
            if obj is None:
                dead.append(prefix)
                continue
            for k, v in getattr(obj, method)().items():
                out[f"{prefix}.{k}"] = v
        for prefix in dead:
            del self._providers[prefix]
        return dict(sorted(out.items()))

    def dump_json(self, path: str):
        """Atomic snapshot dump: write to a per-pid tempfile and rename.
        Concurrent dumpers (a sweep fanned out over processes, the same
        lesson as Autotuner.save) can't clobber each other's half-written
        file, and a crash mid-write leaves any existing ``path`` intact."""
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(self.snapshot(), f, indent=1, sort_keys=True,
                          default=str)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


#: process-wide default registry (components register into it unless
#: handed a private one)
REGISTRY = Registry()


def get_registry() -> Registry:
    return REGISTRY
