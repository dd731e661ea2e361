"""Block-size / worker-count autotuner with a persistent JSON cache (port
of ``repro.runtime.autotune``).

The paper picks its design points (worker count, 1 KB/8 KB caches, T=64)
from design-space sweeps; ``benchmarks/fig9_blocksize.py`` reproduces the
sweep. This module closes the loop: sweep results (or live measurements)
are persisted per knob, and the runtime reads them back so a tuned box
serves with the measured-best tile/chunk/worker settings instead of the
static defaults.

Keys are flat strings, ``"<kernel>.<knob>"`` (e.g. ``"dtw.tile"``,
``"ssm.chunk"``, ``"chain.block"``). The cache file lives at
``$REPRO_TORCH_AUTOTUNE_CACHE`` (default
``~/.cache/repro_torch/autotune.json``), apart from the reference package's
cache, so knobs tuned there on another device do not steer this one. The
knobs change no result, only speed. A candidate is timed by the host clock
around its call and ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Dict, Iterable, Optional

import torch


def default_cache_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "autotune.json"))


def _wait(out):
    """Wait for the device work behind ``out`` (nothing to wait for on the
    CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out


class Autotuner:
    """get/put/tune over a {key: {"value", "us", "when"}} JSON cache."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self._cache: Dict[str, dict] = {}
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self._cache = json.load(f)
            except (OSError, ValueError):
                self._cache = {}

    # -- cache ---------------------------------------------------------------

    def get(self, key: str, default=None):
        entry = self._cache.get(key)
        return entry["value"] if entry else default

    def get_bucketed(self, key: str, bucket: int, default=None):
        """Per-bucket knob lookup: ``<kernel>.<knob>@b<bucket>`` first,
        then the per-kernel ``<kernel>.<knob>`` entry, then ``default``.

        The paper tunes one design point per kernel; serving sees the
        same kernel at many shape buckets, and the best block/chunk moves
        with the bucket (a 64-anchor chain wants a smaller block than a
        4096-anchor one), so sweeps persist per-bucket keys and the
        service resolves through this fallback chain."""
        got = self.get(f"{key}@b{int(bucket)}")
        if got is not None:
            return got
        return self.get(key, default)

    def put(self, key: str, value, us: Optional[float] = None,
            failed: Optional[Dict[str, str]] = None,
            candidates: Optional[Dict[str, dict]] = None):
        entry = {"value": value, "us": us, "when": time.time()}
        if failed:
            entry["failed"] = failed
        if candidates:
            # per-candidate measurement records: steady-state us plus the
            # warm (first-call) us, whose excess over steady is the
            # first-use cost
            entry["candidates"] = candidates
        self._cache[key] = entry
        self.save()

    def save(self):
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        # concurrent processes (a sweep fanned out over shapes) write the
        # shared cache too: under an flock (POSIX; best-effort elsewhere),
        # merge the on-disk entries under ours before renaming — another
        # process's keys survive our whole-file replace and the lock
        # closes the read-to-rename window — and use a per-pid tmp so
        # two writers can't clobber each other's half-written file.
        lock = open(f"{self.path}.lock", "w")
        try:
            try:
                import fcntl
                fcntl.flock(lock, fcntl.LOCK_EX)
            except ImportError:         # non-POSIX: merge without lock
                pass
            try:
                with open(self.path) as f:
                    merged = json.load(f)
            except (OSError, ValueError):
                merged = {}
            merged.update(self._cache)
            self._cache = merged
            tmp = f"{self.path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(self._cache, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        finally:
            lock.close()                # closing drops the flock

    # -- measurement ---------------------------------------------------------

    @staticmethod
    def _measure(candidates: Dict, make_thunk: Callable, repeats: int):
        """Time every candidate; returns ``(best_v, best_us, failed,
        records)``. Failing candidates are skipped, not fatal; best_us is
        inf when every candidate failed."""
        if not isinstance(candidates, dict):
            candidates = {v: v for v in candidates}
        best_v, best_us = None, float("inf")
        failed: Dict[str, str] = {}
        records: Dict[str, dict] = {}
        for label, cand in candidates.items():
            try:
                thunk = make_thunk(cand)
                t0 = time.perf_counter()
                _wait(thunk())                      # warm-up (first use)
                warm_us = (time.perf_counter() - t0) * 1e6
                ts = []
                for _ in range(repeats):
                    t0 = time.perf_counter()
                    _wait(thunk())
                    ts.append(time.perf_counter() - t0)
            except Exception as e:                  # bad candidate: skip
                failed[str(label)] = f"{type(e).__name__}: {e}"[:200]
                continue
            us = sorted(ts)[len(ts) // 2] * 1e6
            # warm - steady ~= one-time first-use cost (allocations, a
            # kernel build): the record keeps both
            records[str(label)] = {"us": round(us, 1),
                                   "warm_us": round(warm_us, 1),
                                   "compile_us": round(
                                       max(warm_us - us, 0.0), 1)}
            if us < best_us:
                best_v, best_us = cand, us
        return best_v, best_us, failed, records

    def tune(self, key: str, candidates: Dict, make_thunk: Callable,
             repeats: int = 3, force: bool = False):
        """Measure ``make_thunk(candidate)()`` per candidate, persist and
        return the fastest candidate value (must be JSON-serializable).
        Cached unless ``force``.

        candidates: a {label: value} dict or an iterable of values.

        A candidate whose thunk raises (e.g. a block size incompatible
        with the bucket shape) is SKIPPED, not fatal — the sweep still
        returns the fastest of the survivors, and the failures are
        recorded in the cache entry under ``"failed"`` for inspection.
        Only when *every* candidate fails does tune raise.
        """
        if not force:
            got = self.get(key)
            if got is not None:
                return got
        best_v, best_us, failed, records = self._measure(
            candidates, make_thunk, repeats)
        if best_us == float("inf"):
            raise RuntimeError(
                f"autotune {key!r}: every candidate failed: {failed}")
        self.put(key, best_v, us=best_us, failed=failed or None,
                 candidates=records)
        return best_v

    def retune(self, key: str, candidates: Dict, make_thunk: Callable,
               repeats: int = 3, min_improvement: float = 0.02):
        """Bounded online re-sweep (the ``obs.control.AutotuneController``
        entry point): re-measure the candidates and persist the winner only
        if it beats the incumbent entry's recorded ``us`` by at least
        ``min_improvement`` (relative), so a live knob never regresses on a
        noisy re-measurement. Returns ``(value, improved)``: the knob to use
        and whether it changed.

        Unlike :meth:`tune`, a re-sweep whose every candidate fails does not
        raise: the incumbent stays, and the failures are recorded in its
        cache entry under ``"resweep_failed"``.
        """
        incumbent = self._cache.get(key)
        best_v, best_us, failed, records = self._measure(
            candidates, make_thunk, repeats)
        if best_us == float("inf"):
            if incumbent is not None:
                incumbent = dict(incumbent)
                incumbent["resweep_failed"] = failed
                self._cache[key] = incumbent
                self.save()
                return incumbent["value"], False
            return None, False
        inc_us = incumbent.get("us") if incumbent else None
        if incumbent is not None and inc_us is not None and \
                best_us >= inc_us * (1.0 - min_improvement):
            return incumbent["value"], False        # keep the incumbent
        self.put(key, best_v, us=best_us, failed=failed or None,
                 candidates=records)
        return best_v, True


# --------------------------------------------------------------------------
# fig9 bridge: seed the cache from the design-space sweep's CSV rows
# --------------------------------------------------------------------------

_FIG9_ROW = re.compile(r"^fig9\.(?P<kernel>\w+)\.(?P<knob>[a-z]+)"
                       r"(?P<value>\d+)(?P<bucket>@b\d+)?,(?P<us>[0-9.]+),")


def seed_from_fig9(rows: Iterable[str],
                   path: Optional[str] = None) -> Dict[str, int]:
    """Parse ``fig9.<kernel>.<knob><value>[@b<bucket>],<us>,...`` rows and
    persist the fastest value per ``<kernel>.<knob>[@b<bucket>]`` knob.

    The rows are what the design-space sweep
    (``benchmarks/fig9_blocksize.py``) prints, so a sweep's output tunes
    the service.
    Bucketed rows (``@b<n>`` suffix — chain block / sort chunks swept per
    shape bucket) land on per-bucket keys that
    ``Autotuner.get_bucketed`` resolves ahead of the per-kernel entry.
    """
    best: Dict[str, tuple] = {}
    for row in rows:
        m = _FIG9_ROW.match(row)
        if not m:
            continue
        key = f"{m['kernel']}.{m['knob']}{m['bucket'] or ''}"
        us = float(m["us"])
        if key not in best or us < best[key][1]:
            best[key] = (int(m["value"]), us)
    tuner = Autotuner(path)
    for key, (value, us) in best.items():
        tuner.put(key, value, us=us)
    return {k: v for k, (v, _) in best.items()}
