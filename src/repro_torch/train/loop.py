"""Fault-tolerant training loop: checkpoint/restart, stragglers (port of
``repro.train.loop``).

The loop composes the train step (train.step) with the runtime concerns of
a long job:

  * **checkpoint/restart** - async step-atomic snapshots every
    ``ckpt_every`` steps (train.checkpoint); on start the loop resumes from
    the newest complete checkpoint.
  * **straggler mitigation** - a wall-clock watchdog keeps a robust EMA of
    step time; steps slower than ``straggler_factor`` x the EMA are counted
    and reported through ``on_straggler``.
  * **failure handling** - an exception from the step restores the newest
    checkpoint into the state, on the same device, and continues (or starts
    over from the seed when there is none yet). Unlike the reference, the
    restart first waits for an async save still in flight, so the snapshot
    it was writing is the one restored. ``FailureInjector``
    simulates a device failure for tests.
  * **data determinism** - batches are pure functions of the step index
    (data.lm), so a restart replays the exact stream.

Where the reference re-jits against a new mesh after a failure (its
elastic restart), the port runs on one card: ``mesh`` and
``make_mesh_after_failure`` raise ``NotImplementedError`` unless None. The
loop is host-driven; metrics are fetched every ``log_every`` steps (a
fetch waits for the card).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.train import step as step_lib
from repro_torch.train.checkpoint import Checkpointer


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    keep_ckpts: int = 3
    straggler_factor: float = 3.0
    straggler_warmup: int = 5      # steps before the EMA is trusted
    ema_beta: float = 0.9
    max_restarts: int = 3


class StragglerWatchdog:
    """Robust step-time EMA + slow-step detector (the mitigation signal)."""

    def __init__(self, cfg: LoopConfig):
        self.cfg = cfg
        self.ema: Optional[float] = None
        self.n = 0
        self.events: List[Dict[str, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n == 1:
            return False        # the first step builds and warms up
        if self.ema is None:
            self.ema = dt
            return False
        slow = (self.n > self.cfg.straggler_warmup
                and dt > self.cfg.straggler_factor * self.ema)
        if slow:
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
        else:
            # stragglers are excluded from the EMA (robustness)
            b = self.cfg.ema_beta
            self.ema = b * self.ema + (1 - b) * dt
        return slow


class FailureInjector:
    """Deterministic failure schedule for tests and the smoke run.

    ``fail_at``: steps at which the injected exception fires (once each).
    """

    def __init__(self, fail_at=(), exc_factory=None):
        self.pending = set(fail_at)
        self.exc_factory = exc_factory or (
            lambda s: RuntimeError(f"injected device failure at step {s}"))

    def maybe_fail(self, step: int):
        if step in self.pending:
            self.pending.discard(step)
            raise self.exc_factory(step)


@dataclasses.dataclass
class TrainResult:
    final_step: int
    metrics_history: List[Dict[str, float]]
    straggler_events: List[Dict[str, float]]
    restarts: int
    losses: List[float]
    state: Any = None              # the final TrainState (the port's)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(cfg: ModelConfig,
          batch_fn: Callable[[int], Dict[str, Any]],
          loop_cfg: LoopConfig = LoopConfig(),
          opt_cfg: AdamWConfig = AdamWConfig(),
          ckpt_dir: Optional[str] = None,
          mesh=None,
          seed: int = 0,
          compress: bool = False,
          failure_injector: Optional[FailureInjector] = None,
          make_mesh_after_failure: Optional[Callable[[int], Any]] = None,
          on_straggler: Optional[Callable[[int, float], None]] = None,
          verbose: bool = True,
          device: DeviceLike = None) -> TrainResult:
    """Run the loop on ``device`` (default: the card); ``batch_fn(step)``
    gives batches on that device. Returns the metric history (losses
    fetched to the host) and the final state."""
    if mesh is not None or make_mesh_after_failure is not None:
        raise NotImplementedError(
            "train(mesh=...) / make_mesh_after_failure: the port trains on "
            "one card; the sharded step is not ported (ROADMAP queue 1)")
    dev = resolve_device(device)
    ckpt = Checkpointer(ckpt_dir, keep=loop_cfg.keep_ckpts) \
        if ckpt_dir else None

    def fresh():
        return step_lib.init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(seed),
            compress=compress, device=dev)

    state = fresh()
    step_fn = step_lib.make_train_step(cfg, opt_cfg, compress=compress)

    start = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state, extra = ckpt.restore(state)
        start = int(extra.get("next_step", ckpt.latest_step()))
        if verbose:
            print(f"[loop] resumed from checkpoint at step {start}")

    watchdog = StragglerWatchdog(loop_cfg)
    history: List[Dict[str, float]] = []
    losses: List[float] = []
    restarts = 0
    i = start
    while i < loop_cfg.total_steps:
        t0 = time.time()
        try:
            if failure_injector is not None:
                failure_injector.maybe_fail(i)
            batch = batch_fn(i)
            state, metrics = step_fn(state, batch)
        except Exception as e:  # noqa: BLE001 - any step failure
            if restarts >= loop_cfg.max_restarts or ckpt is None:
                raise
            restarts += 1
            if verbose:
                print(f"[loop] step {i} failed ({e}); restart #{restarts}")
            for p in state.params.parameters():
                p.grad = None
            ckpt.wait()     # a snapshot still being written counts
            if ckpt.latest_step() is not None:
                state, extra = ckpt.restore(state)
                i = int(extra.get("next_step", ckpt.latest_step()))
            else:
                del state
                state = fresh()
                i = 0
            continue

        if (i + 1) % loop_cfg.log_every == 0 or i + 1 == loop_cfg.total_steps:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            history.append(m)
            losses.append(m["loss"])
            if verbose:
                print(f"[loop] step {i:5d} loss={m['loss']:.4f} "
                      f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.2f}")
        else:
            _sync(dev)              # the step's time, for the watchdog
        dt = time.time() - t0
        if watchdog.observe(i, dt) and on_straggler is not None:
            on_straggler(i, dt)

        i += 1
        if ckpt is not None and i % loop_cfg.ckpt_every == 0:
            ckpt.save_async(i, state, extra={"next_step": i})

    if ckpt is not None:
        ckpt.save(loop_cfg.total_steps, state,
                  extra={"next_step": loop_cfg.total_steps})
    return TrainResult(final_step=i, metrics_history=history,
                       straggler_events=watchdog.events, restarts=restarts,
                       losses=losses, state=state)
