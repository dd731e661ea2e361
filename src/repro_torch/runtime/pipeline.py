"""Double-buffered executor: host work overlapped with device work (port of
``repro.runtime.pipeline``).

  1. a prefetch thread pulls items from the (lazy, host-side) work
     generator, so padding for bucket i+1 happens while bucket i computes;
  2. launches queue on the card without waiting, and up to ``depth``
     launched batches stay in flight; the fence, an event recorded on the
     current stream right after the launch, is waited on only when its
     result is yielded. Results on the CPU need no fence.

``run_pipelined`` preserves input order, so callers can scatter results
back to request slots positionally.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable, Iterable, Iterator, Optional, TypeVar

import torch

from repro_torch.obs import metrics as obs_metrics

T = TypeVar("T")
R = TypeVar("R")

_STOP = object()


def prefetched(items: Iterable[T], buffer: int = 2) -> Iterator[T]:
    """Iterate ``items`` through a background thread with a bounded queue,
    so producing the next item (host padding) overlaps consumer work.
    Exceptions in the producer re-raise at the consumer; abandoning the
    iterator (consumer raised / stopped early) stops the producer rather
    than leaving it blocked on the full queue."""
    q: "queue.Queue" = queue.Queue(maxsize=max(buffer, 1))
    stop = threading.Event()

    def put(item) -> bool:
        """Bounded put that gives up when the consumer went away."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for it in items:
                if not put(it):
                    return
        except BaseException as e:            # propagate to consumer
            put((_STOP, e))
            return
        put((_STOP, None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            got = q.get()
            if isinstance(got, tuple) and len(got) == 2 \
                    and got[0] is _STOP:
                if got[1] is not None:
                    raise got[1]
                return
            yield got
    finally:
        stop.set()                            # unblock a mid-put producer


def _cuda_device(x) -> Optional[torch.device]:
    """The device of the first CUDA tensor in a nest of tuples, lists and
    dicts, or None."""
    if isinstance(x, torch.Tensor):
        return x.device if x.device.type == "cuda" else None
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for y in x:
            dev = _cuda_device(y)
            if dev is not None:
                return dev
    return None


def run_pipelined(items: Iterable[T], launch: Callable[[T], R],
                  depth: int = 2, buffer: int = 2) -> Iterator[R]:
    """Launch ``launch(item)`` for each work item, keeping up to ``depth``
    results in flight; yield completed results in input order.

    ``launch`` should queue device work and return promptly; the fence
    happens here, just before the result is handed to the caller, by which
    time the next batches are already padded (prefetch thread) and
    launched. ``runtime.pipeline.fence_ms`` records how long each fence
    kept the host waiting.
    """
    h_fence = obs_metrics.REGISTRY.histogram("runtime.pipeline.fence_ms")

    def launch_marked(item):
        out = launch(item)
        dev = _cuda_device(out)
        event = None
        if dev is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        return out, event

    def fence(marked):
        out, event = marked
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        h_fence.observe((time.perf_counter() - t0) * 1e3)
        return out

    inflight: deque = deque()
    for item in prefetched(items, buffer=buffer):
        inflight.append(launch_marked(item))
        while len(inflight) > max(depth, 1):
            yield fence(inflight.popleft())
    while inflight:
        yield fence(inflight.popleft())
