"""Step-atomic checkpointing with an async writer (port of
``repro.train.checkpoint``).

Layout (one directory per step), as the reference's:

    <root>/step_00000042/
        MANIFEST.json        # leaf paths, shapes, dtypes, metadata
        leaf_00000.npy ...   # one .npy per leaf (a host copy)

Atomicity: everything is written into ``step_N.tmp`` and the directory is
renamed to ``step_N`` only after an fsync'd manifest, so a crash mid-write
leaves a ``.tmp`` that restore ignores and a later save clears away; the
newest complete directory is always a consistent (params, opt, step)
snapshot.

A tree is a ``TrainState`` (or any NamedTuple), a dict, an
``nn.Module`` (its named parameters) or a tensor; None leaves are
skipped. Leaf paths join the keys with ``/`` (``params/layers.0.attn.wq``,
``opt/mu/...``, ``step``). bfloat16 leaves are stored bit-cast to uint16
(numpy has no bfloat16) and restored through the manifest's dtype.

Restore writes into the tensors of the tree it is given, on their device,
after checking every leaf's shape against the checkpoint (a mismatch
raises before anything is written). The reference returns new arrays
placed by a sharding; in place, a 40 GB train state needs no second copy
on the card. Async: ``save_async`` copies to host memory now and writes
the files on a thread, overlapping the next training steps; ``wait()``
joins it (and raises what it raised).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

PREFIX = "step_"
TMP_SUFFIX = ".tmp"

_BITCAST = {torch.bfloat16: (torch.int16, np.uint16)}


def _flatten(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) pairs of a tree, in a stable order."""
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: str(k))
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, nn.Module):
        return [(join(n), p) for n, p in tree.named_parameters()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = list(tree.items())
    else:
        raise TypeError(f"checkpoint: cannot store a {type(tree).__name__} "
                        f"at {prefix!r}")
    out = []
    for k, v in items:
        out.extend(_flatten(v, join(k)))
    return out


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _host_value(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy (bfloat16 bit-cast to uint16), never a view of a
    tensor that the next step updates in place."""
    t = t.detach()
    alt = _BITCAST.get(t.dtype)
    if alt is not None:
        a = t.view(alt[0]).cpu().numpy().view(alt[1])
    else:
        a = t.cpu().numpy()
    return a.copy() if t.device.type == "cpu" else a


def _from_saved(v: np.ndarray, dtype_str: str) -> torch.Tensor:
    out = torch.from_numpy(np.array(v, order="C"))
    dt = getattr(torch, dtype_str)
    if dt in _BITCAST:
        out = out.view(_BITCAST[dt][0]).view(dt)
    return out


def _write_dir(root: Path, step: int, paths: List[str],
               host_leaves: List[np.ndarray], dtypes: List[str],
               extra: dict) -> Path:
    final = root / f"{PREFIX}{step:08d}"
    tmp = Path(str(final) + TMP_SUFFIX)
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "time": time.time(), "extra": extra,
                "leaves": []}
    for i, (p, v, dt) in enumerate(zip(paths, host_leaves, dtypes)):
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, v)
        manifest["leaves"].append(
            {"path": p, "file": fname, "shape": list(v.shape), "dtype": dt})
    mf = tmp / "MANIFEST.json"
    mf.write_text(json.dumps(manifest))
    fd = os.open(mf, os.O_RDONLY)
    os.fsync(fd)
    os.close(fd)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class Checkpointer:
    """Async, step-atomic checkpointer with retention-based GC."""

    def __init__(self, root: os.PathLike, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def _snapshot(self, tree):
        pairs = _flatten(tree)
        return ([p for p, _ in pairs], [_host_value(t) for _, t in pairs],
                [_dtype_name(t) for _, t in pairs])

    def save(self, step: int, tree, extra: Optional[dict] = None) -> Path:
        """Synchronous save (at shutdown, in tests)."""
        self.wait()
        out = _write_dir(self.root, step, *self._snapshot(tree), extra or {})
        self._gc()
        return out

    def save_async(self, step: int, tree, extra: Optional[dict] = None):
        """Snapshot to host now; write files on a daemon thread."""
        self.wait()
        snap = self._snapshot(tree)      # sync device -> host copy

        def work():
            try:
                _write_dir(self.root, step, *snap, extra or {})
                self._gc()
            except BaseException as e:  # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore --------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = sorted(self._complete_steps())
        return steps[-1] if steps else None

    def restore(self, tree, step: Optional[int] = None) -> Tuple[Any, dict]:
        """Restore into the tensors of ``tree``, in place on their devices.
        Returns (tree, extra_metadata)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.root}")
        d = self.root / f"{PREFIX}{step:08d}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        by_path = {e["path"]: e for e in manifest["leaves"]}
        pairs = _flatten(tree)
        for p, like in pairs:
            e = by_path.get(p)
            if e is None:
                raise KeyError(f"checkpoint {d} missing leaf {p!r}")
            if tuple(e["shape"]) != tuple(like.shape):
                raise ValueError(
                    f"leaf {p!r}: checkpoint shape {tuple(e['shape'])} != "
                    f"model shape {tuple(like.shape)}")
        with torch.no_grad():
            for p, like in pairs:
                e = by_path[p]
                v = _from_saved(np.load(d / e["file"]), e["dtype"])
                like.copy_(v.to(like.device))
        return tree, manifest.get("extra", {})

    # -- util ---------------------------------------------------------------

    def _complete_steps(self) -> List[int]:
        out = []
        for d in self.root.iterdir():
            if (d.name.startswith(PREFIX) and not d.name.endswith(TMP_SUFFIX)
                    and (d / "MANIFEST.json").exists()):
                out.append(int(d.name[len(PREFIX):]))
        return out

    def _gc(self):
        # drop orphaned tmp dirs and checkpoints beyond the retention window
        for d in self.root.iterdir():
            if d.name.endswith(TMP_SUFFIX):
                mtime = d.stat().st_mtime
                if time.time() - mtime > 60:
                    shutil.rmtree(d, ignore_errors=True)
        steps = sorted(self._complete_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.root / f"{PREFIX}{s:08d}",
                          ignore_errors=True)
