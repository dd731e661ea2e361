"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` (with the headers beside it) is compiled by
``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). Libraries land in
``<checkout>/build/repro_torch/<hash of the sources and flags>/``, or under
``$REPRO_TORCH_BUILD_DIR`` when set. ``build_all`` compiles every source
at once, one ``nvcc`` process per file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("chain_scan", "dtw_wavefront", "radix_rank", "ssm_scan",
           "flash_attention", "ssm_scan_bwd", "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()
#: ptxas register / shared-memory report of the last build, per source
PTXAS_LOG: Dict[str, str] = {}


def _build_root() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot build")


def lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is (or will be) built: the hash covers the
    source, the shared headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return _build_root() / digest[:16] / f"lib{name}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, ctypes.CDLL]:
    """Compile the named sources that are not built yet, all in parallel,
    and load every one of them. Raises with nvcc's output on a failure."""
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        procs = {}
        for name in todo:
            out = lib_path(name)
            if out.exists():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            PTXAS_LOG[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in todo:
            _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
        return {n: _LIBS[n] for n in names}


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of ``csrc/<name>.cu`` with its argument
    types declared; it returns a ``cudaError_t`` as int."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        lib = _LIBS.get(name) or build_all((name,))[name]
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[(name, symbol)] = fn
    return fn


def stream(dev) -> tuple:
    """The device's index and its current stream as a raw pointer (the
    Python stream object costs several microseconds a call)."""
    import torch
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return index, torch._C._cuda_getCurrentRawStream(index)
