"""repro_torch.runtime — the batched kernel-dispatch runtime (port of
``repro.runtime``), the entry point for kernel work at traffic scale:

  * bucketing — shape buckets, sentinel padding, pad/mask/unpad (a copy)
  * dispatch  — batched dispatch with per-bucket stats, over an optional
                1-D worker mesh (``make_worker_mesh``)
  * service   — KernelService: heterogeneous submit(requests) -> results
  * pipeline  — host padding overlapped with device work
  * autotune  — persistent knob cache
"""

from repro_torch.runtime.autotune import Autotuner, seed_from_fig9
from repro_torch.runtime.dispatch import Dispatcher, make_worker_mesh
from repro_torch.runtime.pipeline import prefetched, run_pipelined

_SERVICE_NAMES = ("KernelService", "Request", "ServiceConfig")


def __getattr__(name):
    # service imports apps.read_mapper, which imports runtime.bucketing;
    # loading it lazily keeps `import repro_torch.apps` acyclic
    if name in _SERVICE_NAMES:
        from repro_torch.runtime import service
        return getattr(service, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Autotuner", "seed_from_fig9", "Dispatcher", "make_worker_mesh",
           "prefetched",
           "run_pipelined", "KernelService", "Request", "ServiceConfig"]
