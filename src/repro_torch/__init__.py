"""PyTorch / CUDA port of the Squire reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its layout
module for module (``repro_torch.core.chain`` sits beside
``repro.core.chain``) and imports nothing of it, nor JAX. Plain tensor code
is PyTorch; every Pallas TPU kernel on a ported path is a CUDA C++ kernel
for ``sm_90a`` under ``kernels/csrc/``, built at first use.

Entry points run on the card unless the caller passes ``device="cpu"``
(``repro_torch.device.resolve_device``). On a CPU tensor each kernel wrapper
runs the kernel's plain PyTorch version instead.
"""

from repro_torch.device import resolve_device  # noqa: F401
