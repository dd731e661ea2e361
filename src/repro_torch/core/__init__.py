"""Core engines: semirings, the wavefront scheduler, sort, seeding, chain,
align (SW and NW) and SpMV."""

from repro_torch.core import spmv  # noqa: F401
