"""Semirings for dependency-bound recurrences (port of ``repro.core.semiring``).

Every kernel the paper accelerates is an affine recurrence
``x_t = (a_t (*) x_{t-1}) (+) b_t`` over a semiring ``((+), (*))``:
(max,+) for chain and Smith-Waterman, (min,+) for DTW, (+,*) for the
diagonal-linear SSM scans. ``core.chain.chain_blocked`` composes max-plus
transfer matrices with ``MAXPLUS.matmul``; ``core.scan1d`` composes the
elementwise affine maps (``affine_apply``, ``affine_compose``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A commutative-monoid pair ((+), (*)) with (+)-identity ``zero`` and
    (*)-identity ``one``."""

    name: str
    add: Callable[[Tensor, Tensor], Tensor]
    mul: Callable[[Tensor, Tensor], Tensor]
    zero: float
    one: float

    def add_reduce(self, x: Tensor, dim: int) -> Tensor:
        if self.name == "real":
            return torch.sum(x, dim=dim)
        if self.name == "maxplus":
            return torch.amax(x, dim=dim)
        if self.name == "minplus":
            return torch.amin(x, dim=dim)
        raise NotImplementedError(self.name)

    def matmul(self, a: Tensor, b: Tensor) -> Tensor:
        """Generalized matmul over the semiring: (..., m, k) x (..., k, n)."""
        if self.name == "real":
            return torch.matmul(a, b)
        prod = self.mul(a[..., :, :, None], b[..., None, :, :])
        return self.add_reduce(prod, dim=-2)

    def affine_apply(self, a: Tensor, b: Tensor, x: Tensor) -> Tensor:
        """x' = (a (*) x) (+) b, elementwise (diagonal transition)."""
        return self.add(self.mul(a, x), b)

    def affine_compose(self, a1: Tensor, b1: Tensor, a2: Tensor,
                       b2: Tensor):
        """Compose elementwise affine maps: apply (a1, b1) first, then
        (a2, b2): ((a2 (*) a1), (a2 (*) b1) (+) b2)."""
        return self.mul(a2, a1), self.add(self.mul(a2, b1), b2)


REAL = Semiring("real", add=torch.add, mul=torch.mul, zero=0.0, one=1.0)
MAXPLUS = Semiring("maxplus", add=torch.maximum, mul=torch.add,
                   zero=-math.inf, one=0.0)
MINPLUS = Semiring("minplus", add=torch.minimum, mul=torch.add,
                   zero=math.inf, one=0.0)

SEMIRINGS = {s.name: s for s in (REAL, MAXPLUS, MINPLUS)}


def finite_zero(sr: Semiring, dtype: torch.dtype) -> Tensor:
    """A finite stand-in for the (+)-identity, safe for integer dtypes."""
    if dtype.is_floating_point:
        return torch.tensor(sr.zero, dtype=dtype)
    info = torch.iinfo(dtype)
    if sr.name == "maxplus":
        return torch.tensor(info.min // 2, dtype=dtype)
    if sr.name == "minplus":
        return torch.tensor(info.max // 2, dtype=dtype)
    return torch.tensor(0, dtype=dtype)
