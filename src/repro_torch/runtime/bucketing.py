"""Shape bucketing — the fixed-capacity discipline behind every runtime batch.

Accelerator pipelines compile one program per input *shape*; serving
variable-length requests therefore means snapping lengths to a small set of
shape buckets, padding with sentinels that cannot perturb the true result,
and masking/unpadding on the way out. `apps/read_mapper.py` grew a private
copy of this logic (read buckets, anchor buckets, SW sentinel padding);
this module is that logic generalized so every kernel the runtime serves
shares one batcher and one compile-cache key scheme.

Two bucket policies:
  * ``linear`` — round up to a multiple of ``size`` (the read-mapper
    scheme; bounded waste ``size-1``, bucket count grows with max length).
  * ``pow2``   — round up to ``size * 2^k`` (geometric; O(log) distinct
    buckets, the usual serving choice under heavy-tailed lengths).

All helpers are host-side numpy: padding happens before dispatch, on the
host thread the pipeline overlaps with device compute (pipeline.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

Array = np.ndarray


def round_up(n: int, mult: int) -> int:
    """Smallest multiple of ``mult`` >= n (and >= mult: shapes never 0)."""
    return max(-(-n // mult), 1) * mult


def round_up_pow2(n: int, base: int) -> int:
    """Smallest ``base * 2^k`` >= n."""
    m = base
    while m < n:
        m *= 2
    return m


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Length -> padded-length policy for one array family."""
    size: int                 # bucket quantum (the read_bucket of old)
    mode: str = "linear"      # 'linear' | 'pow2'

    def padded(self, n: int) -> int:
        if self.mode == "linear":
            return round_up(n, self.size)
        if self.mode == "pow2":
            return round_up_pow2(n, self.size)
        raise ValueError(f"unknown bucket mode: {self.mode!r}")


def pad_to(x: Array, n: int, fill) -> Array:
    """Pad 1-D ``x`` to length ``n`` with ``fill`` (identity if already n)."""
    x = np.asarray(x)
    if x.shape[0] == n:
        return x
    out = np.full((n,) + x.shape[1:], fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def pad_stack(arrs: Sequence[Array], n: int, fill, dtype=None) -> Array:
    """Stack variable-length 1-D arrays into a (B, n) batch, sentinel-padded."""
    if dtype is None:
        dtype = np.asarray(arrs[0]).dtype
    out = np.full((len(arrs), n), fill, dtype=dtype)
    for i, a in enumerate(arrs):
        a = np.asarray(a, dtype=dtype)
        out[i, : a.shape[0]] = a
    return out


def lengths_of(arrs: Sequence[Array]) -> Array:
    return np.asarray([np.asarray(a).shape[0] for a in arrs], np.int32)


def valid_mask(lengths: Array, n: int) -> Array:
    """(B, n) bool mask: True on real elements, False on padding."""
    return np.arange(n)[None, :] < np.asarray(lengths)[:, None]


def unpad(stacked: Array, lengths: Array) -> List[Array]:
    """Inverse of pad_stack: slice each row back to its true length."""
    return [np.asarray(stacked[i, : int(l)])
            for i, l in enumerate(np.asarray(lengths))]


def group_by_bucket(lengths: Iterable[int], spec: BucketSpec
                    ) -> Dict[int, List[int]]:
    """Request indices grouped by padded length (one compile per key)."""
    groups: Dict[int, List[int]] = {}
    for i, n in enumerate(lengths):
        groups.setdefault(spec.padded(int(n)), []).append(i)
    return groups


def group_by_key(keys: Sequence[Tuple]) -> Dict[Tuple, List[int]]:
    """Generic grouping: indices by arbitrary hashable bucket key (multi-
    array kernels bucket on a tuple of padded shapes)."""
    groups: Dict[Tuple, List[int]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return groups


def shape_key(*arrays) -> Tuple:
    """Hashable compile-cache key for a tuple of arrays: (shape, dtype)*.

    jit caches by abstract value already; this key lets host-side caches
    (dispatch executables, autotune entries) share the same identity.
    """
    return tuple((tuple(np.asarray(a).shape), np.asarray(a).dtype.str)
                 for a in arrays)
