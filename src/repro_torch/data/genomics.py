"""Synthetic genomics inputs mirroring the paper's datasets (Table IV).

The paper evaluates on five long-read datasets with distinct sequencing
profiles; real FASTQ data is not shippable here, so we generate references
and reads with matching *statistical* profiles (length scale, error rate,
error mix). Lengths are scaled down ~10x so CPU wall-clock stays sane; the
relative behaviour across profiles (the paper's point: high-accuracy PBHF
inputs shift work from align to seed/chain) is preserved.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ReadProfile:
    name: str
    mean_len: int       # scaled-down from Table IV
    std_len: int
    accuracy: float     # per-base identity
    # error mix (fractions of errors): substitutions, insertions, deletions
    mix: Tuple[float, float, float] = (0.5, 0.25, 0.25)


# Table IV, lengths /10, accuracies as published.
PROFILES: List[ReadProfile] = [
    ReadProfile("ONT", 1771, 600, 0.85),
    ReadProfile("PBCLR", 674, 250, 0.88),
    ReadProfile("PBHF1", 1286, 400, 0.9999),
    ReadProfile("PBHF2", 1560, 450, 0.9999),
    ReadProfile("PBHF3", 1415, 420, 0.9999),
]
PROFILE_BY_NAME = {p.name: p for p in PROFILES}


def make_reference(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, n).astype(np.int8)


def mutate(read: np.ndarray, accuracy: float, mix, rng) -> np.ndarray:
    """Apply sequencing errors; returns the errored read (variable length)."""
    err = rng.random(len(read)) > accuracy
    kinds = rng.choice(3, size=len(read), p=list(mix))
    out = []
    for base, e, kind in zip(read, err, kinds):
        if not e:
            out.append(base)
        elif kind == 0:                                  # substitution
            out.append((base + rng.integers(1, 4)) % 4)
        elif kind == 1:                                  # insertion
            out.append(base)
            out.append(rng.integers(0, 4))
        # kind == 2: deletion -> emit nothing
    return np.asarray(out, dtype=np.int8)


def sample_reads(ref: np.ndarray, profile: ReadProfile, n_reads: int,
                 seed: int = 1):
    """Sample reads from the reference with the profile's error process.

    Returns list of (read, true_start) pairs.
    """
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n_reads):
        ln = int(np.clip(rng.normal(profile.mean_len, profile.std_len),
                         200, len(ref) // 2))
        start = int(rng.integers(0, len(ref) - ln))
        clean = ref[start:start + ln]
        reads.append((mutate(clean, profile.accuracy, profile.mix, rng),
                      start))
    return reads


def anchor_set(n: int, seed: int = 0, noise: int = 40,
               n_segments: int = 4, decoy_frac: float = 0.3
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic sorted anchor arrays for standalone chain benchmarks
    (Table III: ~53k anchors per input). Anchors fall on a few collinear
    segments plus a floor of decoy (repeat-hit) anchors interleaved in
    reference order — the decoys push true predecessors deeper into the
    band, which is what makes the T-truncation claim non-trivial."""
    rng = np.random.default_rng(seed)
    n_decoy = int(n * decoy_frac)
    n_real = n - n_decoy
    qs, rs = [], []
    per = max(n_real // n_segments, 1)
    for s in range(n_segments):
        q0 = rng.integers(0, 20_000)
        r0 = rng.integers(0, 1_000_000)
        q = np.sort(q0 + rng.integers(0, 8_000, per))
        r = r0 + (q - q0) + rng.integers(-noise, noise, per)
        qs.append(q)
        rs.append(r)
    if n_decoy:
        # decoys scatter across the same reference span (repeat hits)
        r_all = np.concatenate(rs)
        qd = rng.integers(0, 28_000, n_decoy)
        rd = rng.integers(int(r_all.min()), int(r_all.max()) + 1, n_decoy)
        qs.append(qd)
        rs.append(rd)
    q = np.concatenate(qs).astype(np.int32)
    r = np.concatenate(rs).astype(np.int32)
    order = np.argsort(r, kind="stable")
    return q[order], r[order]
