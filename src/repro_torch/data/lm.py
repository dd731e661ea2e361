"""Deterministic synthetic LM data pipeline (port of ``repro.data.lm``).

An order-1 (or order-2) Markov token source with Zipfian emission tables,
generated statelessly from (seed, step, shard) with numpy exactly as the
reference generates it, so every batch equals the reference's bit for bit;
it is handed over as int64 token and label tensors and an fp32 mask on the
requested device (the reference hands int32 JAX arrays). Any batch is
reproducible from its coordinates alone, which makes checkpoint-resume
exact: a restarted job replays from ``step``.

  * ``TokenStream(cfg, device=...).batch(step) -> {"tokens", "labels",
    "mask"}``
  * per-host sharding: ``TokenStream(..., shard=(i, n))`` yields the i-th
    of n disjoint substreams.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    branch: int = 8          # candidate successors per Markov state
    order: int = 1           # 1: state = prev token (learnable bigrams);
                             # 2: state = hash(prev2, prev1) (harder)
    n_states: int = 0        # 0 = vocab (order 1) / 4096 (order 2)
    eval_batches: int = 4    # held-out slice (steps < 0)

    @property
    def states(self) -> int:
        if self.n_states:
            return self.n_states
        return self.vocab if self.order == 1 else 4096


class TokenStream:
    """Stateless batched token source; batch(step) is pure in (cfg, step).
    Batches land on ``device`` (default: the card)."""

    def __init__(self, cfg: DataConfig, shard: Tuple[int, int] = (0, 1),
                 device: DeviceLike = None):
        self.cfg = cfg
        self.shard = shard
        self.device = resolve_device(device)
        root = np.random.default_rng(cfg.seed)
        # per-state successor tables: (states, branch) token candidates
        self._succ = root.integers(
            0, cfg.vocab, (cfg.states, cfg.branch)).astype(np.int64)
        # Zipf-ish choice distribution over the branch slots
        w = 1.0 / np.arange(1, cfg.branch + 1) ** 1.2
        self._pw = (w / w.sum()).astype(np.float64)

    def _state(self, prev2: np.ndarray, prev1: np.ndarray) -> np.ndarray:
        if self.cfg.order == 1:
            return prev1 % self.cfg.states
        h = prev2 * np.int64(1000003) + prev1 * np.int64(10007) + 12345
        return (h ^ (h >> 7)) % self.cfg.states

    def _gen_tokens(self, rng: np.random.Generator, rows: int) -> np.ndarray:
        cfg = self.cfg
        length = cfg.seq_len + 1                     # +1 for the label shift
        toks = np.zeros((rows, length), np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab, rows)
        toks[:, 1] = rng.integers(0, cfg.vocab, rows)
        choices = rng.choice(cfg.branch, size=(rows, length), p=self._pw)
        for t in range(2, length):
            st = self._state(toks[:, t - 2], toks[:, t - 1])
            toks[:, t] = self._succ[st, choices[:, t]]
        return toks

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Batch for global step ``step`` (>=0 train; <0 held-out eval)."""
        cfg = self.cfg
        i, n = self.shard
        rows = cfg.batch // n
        assert rows * n == cfg.batch, (cfg.batch, n)
        # disjoint substream per (step, shard)
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + (step + 1_000_000) * 613 + i) % 2**63)
        toks = torch.from_numpy(self._gen_tokens(rng, rows)).to(self.device)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": torch.ones((rows, cfg.seq_len), dtype=torch.float32,
                               device=self.device),
        }

    def eval_batches(self):
        for b in range(self.cfg.eval_batches):
            yield self.batch(-(b + 1))


def bigram_entropy_estimate(cfg: DataConfig, n_samples: int = 20000) -> float:
    """Monte-Carlo estimate of the source's conditional entropy (nats): the
    loss floor of a perfectly learned model."""
    stream = TokenStream(cfg, device="cpu")
    p = stream._pw
    rng = np.random.default_rng(0)
    states = rng.integers(0, cfg.states, n_samples)
    ent = 0.0
    for s in states:
        succ = stream._succ[s]
        probs: Dict[int, float] = {}
        for tok, w in zip(succ, p):
            probs[tok] = probs.get(tok, 0.0) + w
        ent += -sum(v * np.log(v) for v in probs.values())
    return float(ent / n_samples)
