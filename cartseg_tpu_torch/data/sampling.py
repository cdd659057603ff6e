"""Weighted mixed sampling and the pseudo-weight curriculum, host-side
and seeded (counterpart of cartseg_tpu/data/sampling.py; numpy only, so
the port keeps its own copy and tests hold the two bit-equal):

  * mixed_sample_weights / MixedSource: per-sample weight
    ratio[source] / len(source) (reference finetune_for_224.py:170-195);
  * WeightedSampler: sampling with replacement, as torch's
    WeightedRandomSampler, one `SeedSequence([seed, epoch])` stream an
    epoch, so a resumed run draws the orders of an uninterrupted one
    (also the hard x2 oversampling, finetune_pseudo_hard_clean.py:186-187);
  * curriculum_weight: the pseudo source's loss weight ramp, 0.4 -> 0.6
    over 4 epochs (finetune_for_224.py:60-65, 322-324).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class MixedSource:
    name: str
    length: int
    ratio: float
    loss_weight: float


def mixed_sample_weights(sources: Sequence[MixedSource]) -> np.ndarray:
    """Concatenated per-sample weights: ratio_s / max(1, len_s)."""
    out = []
    for s in sources:
        out += [s.ratio / max(1, s.length)] * s.length
    return np.asarray(out, np.float64)


def mixed_index_table(sources: Sequence[MixedSource]) -> List[Tuple[int, int]]:
    """Global index -> (source index, local index)."""
    table = []
    for si, s in enumerate(sources):
        table += [(si, li) for li in range(s.length)]
    return table


class WeightedSampler:
    """Sampling with replacement in proportion to weights; each epoch
    draws from its own seeded stream, distinct and reproducible."""

    def __init__(self, weights: np.ndarray, num_samples: int, seed: int = 0):
        self.p = np.asarray(weights, np.float64)
        self.p = self.p / self.p.sum()
        self.num_samples = num_samples
        self.seed = seed

    def epoch(self, epoch_idx: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch_idx]))
        return rng.choice(len(self.p), size=self.num_samples,
                          replace=True, p=self.p)


def oversample_weights(lengths: Sequence[int],
                       factors: Sequence[float]) -> np.ndarray:
    """Per-sample weights that oversample source s by factors[s]
    (e.g. hard x2.0, clean x1.0)."""
    out = []
    for n, f in zip(lengths, factors):
        out += [float(f)] * n
    return np.asarray(out, np.float64)


def curriculum_weight(epoch: int, start: float = 0.4, end: float = 0.6,
                      ramp_epochs: int = 4) -> float:
    """w(epoch) = start + min(1, (epoch + 1) / ramp) * (end - start)."""
    alpha = min(1.0, (epoch + 1) / max(1, ramp_epochs))
    return start + alpha * (end - start)
