"""The one traffic generator: a traffic file's schedule of sequence buckets
and the synthetic token batches of every step, drawn from ``--seed``.

Every seed gets the same schedule (batch, bucket of each step); only the
token ids differ.  Step ``k``'s batch is drawn from a numpy generator
seeded by (seed, k), so every step's rows differ and any step's batch can
be drawn again, for the reference, without the ones before it.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

_MASK63 = (1 << 63) - 1


class Schedule:
    """``batch`` rows a step; the bucket ``(step // period) % len(buckets)``
    gives the sequence length."""

    def __init__(self, traffic: Mapping):
        self.batch = int(traffic["batch"])
        self.buckets = tuple(int(s) for s in traffic["buckets"])
        self.period = int(traffic["period"])

    def bucket(self, step: int) -> int:
        return (step // self.period) % len(self.buckets)

    def seq(self, step: int) -> int:
        return self.buckets[self.bucket(step)]


def batch(schedule: Schedule, vocab: int, seed: int, step: int
          ) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, labels), each (batch, seq) int32: the next-token pairs of
    ``batch`` rows of seq + 1 ids drawn uniformly from the vocabulary."""
    rng = np.random.default_rng([seed & _MASK63, step])
    ids = rng.integers(0, vocab, (schedule.batch, schedule.seq(step) + 1),
                       dtype=np.int32)
    return ids[:, :-1], ids[:, 1:]


class Feed:
    """The program's data source: ``get()`` returns the batch of the step
    the harness set in ``step``.  The trainer reads the next batch after
    each step, so a step's batch may be asked for twice; it is drawn
    once."""

    def __init__(self, schedule: Schedule, vocab: int, seed: int):
        self.schedule, self.vocab, self.seed = schedule, vocab, seed
        self.step = 0
        self._drawn: Tuple[int, Dict[str, np.ndarray]] = (-1, {})

    @property
    def seq_len(self) -> int:
        return self.schedule.seq(self.step)

    @property
    def global_batch(self) -> int:
        return self.schedule.batch

    def get(self) -> Dict[str, np.ndarray]:
        if self._drawn[0] != self.step:
            tokens, labels = batch(self.schedule, self.vocab, self.seed,
                                   self.step)
            self._drawn = (self.step, {"tokens": tokens, "labels": labels})
        return self._drawn[1]
