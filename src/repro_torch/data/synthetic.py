"""Deterministic synthetic token pipeline.

Port of ``repro/data/synthetic.py``, numpy as there: the same hash, the
same Zipf marginal, the same prefetch thread and ``state()``/``restore()``,
so both packages draw identical batches from one seed.
``make_batch_specs`` gives a batch's shapes and dtypes (``TensorSpec``,
the reference's ``ShapeDtypeStruct``) for the dry run.

Production-shaped: per-host sharding (each host materializes only its slice
of the global batch), a background prefetch thread with a bounded queue, and
a resumable cursor (saved in checkpoints, so restarts are sample-exact).
Tokens are a cheap stateless hash of (seed, position) — deterministic across
restarts and host counts, with a Zipf-ish marginal so losses move.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import ModelConfig, ShapeConfig


def _hash_tokens(seed: int, start: int, count: int, vocab: int) -> np.ndarray:
    mix = (seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    idx = (np.arange(start, start + count, dtype=np.uint64)
           + np.uint64(mix))
    x = idx
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    u = (x % np.uint64(1 << 24)).astype(np.float64) / float(1 << 24)
    # Zipf-ish marginal: heavier mass on low token ids
    toks = np.minimum((vocab * (u ** 2.2)).astype(np.int64), vocab - 1)
    return toks.astype(np.int32)


@dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    prefetch: int = 2

    def __post_init__(self):
        assert self.global_batch % self.host_count == 0
        self.local_batch = self.global_batch // self.host_count
        self.cursor = 0
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ direct
    def batch_at(self, cursor: int) -> Dict[str, np.ndarray]:
        span = self.seq_len + 1
        out = np.empty((self.local_batch, span), np.int32)
        for b in range(self.local_batch):
            row = cursor * self.global_batch + self.host_index * self.local_batch + b
            out[b] = _hash_tokens(self.seed, row * span, span, self.vocab_size)
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}

    def next_batch(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.cursor)
        self.cursor += 1
        return b

    # ---------------------------------------------------------- prefetch
    def start(self):
        if self._thread is not None:
            return self
        self._q = queue.Queue(maxsize=self.prefetch)

        def worker():
            c = self.cursor
            while not self._stop.is_set():
                batch = self.batch_at(c)
                while not self._stop.is_set():
                    try:
                        self._q.put((c, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                c += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        return self

    def get(self) -> Dict[str, np.ndarray]:
        if self._q is None:
            return self.next_batch()
        c, batch = self._q.get()
        self.cursor = c + 1
        return batch

    def stop(self):
        self._stop.set()
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # ------------------------------------------------------------- state
    def state(self) -> dict:
        return {"cursor": self.cursor, "seed": self.seed}

    def restore(self, state: dict):
        self.cursor = int(state["cursor"])
        self.seed = int(state["seed"])



class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor not allocated (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def make_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                     ) -> Dict[str, TensorSpec]:
    """``TensorSpec``s of a training batch (used by ``launch.specs``)."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": TensorSpec((B, S), torch.int32),
             "labels": TensorSpec((B, S), torch.int32)}
    act = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]
    if cfg.family == "vlm":
        specs["memory"] = TensorSpec((B, cfg.image_tokens, cfg.d_model), act)
    if cfg.family == "encdec":
        specs["memory"] = TensorSpec((B, cfg.encoder_seq, cfg.d_model), act)
    return specs
