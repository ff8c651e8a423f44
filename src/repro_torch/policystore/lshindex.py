"""LSH band-bucket index over MinHash signatures (repro_torch.policystore).

A numpy copy of ``repro/policystore/lshindex.py`` (no JAX in it):
fingerprints, records and decisions equal the reference's for the same
inputs.

``PolicyStore.nearest`` used to score every record against the query —
O(records) Python similarity calls per lookup, an open ROADMAP item once
stores grow past ~1k records.  This index applies the standard banding
scheme: a ``n_perms``-slot MinHash signature is split into ``n_bands``
bands of ``rows`` slots each; two signatures land in the same bucket for
a band iff that band's slots are identical.  A pair with Jaccard
similarity ``j`` collides in at least one band with probability
``1 - (1 - j^rows)^n_bands`` — with the default 16 bands x 4 rows a
reuse-grade pair (j >= 0.8) is found with probability > 0.999998, while
unrelated records almost never collide, so a probe touches a handful of
records instead of the whole store.

Band hashes are 8-byte blake2b digests of the band's raw slot bytes —
stable across processes (``hash()`` is salted per interpreter), so the
index can be persisted next to the JSON records and reloaded.  Every
record is indexed under both of its fingerprints (prepare + iteration).

The index is *recall-oriented, not authoritative*: the store treats a
probe as a shortcut and falls back to a vectorized bounded scan when the
probe yields nothing reuse-grade (see ``store.nearest``), so a missed
collision can cost time, never a wrong answer.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Set, Tuple

import numpy as np

INDEX_SCHEMA = 1


def _band_digest(band_bytes: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(band_bytes, digest_size=8).digest(), "little")


class LSHIndex:
    """Band-bucket index: key -> band digests, (band, digest) -> keys."""

    def __init__(self, n_perms: int, n_bands: int):
        self.n_perms = int(n_perms)
        self.n_bands = max(1, min(int(n_bands), self.n_perms))
        self.rows = max(1, self.n_perms // self.n_bands)
        self._buckets: Dict[Tuple[int, int], Set[str]] = {}
        self._entries: Dict[str, List[int]] = {}   # key -> digests (flat)
        self.n_queries = 0
        self.n_candidates = 0                      # keys returned by queries

    # ------------------------------------------------------------ hashing
    def band_digests(self, sig: np.ndarray) -> List[int]:
        sig = np.ascontiguousarray(sig[: self.n_bands * self.rows], np.int64)
        if sig.size < self.n_bands * self.rows:    # foreign perm count:
            return []                              # unindexable, scan finds it
        bands = sig.reshape(self.n_bands, self.rows)
        return [_band_digest(bands[b].tobytes()) for b in range(self.n_bands)]

    # ------------------------------------------------------------ updates
    def add(self, key: str, sigs: Iterable[np.ndarray]) -> None:
        digests: List[int] = []
        for sig in sigs:
            digests.extend(self.band_digests(np.asarray(sig)))
        self.add_digests(key, digests)

    def add_digests(self, key: str, digests: List[int]) -> None:
        if key in self._entries:
            self.remove(key)
        self._entries[key] = list(digests)
        for b, d in enumerate(digests):
            self._buckets.setdefault((b % self.n_bands, d), set()).add(key)

    def remove(self, key: str) -> None:
        digests = self._entries.pop(key, None)
        if digests is None:
            return
        for b, d in enumerate(digests):
            bucket = self._buckets.get((b % self.n_bands, d))
            if bucket is None:
                continue
            bucket.discard(key)
            if not bucket:
                del self._buckets[(b % self.n_bands, d)]

    def clear(self) -> None:
        self._buckets.clear()
        self._entries.clear()

    # ------------------------------------------------------------- lookup
    def query(self, sig: np.ndarray) -> Set[str]:
        """Keys sharing at least one band bucket with ``sig``."""
        self.n_queries += 1
        out: Set[str] = set()
        for b, d in enumerate(self.band_digests(np.asarray(sig))):
            hit = self._buckets.get((b, d))
            if hit:
                out.update(hit)
        self.n_candidates += len(out)
        return out

    # ------------------------------------------------------ serialization
    def to_json(self) -> dict:
        return {
            "schema": INDEX_SCHEMA,
            "n_perms": self.n_perms,
            "n_bands": self.n_bands,
            "entries": {k: [str(d) for d in v]      # JSON has no int64
                        for k, v in self._entries.items()},
        }

    @classmethod
    def from_json(cls, d: dict) -> "LSHIndex":
        if d.get("schema") != INDEX_SCHEMA:
            raise ValueError(f"index schema {d.get('schema')!r}")
        idx = cls(int(d["n_perms"]), int(d["n_bands"]))
        for key, digests in d["entries"].items():
            idx.add_digests(key, [int(x) for x in digests])
        return idx

    # --------------------------------------------------------------- misc
    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> Set[str]:
        return set(self._entries)

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "buckets": len(self._buckets),
            "bands": self.n_bands,
            "rows": self.rows,
            "queries": self.n_queries,
            "candidates": self.n_candidates,
        }
