"""Persistent autotune result cache.  Port of
``repro/kernels/autotune/cache.py``.

One schema-versioned JSON file (``autotune.json`` inside the cache dir)
holds every tuned entry keyed by ``kernel|shape-bucket|dtype|device_kind``
plus the :class:`~repro_torch.hostmem.bwmodel.BandwidthModel` snapshot the
measurements were taken next to — the same restart story as the
policystore: a cold process pointed at a warm directory reuses every
tuned config (and the measured host-link efficiency) with **zero**
re-measurement.

Writes are atomic (tmp + ``os.replace`` — the policystore pattern) and
loads are corruption-safe: truncated or garbage JSON, a wrong schema
version, or malformed entries all fall back to an empty cache, never an
exception — an unreadable cache only costs a re-tune.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

from repro_torch.kernels.autotune.device import DEFAULT_DEVICE_KIND
from repro_torch.kernels.autotune.table import dtype_name, shape_bucket

SCHEMA_VERSION = 1
CACHE_FILENAME = "autotune.json"


def cache_key(kernel: str, shape: Sequence[int], dtype,
              device_kind: str) -> str:
    return (f"{kernel}|{shape_bucket(shape)}|{dtype_name(dtype)}"
            f"|{device_kind}")


class AutotuneCache:
    """In-memory entry map + the optional directory it mirrors to."""

    def __init__(self, directory: str = "",
                 device_kind: str = DEFAULT_DEVICE_KIND):
        self.dir = directory
        self.device_kind = device_kind
        self.entries: Dict[str, dict] = {}
        self.bwmodel: Optional[dict] = None    # BandwidthModel.to_dict()
        self.load_errors = 0                   # unreadable files skipped

    # ------------------------------------------------------------ lookup
    def get(self, kernel: str, shape: Sequence[int],
            dtype) -> Optional[dict]:
        return self.entries.get(
            cache_key(kernel, shape, dtype, self.device_kind))

    def put(self, kernel: str, shape: Sequence[int], dtype,
            entry: dict) -> str:
        key = cache_key(kernel, shape, dtype, self.device_kind)
        self.entries[key] = dict(entry)
        return key

    def table_entries(self) -> Dict[str, dict]:
        """Entries re-keyed for the process-wide table (device suffix
        dropped — the table serves exactly one device)."""
        out = {}
        for key, e in self.entries.items():
            kernel, bucket, dtype, kind = key.split("|")
            if kind != self.device_kind or "config" not in e:
                continue
            out[f"{kernel}|{bucket}|{dtype}"] = dict(e["config"])
        return out

    # ----------------------------------------------------- persistence
    @property
    def path(self) -> str:
        return os.path.join(self.dir, CACHE_FILENAME) if self.dir else ""

    def save(self) -> Optional[str]:
        """Atomic write (tmp + rename); no-op without a directory."""
        if not self.dir:
            return None
        os.makedirs(self.dir, exist_ok=True)
        payload = {"schema_version": SCHEMA_VERSION,
                   "device_kind": self.device_kind,
                   "entries": self.entries,
                   "bwmodel": self.bwmodel}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)
        return self.path

    @classmethod
    def load(cls, directory: str,
             device_kind: str = DEFAULT_DEVICE_KIND) -> "AutotuneCache":
        """Load a cache dir; any corruption yields an empty cache with
        ``load_errors`` counted (re-tuning is the recovery path)."""
        cache = cls(directory, device_kind)
        path = cache.path
        if not path or not os.path.exists(path):
            return cache
        try:
            with open(path) as f:
                payload = json.load(f)
            if payload.get("schema_version") != SCHEMA_VERSION:
                raise ValueError(
                    f"schema {payload.get('schema_version')!r}")
            entries = payload.get("entries", {})
            if not isinstance(entries, dict):
                raise ValueError("entries is not a mapping")
            for key, e in entries.items():
                if (isinstance(key, str) and key.count("|") == 3
                        and isinstance(e, dict)
                        and isinstance(e.get("config"), dict)):
                    cache.entries[key] = e
                else:
                    cache.load_errors += 1
            bw = payload.get("bwmodel")
            cache.bwmodel = bw if isinstance(bw, dict) else None
        except Exception:            # noqa: BLE001 — corruption-safe load
            cache.entries = {}
            cache.bwmodel = None
            cache.load_errors += 1
        return cache

    def stats(self) -> dict:
        return {"dir": self.dir, "device_kind": self.device_kind,
                "entries": len(self.entries),
                "has_bwmodel": self.bwmodel is not None,
                "load_errors": self.load_errors}
