"""Drift audit log (repro_torch.obs): port of ``repro/obs/audit.py``.

The profile → drift-detect → tier-decide → apply loop used to leave no
record: after a run you could see *that* the policystore reported
``reuse=3 warm=1`` but not which fingerprint matched which record at
what similarity, which guard demoted a decision, or which policy was
actually applied at which step.  The audit log makes each decision a
structured event:

    {"seq": 17, "t": ..., "kind": "drift.classify",
     "tier": "reuse", "similarity": 0.993, "fp": "a3f9...",
     "record": "b21c...", "reason": "sim=0.993"}

Event kinds emitted by the wired subsystems:

  * ``stage.transition``   — StageMachine moves (WarmUp/GenPolicy/Stable)
  * ``drift.classify``     — DriftClassifier tier decision + guards
  * ``drift.demote``       — apply-time demotion (match-miss etc.)
  * ``policy.apply``       — a policy became the runtime's applied policy
  * ``policy.store_put``   — adaptation winner written back to the store
  * ``adaptation.done``    — one adaptation episode closed (tier, steps,
    seconds, GenPolicy step count)

Storage is a bounded deque (``capacity`` events, oldest dropped) plus an
optional append-only JSONL file for post-mortem inspection — attach with
``attach_file(path)``.  Like the tracer, memory never grows per event.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Deque, List, Optional

import collections

from repro_torch.obs.tracer import _json_safe


class AuditLog:
    def __init__(self, capacity: int = 4096, path: Optional[str] = None):
        self.capacity = int(capacity)
        self._events: Deque[dict] = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._path: Optional[str] = None
        self._file = None
        if path:
            self.attach_file(path)

    # ------------------------------------------------------------- writing
    def event(self, kind: str, /, **fields) -> dict:
        # reserved keys stay authoritative: a payload field named "kind"
        # must not silently rename the event
        ev = dict(_json_safe(fields))
        ev.update({"seq": None, "t": time.time(), "kind": kind})
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._events.append(ev)
            if self._file is not None:
                try:
                    self._file.write(json.dumps(ev) + "\n")
                    self._file.flush()
                except OSError:
                    self._file = None      # keep the in-memory log alive
        return ev

    def attach_file(self, path: str) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
            self._path = path
            self._file = open(path, "a")

    def detach_file(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
            self._file = None
            self._path = None

    # ------------------------------------------------------------- reading
    def tail(self, n: int = 50, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs[-n:]

    def counts(self) -> dict:
        with self._lock:
            out: dict = {}
            for e in self._events:
                out[e["kind"]] = out.get(e["kind"], 0) + 1
            return out

    def stats(self) -> dict:
        with self._lock:
            return {"n_events": self._seq,
                    "retained": len(self._events),
                    "capacity": self.capacity,
                    "file": self._path}

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._seq = 0
