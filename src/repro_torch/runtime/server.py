"""Batched serving: slot-based continuous batching over the decode step.

Port of ``repro/runtime/server.py``.  Requests prefill into a free slot of
the shared decode state (an indexed write along the batch dim), then every
``tick()`` advances all active slots by one token.  Completed slots free
immediately and the admission queue backfills them.

With a host-memory tier attached (``hostmem=HostMemTier()``), admission
can exceed the device-resident slot count: ``max_active`` requests run
concurrently over ``max_batch`` physical slots by parking preempted
slots' decode state in the pinned host pool (``repro_torch.hostmem.
kvspill``) and rotating them back in round-robin.  Raw spill → restore is
bit-exact, so a request decodes the same tokens whether or not it was
ever parked.

The server takes the families whose prefill the reference's server
covers: dense, moe and ssm.  The hybrid, vlm and encdec families raise, as
the reference's assertion refuses them ("others serve via decode-only"):
they decode through the model API (``init_decode_state(memory=,
params=)`` and ``decode_step``).  ``memory`` is the reference's argument,
passed to ``init_decode_state``.  The model runs eagerly under
``torch.no_grad()``; the reference's ``jax.jit`` has no counterpart here.

A shared policy store (``policystore=``, ``repro_torch.policystore``,
usually attached read-only) is reported in ``stats()``.  With
``adapt_mode`` ``async`` or ``speculative`` a one-shot background thread
re-scans the store's directory every ``_refresh_every_ticks`` ticks, so
records a training process writes become visible without a restart and
without a tick ever waiting on the disk; :meth:`close` joins it.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.adapt.service import MODES
from repro_torch.common.config import ModelConfig
from repro_torch.models.registry import get_api
from repro_torch.models.transformer import Model


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    generated: List[int] = field(default_factory=list)
    slot: int = -1
    done: bool = False
    resident_since: int = 0        # tick at which it last entered a slot
    n_spills: int = 0
    # tick-level latency bookkeeping
    submit_tick: int = 0           # tick at which the request was submitted
    first_token_tick: int = -1     # tick at which prefill produced token 0
    done_tick: int = -1            # tick at which the request completed


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Server:
    def __init__(self, cfg: ModelConfig, params: Model, *, max_batch: int = 8,
                 max_len: int = 512, memory=None,
                 max_active: Optional[int] = None, hostmem=None,
                 rotate_every: int = 1, policystore=None,
                 adapt_mode: str = "inline"):
        self.api = get_api(cfg)
        if cfg.family not in ("dense", "moe", "ssm"):
            raise NotImplementedError(
                f"the server's prefill path covers dense, moe and ssm, as "
                f"the reference's does; {cfg.family!r} serves by decode_step "
                f"alone there (others serve via decode-only)")
        if adapt_mode not in MODES:
            raise ValueError(f"adaptation mode {adapt_mode!r} not in {MODES}")
        self.cfg, self.params = cfg, params
        self.device = params.device
        self.max_batch, self.max_len = max_batch, max_len
        self.max_active = max_active if max_active is not None else max_batch
        if self.max_active > max_batch and hostmem is None:
            from repro_torch.hostmem import HostMemTier
            # over-subscription needs the tier
            hostmem = HostMemTier(device=self.device)
        self.hostmem = hostmem
        self.state = self.api.init_decode_state(cfg, max_batch, max_len,
                                                params=params, memory=memory)
        self.free_slots = list(range(max_batch))
        self.active: Dict[int, Request] = {}       # resident in a slot
        self.spilled: Dict[int, Request] = {}      # parked in the host pool
        self._spill_images: Dict[int, object] = {} # rid -> SpilledSlot
        self.completed: Dict[int, Request] = {}
        self.queue: collections.deque = collections.deque()
        self._rid = 0
        self.ticks = 0
        self.n_preemptions = 0
        # rotation quantum: swap a parked request in every k-th tick.  1 =
        # strictest fairness; larger k trades waiter latency for k-fold
        # fewer spill round trips per generated token.
        self.rotate_every = max(rotate_every, 1)
        # the shared adaptation cache and its background refresher
        self.policystore = policystore
        self.adapt_mode = adapt_mode
        self._refresh_thread: Optional[threading.Thread] = None
        self._refresh_every_ticks = 256
        self.n_store_refreshes = 0
        self.n_store_refreshed = 0
        # tick-level batching log: (resident slots at decode, wall seconds,
        # tokens emitted) per tick, and per-prefill wall seconds.  Bounded:
        # a long-running server keeps a sliding window, not full history
        self.tick_log: collections.deque = collections.deque(maxlen=4096)
        self.prefill_log: collections.deque = collections.deque(maxlen=4096)
        obs.metrics().register_provider("server", self.latency_stats)

    # ----------------------------------------------------------- admission
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> int:
        self._rid += 1
        self.queue.append(Request(self._rid, np.asarray(prompt, np.int32),
                                  max_new_tokens, eos_id,
                                  submit_tick=self.ticks))
        self._admit()
        return self._rid

    @property
    def n_active(self) -> int:
        """Concurrently admitted requests (resident + host-parked)."""
        return len(self.active) + len(self.spilled)

    def _admit(self):
        self._restore_waiting()
        while self.queue and self.n_active < self.max_active:
            slot = self._acquire_slot()
            if slot is None:
                break
            req = self.queue.popleft()
            self._place(req, slot)

    def _acquire_slot(self) -> Optional[int]:
        if self.free_slots:
            return self.free_slots.pop()
        if self.hostmem is not None and self.active:
            return self._preempt()
        return None

    @torch.no_grad()
    def _place(self, req: Request, slot: int) -> None:
        req.slot = slot
        req.resident_since = self.ticks
        toks = torch.as_tensor(req.prompt[None, :], dtype=torch.int64,
                               device=self.device)
        t0 = time.perf_counter()
        with obs.tracer().span(obs.LANE_COMPUTE, "prefill",
                               arg=(req.rid, len(req.prompt))):
            logits, pstate = self.api.prefill(self.cfg, self.params, toks,
                                              self.max_len)
            _sync(self.device)
        self.prefill_log.append(time.perf_counter() - t0)
        # write the single-request prefill state into the shared slots
        self._write_slot(pstate, slot, len(req.prompt))
        first = int(torch.argmax(logits[0, -1]))
        req.generated.append(first)
        if req.first_token_tick < 0:
            req.first_token_tick = self.ticks
        self.active[req.rid] = req

    def _write_slot(self, pstate, slot: int, plen: int) -> None:
        """In place: batch row ``slot`` of every state tensor takes the
        prefill state (the reference's ``.at[:, slot].set``)."""
        for name in self.state._fields:
            cur = getattr(self.state, name)
            new = getattr(pstate, name, None)
            if cur is None or new is None:
                continue
            if name == "pos":
                cur[slot] = plen
            else:
                # (L, B, ...) — write batch row `slot`
                cur[:, slot] = new[:, 0].to(cur.dtype)

    # ------------------------------------------------------- kv-cache spill
    def _preempt(self) -> int:
        """Park the longest-resident request's slot state in the host pool
        and hand its slot to the caller.  The spill fences the current
        stream, so the caller may overwrite the row at once."""
        victim = min(self.active.values(),
                     key=lambda r: (r.resident_since, r.rid))
        del self.active[victim.rid]
        self._spill_images[victim.rid] = self.hostmem.kvspill.spill(
            self.state, victim.slot, tag=f"req{victim.rid}")
        slot, victim.slot = victim.slot, -1
        victim.n_spills += 1
        self.spilled[victim.rid] = victim
        self.n_preemptions += 1
        return slot

    @torch.no_grad()
    def _restore_one(self, req: Request, slot: int) -> None:
        sp = self._spill_images.pop(req.rid)
        del self.spilled[req.rid]
        self.state = self.hostmem.kvspill.restore(self.state, sp, slot)
        req.slot = slot
        req.resident_since = self.ticks
        self.active[req.rid] = req

    def _restore_waiting(self) -> None:
        """Oldest parked requests take any free slots before new admission."""
        while self.free_slots and self.spilled:
            req = min(self.spilled.values(), key=lambda r: r.rid)
            self._restore_one(req, self.free_slots.pop())

    def _rotate(self) -> None:
        """Round-robin: one parked request trades places with the
        longest-resident slot every ``rotate_every`` ticks, so nobody
        starves."""
        if not self.spilled or self.hostmem is None or not self.active:
            return
        if self.ticks % self.rotate_every:
            return
        waiter = min(self.spilled.values(), key=lambda r: r.rid)
        slot = self._preempt()
        self._restore_one(waiter, slot)

    # ---------------------------------------------------------------- tick
    @torch.no_grad()
    def tick(self) -> Dict[int, int]:
        """Advance all resident slots one token; returns {rid: token}."""
        t0 = time.perf_counter()
        self._admit()
        if not self.active:
            return {}
        n_resident = len(self.active)
        tokens = np.zeros((self.max_batch, 1), np.int64)
        for req in self.active.values():
            tokens[req.slot, 0] = req.generated[-1]
        with obs.tracer().span(obs.LANE_COMPUTE, "decode_tick",
                               arg=(self.ticks, n_resident)):
            logits, self.state = self.api.decode_step(
                self.cfg, self.params,
                torch.as_tensor(tokens, device=self.device), self.state)
            nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        out = {}
        finished = []
        for req in self.active.values():
            tok = int(nxt[req.slot])
            req.generated.append(tok)
            out[req.rid] = tok
            if (len(req.generated) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id)):
                req.done = True
                finished.append(req.rid)
        for rid in finished:
            req = self.active.pop(rid)
            req.done_tick = self.ticks
            self.completed[rid] = req
            self.free_slots.append(req.slot)
        self.ticks += 1
        self._admit()
        self._rotate()
        if self.ticks % self._refresh_every_ticks == 0:
            self._refresh_store()
        self.tick_log.append((n_resident, time.perf_counter() - t0, len(out)))
        return out

    def _refresh_store(self) -> None:
        """Kick one background store re-scan (never blocks the tick; a
        still-running previous scan is left to finish)."""
        if self.adapt_mode == "inline" or self.policystore is None:
            return
        if self._refresh_thread is not None and self._refresh_thread.is_alive():
            return

        def _scan():
            self.n_store_refreshed += self.policystore.refresh()
            self.n_store_refreshes += 1

        self._refresh_thread = threading.Thread(
            target=_scan, name="store-refresh", daemon=True)
        self._refresh_thread.start()

    def close(self, timeout: float = 30.0) -> None:
        """Wait for a running store re-scan to finish."""
        if self._refresh_thread is not None:
            self._refresh_thread.join(timeout)

    def run_until_done(self, max_ticks: int = 1000) -> Dict[int, List[int]]:
        for _ in range(max_ticks):
            if not self.active and not self.queue and not self.spilled:
                break
            self.tick()
        return {rid: req.generated for rid, req in self.completed.items()}

    # --------------------------------------------------------------- stats
    @staticmethod
    def _pct(xs: List[float], q: float) -> float:
        if not xs:
            return 0.0
        xs = sorted(xs)
        return xs[min(int(q * len(xs)), len(xs) - 1)]

    def latency_stats(self) -> dict:
        """Tick-level batching stats: per-tick wall time, slot occupancy,
        per-request queue-wait / completion-span percentiles (in ticks) and
        per-prefill wall time.  Tick-derived numbers cover the
        ``tick_log`` window (last 4096 ticks)."""
        done = list(self.completed.values())
        waits = [float(r.first_token_tick - r.submit_tick)
                 for r in done if r.first_token_tick >= 0]
        spans = [float(r.done_tick - r.submit_tick)
                 for r in done if r.done_tick >= 0]
        tick_s = [dt for _, dt, _ in self.tick_log]
        occ = [n / self.max_batch for n, _, _ in self.tick_log]
        toks = sum(k for _, _, k in self.tick_log)
        total_s = sum(tick_s)
        pre_s = list(self.prefill_log)
        return {
            "n_completed": len(done),
            "ticks": len(self.tick_log),
            "tokens": toks,
            "tokens_per_s": toks / total_s if total_s > 0 else 0.0,
            "tokens_per_tick": toks / max(len(self.tick_log), 1),
            "slot_occupancy": float(np.mean(occ)) if occ else 0.0,
            "tick_ms": {"p50": self._pct(tick_s, 0.5) * 1e3,
                        "p95": self._pct(tick_s, 0.95) * 1e3,
                        "max": (max(tick_s) if tick_s else 0.0) * 1e3},
            "prefill_ms": {"n": len(pre_s),
                           "p50": self._pct(pre_s, 0.5) * 1e3,
                           "p95": self._pct(pre_s, 0.95) * 1e3,
                           "max": (max(pre_s) if pre_s else 0.0) * 1e3},
            "queue_wait_ticks": {"p50": self._pct(waits, 0.5),
                                 "p95": self._pct(waits, 0.95),
                                 "max": max(waits) if waits else 0.0},
            "completion_ticks": {"p50": self._pct(spans, 0.5),
                                 "p95": self._pct(spans, 0.95),
                                 "max": max(spans) if spans else 0.0},
        }

    def stats(self) -> dict:
        hm = self.hostmem.stats() if self.hostmem else None
        # surface the serving-relevant traffic class directly: spill time
        # lost to other link traffic is a tick-latency component
        kv_cls = (hm["engine"]["classes"]["kv_spill"]
                  if hm is not None else None)
        return {
            "ticks": self.ticks,
            "active": len(self.active),
            "spilled": len(self.spilled),
            "queued": len(self.queue),
            "completed": len(self.completed),
            "preemptions": self.n_preemptions,
            "kv_spill_class": kv_cls,
            "hostmem": hm,
            "latency": self.latency_stats(),
            "policystore": (self.policystore.stats()
                            if self.policystore is not None else None),
            "adapt": {"mode": self.adapt_mode,
                      "store_refreshes": self.n_store_refreshes,
                      "store_records_refreshed": self.n_store_refreshed},
        }
