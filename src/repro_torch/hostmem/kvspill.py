"""KV-cache spill/restore: park a decode slot's state in the host pool.

Port of ``repro/hostmem/kvspill.py``.  A serving slot is one batch row of
the model's ``DecodeState`` (stacked ``(L, B, ...)`` tensors plus a
``pos`` entry).  Spilling stages row ``slot`` of every populated field
into **one packed slab** through a single ``kv_spill``-class transfer —
one pool slab and one engine copy per spill, so the pool sees one size
class per slot shape and the strict-priority engine one queue entry per
preemption.  The packed layout is the reference's, byte for byte: fields
in ``STATE_FIELDS`` order, back to back, an int8 field's f32 row scales
right after its payload.  Restoring brings the image back with one H2D
copy and writes each field into the slot row, so a request decodes
exactly where it left off.

Round trip is exact by default: the slab stages raw bytes, and the row is
copied layer by layer straight out of the cache (``cache[l, slot]`` is
contiguous, ``cache[:, slot]`` is not), with no packed copy on the device.
Since the server overwrites the row right after a spill, the spill fences
the current stream on the D2H's done-event (``TransferEngine.fence``): the
next writes to the row wait for the copy on the device, with no host sync.

With ``compression="int8"`` (``HostMemConfig.spill_compression``) float
rows big enough to matter cross the link as row-quantized int8 payloads
plus f32 scales: K2a quantizes the slot row in place on the current
stream, so only the int8 payload and the scales cross the link (about
1.94x fewer bytes than a bf16 row), and on restore K2b writes the row
from the image (at most half a quantization step of error per element).
The reference pulls the row to the host to quantize it; the port never
does.  Integer fields and small rows stay raw.  ``compression="auto"``
makes raw-vs-int8 a *priced* decision: a
:class:`~repro_torch.kernels.autotune.advisor.CompressionAdvisor` compares
the measured link time of the raw row against K2a + the smaller transfer +
K2b at the tuned kernel rates, per row shape; without an advisor it is the
static int8 rule.

Lifetime rules (regression-tested): ``restore`` *consumes* the spill
image (the staged event is cleared, its slab freed by the H2D copy), and
``discard`` is idempotent — discarding a restored or already-discarded
image is a no-op, never a double free.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.hostmem.engine import (TC_KV_SPILL, TransferEngine,
                                        TransferEvent)
from repro_torch.hostmem.pool import HostMemError, PinnedSlabPool
from repro_torch.kernels.autotune.advisor import COMPRESS_INT8
from repro_torch.kernels.quant_offload import ops as Q

STATE_FIELDS = ("attn_k", "attn_v", "ssm_conv", "ssm_ssd",
                "cross_k", "cross_v")

SPILL_COMPRESSIONS = ("none", "int8", "auto")


@dataclass
class FieldSlice:
    """Where one state field's row lives inside the packed image."""
    name: str
    offset: int
    nbytes: int
    shape: Tuple[int, ...]
    dtype: Any
    kind: str = "raw"              # raw | int8 (row-quantized payload)
    scale_offset: int = 0          # int8 only: f32 row scales in the image
    scale_nbytes: int = 0


@dataclass
class SpilledSlot:
    """Host-resident packed image of one decode slot."""
    tag: str
    pos: int
    layout: List[FieldSlice] = field(default_factory=list)
    nbytes: int = 0
    event: Optional[TransferEvent] = None   # None once restored/discarded

    @property
    def consumed(self) -> bool:
        return self.event is None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _field(packed: torch.Tensor, offset: int, nbytes: int,
           dtype: torch.dtype, shape) -> torch.Tensor:
    """Bytes ``[offset, offset + nbytes)`` of the image as ``dtype`` of
    ``shape``; copied first when the offset is not aligned to the dtype
    (an int8 payload of odd size leaves the scales after it unaligned)."""
    b = packed[offset:offset + nbytes]
    itemsize = torch.empty((), dtype=dtype).element_size()
    if offset % itemsize:
        b = b.clone()
    return b.view(dtype).view(shape)


class KVSpillManager:
    def __init__(self, pool: PinnedSlabPool, engine: TransferEngine,
                 compression: str = "none",
                 compress_min_bytes: int = 1 << 12, advisor=None):
        if compression not in SPILL_COMPRESSIONS:
            raise ValueError(f"unknown spill compression {compression!r}; "
                             f"expected one of {SPILL_COMPRESSIONS}")
        self.pool = pool
        self.engine = engine
        self.compression = compression
        self.compress_min_bytes = compress_min_bytes
        # "auto": a repro_torch.kernels.autotune.advisor.CompressionAdvisor
        # that prices raw-vs-int8 per row from the tuned kernel rates and
        # the measured link curve; without one, auto degrades to "int8"
        self.advisor = advisor
        self.n_spills = self.n_restores = self.n_discards = 0
        self.bytes_spilled = self.bytes_restored = 0
        self.live_bytes = 0          # spill images currently host-resident
        self.hwm_live_bytes = 0      # ... and their high-water mark
        self.bytes_raw = 0             # pre-compression row bytes

    def _compressible(self, arr: torch.Tensor, row_nbytes: int,
                      row_shape=()) -> bool:
        if (self.compression not in ("int8", "auto")
                or row_nbytes < self.compress_min_bytes
                or not arr.dtype.is_floating_point
                or arr.element_size() <= 1):
            return False
        if self.compression == "int8" or self.advisor is None:
            return True              # static rule (auto w/o advisor too)
        rows = math.prod(row_shape[:-1]) if len(row_shape) > 1 else 1
        choice, _ = self.advisor.decide(row_nbytes, arr.element_size(), rows,
                                        cls=TC_KV_SPILL, tag="kvspill")
        return choice == COMPRESS_INT8

    # -------------------------------------------------------------- spill
    def spill(self, state, slot: int, tag: str = "") -> SpilledSlot:
        """Stage batch row ``slot`` of every state field into one packed
        slab with a single kv_spill-class D2H copy.  The row may be
        overwritten on the current stream as soon as this returns."""
        with obs.tracer().span(obs.LANE_KV_SPILL, "kv.pack",
                               arg=(tag or "kvslot", slot)):
            return self._spill(state, slot, tag)

    def _spill(self, state, slot: int, tag: str = "") -> SpilledSlot:
        sp = SpilledSlot(tag, pos=int(state.pos[slot]))
        chunks: List[torch.Tensor] = []
        raw_rows = False
        off = 0
        for name in STATE_FIELDS:
            arr = getattr(state, name, None)
            if arr is None:
                continue
            row = arr[:, slot]
            row_nbytes = _nbytes(row)
            self.bytes_raw += row_nbytes
            if self._compressible(arr, row_nbytes, tuple(row.shape)):
                q, s = Q.quantize(row)          # K2a, on the current stream
                qn, sn = _nbytes(q), _nbytes(s)
                sp.layout.append(FieldSlice(
                    name, off, qn, tuple(q.shape), torch.int8, kind="int8",
                    scale_offset=off + qn, scale_nbytes=sn))
                chunks.extend([q, s])
                off += qn + sn
                continue
            sp.layout.append(FieldSlice(name, off, row_nbytes,
                                        tuple(row.shape), arr.dtype))
            chunks.extend(row.unbind(0))        # L contiguous layer rows
            raw_rows = True
            off += row_nbytes
        sp.nbytes = off
        if off:
            sp.event = self.engine.submit_swap_out(
                chunks, tag or "kvslot", cls=TC_KV_SPILL)
            if raw_rows:                        # the row is the D2H source
                self.engine.fence(sp.event)
        self.n_spills += 1
        self.bytes_spilled += sp.nbytes
        self.live_bytes += sp.nbytes
        self.hwm_live_bytes = max(self.hwm_live_bytes, self.live_bytes)
        return sp

    # ------------------------------------------------------------ restore
    def restore(self, state, sp: SpilledSlot, slot: int):
        """Swap a spilled slot image back into row ``slot`` of ``state``
        (in place; the state is returned).  Consumes the image: the staged
        event is cleared so a later ``discard`` is a no-op rather than a
        double free."""
        with obs.tracer().span(obs.LANE_KV_SPILL, "kv.restore",
                               arg=(sp.tag, slot, sp.nbytes)):
            return self._restore(state, sp, slot)

    def _restore(self, state, sp: SpilledSlot, slot: int):
        if sp.nbytes and sp.event is None:
            raise HostMemError(
                f"restore of consumed spill image {sp.tag!r}: it was "
                "already restored or discarded")
        if sp.nbytes:
            # auto-chains if the swap-out is still queued; the retired H2D
            # frees the slab, and its result is ready for every stream
            ev_in = self.engine.wait(self.engine.submit_swap_in(
                sp.event, sp.tag, cls=TC_KV_SPILL))
            sp.event = None                       # consumed
            packed = ev_in.result
            for fs in sp.layout:
                dst = getattr(state, fs.name)[:, slot]
                if fs.kind == "int8":
                    q = _field(packed, fs.offset, fs.nbytes, torch.int8,
                               fs.shape)
                    s = _field(packed, fs.scale_offset, fs.scale_nbytes,
                               torch.float32, fs.shape[:-1] + (1,))
                    Q.dequantize(q, s, out=dst)   # K2b into the slot row
                else:
                    dst.copy_(_field(packed, fs.offset, fs.nbytes, fs.dtype,
                                     fs.shape))
        state.pos[slot] = sp.pos
        self.n_restores += 1
        self.bytes_restored += sp.nbytes
        self.live_bytes = max(self.live_bytes - sp.nbytes, 0)
        return state

    def discard(self, sp: SpilledSlot) -> None:
        """Drop a spill image (request cancelled) — the slab goes back to
        the pool without an H2D copy.  Idempotent: discarding a restored
        or already-discarded image is a no-op."""
        ev, sp.event = sp.event, None
        if ev is None:
            return
        self.engine.wait(ev)                      # staging must retire
        if ev.block is not None:                  # None: D2H failed, no slab
            self.pool.free(ev.block)
        self.n_discards += 1
        self.live_bytes = max(self.live_bytes - ev.nbytes, 0)
        # no H2D happens on a discard: tell the ledger the staged bytes
        # left the host tier so its per-class gauges stay conserved
        obs.ledger().note_release(TC_KV_SPILL, ev.tag, ev.nbytes)

    def stats(self) -> dict:
        return {"n_spills": self.n_spills, "n_restores": self.n_restores,
                "n_discards": self.n_discards,
                "bytes_spilled": self.bytes_spilled,
                "bytes_restored": self.bytes_restored,
                "live_bytes": self.live_bytes,
                "hwm_live_bytes": self.hwm_live_bytes,
                "compression": self.compression,
                "bytes_raw": self.bytes_raw,
                "compression_ratio": (self.bytes_raw / self.bytes_spilled
                                      if self.bytes_spilled else 1.0),
                "advisor": (self.advisor.stats()
                            if self.advisor is not None else None)}
