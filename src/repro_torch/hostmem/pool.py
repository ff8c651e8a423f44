"""Pinned-host slab pool: port of ``repro/hostmem/pool.py``.

Host staging buffers are grabbed once, bucketed into power-of-two size
classes, and recycled through per-class free lists, so steady-state swap
traffic performs no fresh allocation: every swap-out lands in a recycled
slab.  That matters on the card: pinning a 512 MiB slab with
``cudaHostAlloc`` takes far longer than the copy that fills it.

Slabs are ``torch.uint8`` tensors.  With ``pinned=True`` (the tier sets it
for a CUDA device) they come from ``torch.empty(n, dtype=torch.uint8,
pin_memory=True)``, page-locked memory that the copy engines reach by DMA;
with ``pinned=False`` (the CPU, which only the tests ask for) they are
plain tensors.  Only ``_raw_slab`` differs.

Accounting invariants (enforced, property-tested):
  * a byte is never double-booked — each slab is either on exactly one
    free list or owned by exactly one live block;
  * `free()` always returns the slab to its class free list;
  * `bytes_in_use + bytes_free == bytes_reserved`.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import torch

from repro_torch import faults

DEFAULT_MIN_CLASS = 1 << 12      # 4 KiB smallest slab class


class HostMemError(RuntimeError):
    """Pool misuse (double free / foreign block) or capacity exhaustion."""


def size_class(nbytes: int, min_class: int = DEFAULT_MIN_CLASS) -> int:
    """Round a request up to its power-of-two slab class."""
    c = min_class
    while c < nbytes:
        c <<= 1
    return c


def _raw_slab(class_bytes: int, pinned: bool) -> torch.Tensor:
    """One uint8 slab of ``class_bytes``, page-locked when ``pinned``."""
    return torch.empty(class_bytes, dtype=torch.uint8, pin_memory=pinned)


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """The bytes of a contiguous tensor as a flat uint8 view (no copy)."""
    if not t.is_contiguous():
        raise ValueError(f"byte view of a non-contiguous tensor "
                         f"{tuple(t.shape)} strides {t.stride()}")
    return t.reshape(-1).view(torch.uint8)


Payload = Union[torch.Tensor, Sequence[torch.Tensor]]


def payload_nbytes(src: Payload) -> int:
    """Bytes of one tensor, or of a sequence staged back to back."""
    chunks = [src] if isinstance(src, torch.Tensor) else list(src)
    return sum(c.numel() * c.element_size() for c in chunks)


@dataclass
class HostBlock:
    """A live reservation: ``data[:nbytes]`` is the caller's staging area."""
    bid: int
    nbytes: int                  # requested size
    class_bytes: int             # slab class actually reserved
    data: torch.Tensor = field(repr=False)
    tag: str = ""
    freed: bool = False
    # payload descriptor — set by write(); None until then so read() can
    # give a real diagnostic instead of a bare AttributeError
    shape: Optional[tuple] = None
    dtype: Optional[torch.dtype] = None

    def view(self) -> torch.Tensor:
        return self.data[: self.nbytes]

    def write(self, src: Payload, non_blocking: bool = False) -> "HostBlock":
        """Stage ``src`` into the slab.  A tensor keeps its shape and dtype
        as the payload descriptor; a sequence of contiguous tensors is
        staged back to back and described as flat bytes.  With
        ``non_blocking`` a copy from a CUDA tensor is only enqueued on the
        current stream: the caller synchronises before reading."""
        chunks = [src] if isinstance(src, torch.Tensor) else list(src)
        off = 0
        dst = self.view()
        for c in chunks:
            b = as_bytes(c.detach().contiguous())
            dst[off:off + b.numel()].copy_(b, non_blocking=non_blocking)
            off += b.numel()
        if off != self.nbytes:
            raise HostMemError(f"block {self.bid} ({self.tag!r}) holds "
                               f"{self.nbytes} bytes, payload has {off}")
        if isinstance(src, torch.Tensor):
            self.shape, self.dtype = tuple(src.shape), src.dtype
        else:
            self.shape, self.dtype = (off,), torch.uint8
        return self

    def typed(self) -> torch.Tensor:
        """The staged payload as a view of the slab, in its dtype and shape."""
        if self.shape is None or self.dtype is None:
            raise HostMemError(
                f"block {self.bid} ({self.tag!r}) read before write: "
                "no payload has been staged, shape/dtype unknown")
        return self.view().view(self.dtype).view(self.shape)

    def read(self) -> torch.Tensor:
        """Recover the staged tensor (a copy — the slab stays reusable)."""
        return self.typed().clone()


class PinnedSlabPool:
    """Slab/free-list allocator with size-class bucketing and reuse stats."""

    def __init__(self, capacity_bytes: Optional[int] = None,
                 min_class_bytes: int = DEFAULT_MIN_CLASS,
                 pinned: bool = False):
        self.capacity = capacity_bytes
        self.min_class = min_class_bytes
        self.pinned = pinned
        self._free: Dict[int, List[torch.Tensor]] = {}
        self._live: Dict[int, HostBlock] = {}
        self._ids = itertools.count()
        self._lock = threading.Lock()
        # ---- stats ----
        self.bytes_reserved = 0          # total slab bytes grabbed from host
        self.bytes_in_use = 0            # requested bytes of live blocks
        self.class_bytes_in_use = 0      # slab bytes of live blocks
        self.peak_reserved = 0
        self.peak_bytes_in_use = 0       # resident-bytes high-water mark
        self.bytes_alloc_total = 0       # cumulative requested bytes allocated
        self.bytes_freed_total = 0       # cumulative requested bytes freed
        self.alloc_count = 0
        self.reuse_hits = 0              # allocs served from a free list
        self.slab_allocs = 0             # allocs that created a fresh slab
        self.free_count = 0
        self._class_in_use: Dict[int, int] = {}   # per-class resident bytes
        self._class_peaks: Dict[int, int] = {}    # per-class resident HWM

    # ------------------------------------------------------------- alloc
    def alloc(self, nbytes: int, tag: str = "") -> HostBlock:
        if nbytes <= 0:
            raise HostMemError(f"invalid allocation size {nbytes}")
        if faults.inject("pool.alloc", key=tag) is not None:
            raise HostMemError(f"injected pinned-alloc failure ({tag!r})")
        cb = size_class(nbytes, self.min_class)
        with self._lock:
            self.alloc_count += 1
            bucket = self._free.get(cb)
            if bucket:
                slab = bucket.pop()
                self.reuse_hits += 1
            else:
                # host-memory pressure: recycled slabs still serve, but a
                # fresh reservation from the host allocator is denied
                if faults.inject("pool.pressure", key=tag) is not None:
                    raise HostMemError(
                        f"injected host-memory pressure: fresh {cb}-byte "
                        f"slab denied ({tag!r})")
                if (self.capacity is not None
                        and self.bytes_reserved + cb > self.capacity):
                    raise HostMemError(
                        f"host pool exhausted: {self.bytes_reserved + cb} "
                        f"> capacity {self.capacity}")
                slab = _raw_slab(cb, self.pinned)
                self.slab_allocs += 1
                self.bytes_reserved += cb
                self.peak_reserved = max(self.peak_reserved,
                                         self.bytes_reserved)
            blk = HostBlock(next(self._ids), nbytes, cb, slab, tag)
            self._live[blk.bid] = blk
            self.bytes_in_use += nbytes
            self.bytes_alloc_total += nbytes
            self.peak_bytes_in_use = max(self.peak_bytes_in_use,
                                         self.bytes_in_use)
            self.class_bytes_in_use += cb
            cu = self._class_in_use.get(cb, 0) + cb
            self._class_in_use[cb] = cu
            if cu > self._class_peaks.get(cb, 0):
                self._class_peaks[cb] = cu
        return blk

    def free(self, blk: HostBlock) -> None:
        with self._lock:
            if blk.freed or blk.bid not in self._live:
                raise HostMemError(f"double free / foreign block {blk.bid}")
            del self._live[blk.bid]
            blk.freed = True
            self.bytes_in_use -= blk.nbytes
            self.bytes_freed_total += blk.nbytes
            self.class_bytes_in_use -= blk.class_bytes
            self._class_in_use[blk.class_bytes] -= blk.class_bytes
            self._free.setdefault(blk.class_bytes, []).append(blk.data)
            self.free_count += 1

    # ------------------------------------------------------------- stats
    @property
    def bytes_free(self) -> int:
        return sum(cb * len(v) for cb, v in self._free.items())

    @property
    def hit_rate(self) -> float:
        """Fraction of allocs served without touching the host allocator."""
        return self.reuse_hits / self.alloc_count if self.alloc_count else 0.0

    @property
    def fragmentation(self) -> float:
        """Internal fragmentation of live blocks: wasted / reserved-live."""
        if not self.class_bytes_in_use:
            return 0.0
        return 1.0 - self.bytes_in_use / self.class_bytes_in_use

    @property
    def live_blocks(self) -> int:
        return len(self._live)

    def stats(self) -> dict:
        return {
            "bytes_reserved": self.bytes_reserved,
            "bytes_in_use": self.bytes_in_use,
            "bytes_free": self.bytes_free,
            "peak_reserved": self.peak_reserved,
            "peak_bytes_in_use": self.peak_bytes_in_use,
            "bytes_alloc_total": self.bytes_alloc_total,
            "bytes_freed_total": self.bytes_freed_total,
            "class_peaks": dict(self._class_peaks),
            "live_blocks": self.live_blocks,
            "alloc_count": self.alloc_count,
            "reuse_hits": self.reuse_hits,
            "slab_allocs": self.slab_allocs,
            "free_count": self.free_count,
            "hit_rate": self.hit_rate,
            "fragmentation": self.fragmentation,
        }

    def check(self) -> None:
        """Book-keeping invariant — used by tests and the benchmark."""
        assert self.bytes_in_use == sum(b.nbytes for b in self._live.values())
        assert (self.class_bytes_in_use + self.bytes_free
                == self.bytes_reserved), "slab bytes leaked"
        # byte conservation: every requested byte is either still resident
        # or has been explicitly freed
        assert (self.bytes_alloc_total - self.bytes_freed_total
                == self.bytes_in_use), "alloc/free byte ledger imbalance"
        assert self.class_bytes_in_use == sum(
            v for v in self._class_in_use.values()), "class ledger imbalance"
