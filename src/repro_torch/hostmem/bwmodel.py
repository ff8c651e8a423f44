"""Measured host-link bandwidth model (replaces the Eq. 3 constant): port
of ``repro/hostmem/bwmodel.py``.

The paper's simulator prices every transfer at ``T = S / B`` with one
scalar ``B`` (``ChameleonConfig.host_link_gbps``).  Real host links are
nothing like that: small copies are latency-bound (fixed setup cost
dominates), large copies approach asymptotic bandwidth, and the knee is
platform-specific.  This model measures the actual curve:

  * **calibration** runs a sweep of real H2D/D2H copies across sizes and
    records the median time per size — a piecewise curve in log-size;
  * **online observation** lets the transfer engine keep refreshing the
    curve with an EMA as production swaps retire;
  * :meth:`transfer_time` interpolates the curve log-log between measured
    points, extends latency-flat below the smallest point and
    bandwidth-flat above the largest;
  * with **zero samples** it degrades to exactly the old constant —
    ``nbytes / (host_link_gbps * 1e9)`` — so an uncalibrated system
    behaves byte-for-byte like the paper baseline.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.common.config import HOSTMEM_CALIBRATION_SIZES
from repro_torch.common.device import resolve_device

# default calibration sweep: 64 KiB .. 64 MiB (the candidate-size range —
# candidates below 64 KiB are filtered by §5.3's MIN_SWAP_BYTES anyway)
CALIBRATION_SIZES: Tuple[int, ...] = HOSTMEM_CALIBRATION_SIZES
EMA = 0.2                        # weight of a new online observation


class BandwidthModel:
    def __init__(self, constant_gbps: float = 32.0,
                 link_efficiency: float = 1.0):
        self.constant_gbps = constant_gbps
        # achieved-vs-peak host-link efficiency measured by the kernel
        # autotuner (kernels/autotune).  It scales ONLY the
        # uncalibrated constant fallback: the calibrated curve is already
        # a measurement, so applying it there would double-count.  1.0
        # reproduces the paper's nominal-link pricing byte-for-byte.
        self.link_efficiency = min(max(link_efficiency, 1e-3), 1.0)
        # log2-size bucket -> (representative size, ema seconds, n samples)
        self._buckets: Dict[int, Tuple[int, float, int]] = {}
        self._curve_cache: Optional[List[Tuple[int, float]]] = None
        # observe() runs on the training thread while the adaptation
        # worker prices variants concurrently — bucket
        # writes and curve reads take the same lock; transfer_time reads
        # an immutable curve list so interpolation runs unlocked
        self._lock = threading.Lock()

    # ---------------------------------------------------------- sampling
    def observe(self, nbytes: int, seconds: float) -> None:
        if nbytes <= 0 or seconds <= 0:
            return
        b = int(math.log2(nbytes))
        with self._lock:
            size, ema, n = self._buckets.get(b, (nbytes, seconds, 0))
            ema = seconds if n == 0 else (1 - EMA) * ema + EMA * seconds
            self._buckets[b] = (max(size, nbytes), ema, n + 1)
            self._curve_cache = None

    def calibrate(self, sizes: Sequence[int] = CALIBRATION_SIZES, *,
                  iters: int = 3, device=None,
                  roundtrip: Optional[Callable[[int], float]] = None
                  ) -> "BandwidthModel":
        """Run real round-trip copies and take the per-size median.

        The probe is a torch H2D copy of a pinned host buffer to ``device``
        (default ``cuda``) and its D2H readback, synchronised, timed on the
        host clock; ``roundtrip(size) -> seconds`` replaces it."""
        if roundtrip is None:
            dev = resolve_device(device)
            pinned = dev.type == "cuda"

            def roundtrip(size: int) -> float:
                host = torch.empty(size, dtype=torch.uint8, pin_memory=pinned)
                t0 = time.perf_counter()
                on_dev = host.to(dev)                       # H2D
                on_dev.to("cpu")                            # D2H readback
                if pinned:
                    torch.cuda.synchronize(dev)
                return time.perf_counter() - t0
        for size in sizes:
            ts = sorted(roundtrip(size) / 2                 # per direction
                        for _ in range(max(iters, 1)))
            self.observe(size, ts[len(ts) // 2])
        return self

    # ------------------------------------------------------------- query
    @property
    def is_calibrated(self) -> bool:
        return len(self._buckets) >= 2

    def _curve(self) -> List[Tuple[int, float]]:
        # the cached list is built under the lock and never mutated in
        # place, so readers may keep using a reference that a concurrent
        # observe() invalidated — they just see the previous curve
        curve = self._curve_cache
        if curve is None:
            with self._lock:
                curve = self._curve_cache = sorted(
                    (size, ema) for size, ema, _ in self._buckets.values())
        return curve

    def transfer_time(self, nbytes: int) -> float:
        """Seconds to move ``nbytes`` one way across the host link."""
        if nbytes <= 0:
            return 0.0
        if not self.is_calibrated:
            # Eq. 3 fallback, derated by the measured link efficiency
            return nbytes / (self.constant_gbps * 1e9 * self.link_efficiency)
        curve = self._curve()
        lo_s, lo_t = curve[0]
        hi_s, hi_t = curve[-1]
        if nbytes <= lo_s:
            return lo_t                    # latency floor below the sweep
        if nbytes >= hi_s:
            return hi_t * nbytes / hi_s    # asymptotic bandwidth above it
        for (s0, t0), (s1, t1) in zip(curve, curve[1:]):
            if s0 <= nbytes <= s1:
                f = ((math.log(nbytes) - math.log(s0))
                     / (math.log(s1) - math.log(s0)))
                return math.exp((1 - f) * math.log(t0) + f * math.log(t1))
        return nbytes / (self.constant_gbps * 1e9)          # unreachable

    def bandwidth_gbps(self, nbytes: int) -> float:
        t = self.transfer_time(nbytes)
        return nbytes / t / 1e9 if t > 0 else self.constant_gbps

    # ----------------------------------------------------- serialization
    def curve(self) -> List[Tuple[int, float, float]]:
        """[(size, seconds, effective GB/s)] — for reports and docs."""
        return [(s, t, s / t / 1e9) for s, t in self._curve()]

    def set_link_efficiency(self, eff: float) -> None:
        self.link_efficiency = min(max(float(eff), 1e-3), 1.0)

    def to_dict(self) -> dict:
        with self._lock:
            return {"constant_gbps": self.constant_gbps,
                    "link_efficiency": self.link_efficiency,
                    "samples": [(s, t, n)
                                for s, t, n in self._buckets.values()]}

    def snapshot(self) -> "BandwidthModel":
        """Immutable-by-convention copy for background adaptation: the
        worker prices every variant of one search
        against the same frozen curve instead of chasing the live EMA."""
        return BandwidthModel.from_dict(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "BandwidthModel":
        m = cls(d.get("constant_gbps", 32.0),
                link_efficiency=d.get("link_efficiency", 1.0))
        for s, t, n in d.get("samples", []):
            b = int(math.log2(s))
            m._buckets[b] = (int(s), float(t), int(n))
        m._curve_cache = None
        return m
