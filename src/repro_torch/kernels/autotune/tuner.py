"""Roofline-driven launch-config autotuner for the port's kernels.  Port
of ``repro/kernels/autotune/tuner.py``.

For each ``(kernel, shape-bucket, dtype)`` the tuner measures every
variant in the kernel's :class:`~repro_torch.kernels.autotune.space.
KernelSpace` and keeps the one with the highest achieved bytes/s; the
entry records the achieved fraction of the device's memory-bandwidth
roofline (``achieved_bps / DeviceSpec.hbm_bw``).  That fraction is a bytes
roofline for every kernel, K1 and K4 included, whose own bounds on the
card are set by their operations.  Results land in the
:class:`~repro_torch.kernels.autotune.cache.AutotuneCache`, so a warm
cache answers every later ``tune`` call with **zero** re-measurement
(``n_measured`` / ``n_cache_hits`` make that a testable counter).

The measurement backend is a plain callable ``measure(fn) -> seconds``.
:func:`default_measure` times the device on a card (CUDA events around a
CUDA graph of the calls, so the host's dispatch is not in the time) and
the host clock around the plain version on the CPU.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Union

import torch

from repro_torch import obs
from repro_torch.common.device import resolve_device
from repro_torch.kernels.autotune.cache import AutotuneCache
from repro_torch.kernels.autotune.device import (DeviceSpec, device_kind,
                                                 get_device_spec)
from repro_torch.kernels.autotune.space import SPACES

HOST_LINK_KERNEL = "host_link"       # pseudo-kernel: measured link efficiency
GRAPH_CALLS = 20                     # calls captured in one timed CUDA graph


def default_measure(fn: Callable[[], object], iters: int = 3,
                    device: Union[str, torch.device, None] = None) -> float:
    """Seconds per call of ``fn``, the minimum over ``iters`` timings after
    a warm-up call (min is the low-noise estimator for kernel and copy
    cost, as ``HostMemTier.calibrate`` uses it).

    On a CUDA device: GRAPH_CALLS calls captured in one CUDA graph,
    replayed once untimed and then between CUDA events, so each timed
    replay was queued while the device was still busy and the time is the
    device's, not the host's dispatch (a ctypes launch costs more host
    time than K2a's ~2 us at its default shape).  Each call reuses the
    same inputs, and the default shapes fit in the card's 50 MB L2: the
    rates are warm rates.  On the CPU: the host clock around one call."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        fn()                                       # warm-up
        best = float("inf")
        for _ in range(max(iters, 1)):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()                                   # warm-up: build, load
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(GRAPH_CALLS):
                fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        best = float("inf")
        for _ in range(max(iters, 1)):
            graph.replay()                         # keeps the device busy
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / GRAPH_CALLS)
        del graph
        return best


class Autotuner:
    def __init__(self, cache: Optional[AutotuneCache] = None,
                 spec: Optional[DeviceSpec] = None, *, iters: int = 3,
                 measure: Optional[Callable] = None,
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        self.spec = spec or get_device_spec(device_kind(self.device))
        self.cache = cache if cache is not None else AutotuneCache(
            device_kind=self.spec.kind)
        self.iters = iters
        self._measure = measure or (
            lambda fn: default_measure(fn, self.iters, self.device))
        self.n_measured = 0          # variant measurements actually run
        self.n_cache_hits = 0        # tune() calls answered from the cache

    # ------------------------------------------------------------- tuning
    def tune(self, kernel: str, shape: Optional[Sequence[int]] = None,
             dtype=torch.float32) -> dict:
        """Winning config for ``(kernel, shape, dtype)`` — cached, or
        measured across the kernel's whole variant space for ``dtype``."""
        space = SPACES[kernel]
        shape = tuple(shape or space.default_shape)
        hit = self.cache.get(kernel, shape, dtype)
        if hit is not None:
            self.n_cache_hits += 1
            return dict(hit["config"])
        args = space.make_args(shape, dtype, self.device)
        nbytes = space.bytes_moved(shape, dtype)
        best = None
        for config in space.variants_for(dtype):
            seconds = self._measure(lambda: space.run(args, config))
            self.n_measured += 1
            achieved = nbytes / seconds if seconds > 0 else 0.0
            if best is None or achieved > best["achieved_bps"]:
                best = {"config": dict(config), "achieved_bps": achieved,
                        "measured_s": seconds}
        best["bytes_moved"] = nbytes
        best["efficiency"] = min(best["achieved_bps"] / self.spec.hbm_bw,
                                 1.0)
        best["shape"] = list(shape)
        key = self.cache.put(kernel, shape, dtype, best)
        obs.audit().event("autotune.tuned", kernel=kernel, key=key,
                          config=best["config"],
                          efficiency=round(best["efficiency"], 6),
                          achieved_gbps=round(best["achieved_bps"] / 1e9,
                                              4))
        obs.metrics().gauge(f"kernel.efficiency.{kernel}",
                            best["efficiency"])
        return dict(best["config"])

    def tune_all(self, kernels: Optional[Sequence[str]] = None,
                 dtype=torch.float32) -> dict:
        """Tune each named kernel at its default shape; returns
        kernel -> winning config."""
        out = {}
        for k in (kernels or tuple(SPACES)):
            out[k] = self.tune(k, dtype=dtype)
        return out

    # ------------------------------------------------ host-link efficiency
    def link_efficiency(self, bwmodel) -> float:
        """Measured asymptotic link bandwidth as a fraction of the spec's
        host-link peak.  Calibrated model: read the top of its curve
        (one cached entry — zero extra copies).  Uncalibrated: reuse a
        warm cache's stored value; otherwise 1.0 (the Eq-3 constant, so
        untuned pricing is unchanged)."""
        stored = self.cache.entries.get(
            f"{HOST_LINK_KERNEL}|-|-|{self.cache.device_kind}")
        if bwmodel is None or not bwmodel.is_calibrated:
            if stored is not None:
                self.n_cache_hits += 1
                return float(stored["config"]["efficiency"])
            return 1.0
        curve = bwmodel.curve()
        size, _, gbps = curve[-1]          # asymptotic point of the sweep
        eff = min(max(gbps * 1e9 / self.spec.host_bw, 1e-3), 1.0)
        self.cache.entries[
            f"{HOST_LINK_KERNEL}|-|-|{self.cache.device_kind}"] = {
            "config": {"efficiency": eff},
            "achieved_bps": gbps * 1e9, "bytes_moved": int(size),
            "efficiency": eff, "shape": [int(size)]}
        obs.audit().event("autotune.link_efficiency",
                          efficiency=round(eff, 6),
                          achieved_gbps=round(gbps, 3),
                          peak_gbps=self.spec.host_bw / 1e9)
        obs.metrics().gauge("kernel.efficiency.host_link", eff)
        return eff

    def stats(self) -> dict:
        return {"n_measured": self.n_measured,
                "n_cache_hits": self.n_cache_hits,
                "device_kind": self.spec.kind,
                "cache": self.cache.stats()}
