"""repro_torch.hostmem — the host-memory tier.  Port of ``repro.hostmem``.

One shared substrate under both branches of the system:

  * **training** (§5.4 policy execution, ``core.executor``): the simulator
    prices swaps with the measured :class:`BandwidthModel`, the policy's
    free-times hand off to the :class:`TransferEngine`'s swap-out
    completion events, and every staged tensor recycles through the
    :class:`PinnedSlabPool`;
  * **serving**: :class:`KVSpillManager` parks idle decode slots in the
    same pool so admission exceeds device-resident slots.

``HostMemTier`` bundles the four components with consistent wiring on one
device: ``cuda`` unless the caller asks for the CPU (pinned slabs and one
CUDA stream pair per traffic class on the card; plain slabs and
synchronous copies on the CPU).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.common.config import ChameleonConfig, HostMemConfig
from repro_torch.common.device import resolve_device
from repro_torch.hostmem import metrics as _metrics
from repro_torch.hostmem.bwmodel import BandwidthModel
from repro_torch.hostmem.engine import (SWAP_IN, SWAP_OUT, TC_CHECKPOINT,
                                        TC_KV_SPILL, TC_POLICY_SWAP,
                                        TRAFFIC_CLASSES, TransferEngine,
                                        TransferEvent)
from repro_torch.hostmem.kvspill import KVSpillManager, SpilledSlot
from repro_torch.hostmem.pool import HostBlock, HostMemError, PinnedSlabPool

__all__ = [
    "BandwidthModel", "HostBlock", "HostMemConfig", "HostMemError",
    "HostMemTier", "KVSpillManager", "PinnedSlabPool", "SpilledSlot",
    "TC_CHECKPOINT", "TC_KV_SPILL", "TC_POLICY_SWAP", "TRAFFIC_CLASSES",
    "TransferEngine", "TransferEvent",
]

class HostMemTier:
    """Pool + engine + bandwidth model + kv-spill, wired together."""

    def __init__(self, cfg: Optional[HostMemConfig] = None, *,
                 constant_gbps: float = 32.0, resilience=None,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg or HostMemConfig()
        self.device = resolve_device(device)
        self.pool = PinnedSlabPool(
            capacity_bytes=self.cfg.pool_bytes or None,
            min_class_bytes=self.cfg.min_class_bytes,
            pinned=self.device.type == "cuda")
        self.bwmodel = BandwidthModel(constant_gbps)
        self.engine = TransferEngine(self.pool, depth=self.cfg.engine_depth,
                                     bwmodel=self.bwmodel,
                                     class_depths=dict(self.cfg.class_depths),
                                     resilience=resilience,
                                     device=self.device)
        self.autotuner = None        # set by autotune()
        advisor = None
        if self.cfg.spill_compression == "auto":
            from repro_torch.kernels.autotune.advisor import \
                CompressionAdvisor
            advisor = CompressionAdvisor(bwmodel=self.bwmodel)
        self.kvspill = KVSpillManager(
            self.pool, self.engine,
            compression=self.cfg.spill_compression,
            compress_min_bytes=self.cfg.spill_compress_min_bytes,
            advisor=advisor)
        # size -> (D2H seconds, H2D seconds), minima of the last calibrate()
        self.link_curve: Dict[int, Tuple[float, float]] = {}
        if self.cfg.calibrate:
            self.calibrate()

    @classmethod
    def from_chameleon(cls, ccfg: ChameleonConfig, *,
                       device: Union[str, torch.device, None] = None
                       ) -> Optional["HostMemTier"]:
        """Build the tier a ChameleonConfig asks for (None when disabled)."""
        if not ccfg.hostmem.enabled:
            return None
        tier = cls(ccfg.hostmem, constant_gbps=ccfg.host_link_gbps,
                   resilience=ccfg.resilience, device=device)
        if ccfg.autotune.enabled:
            tier.autotune(ccfg.autotune)
        return tier

    def autotune(self, atcfg=None, *, device_kind=None):
        """Tune the kernels ``atcfg.kernels`` names against the roofline on
        the tier's device and wire the results into pricing
        (``repro_torch.kernels.autotune``).

        Loads the cache (warm restart = zero re-measurement), measures
        any missing kernels, installs winners into the process-wide tuned
        table the kernel wrappers consult, derates the bandwidth model's
        uncalibrated fallback by the measured link efficiency, points the
        kv-spill compression advisor at the tuned rates, and persists
        cache + bandwidth snapshot atomically.  The device kind is
        ``device_kind``, else ``atcfg.device_kind``, else the tier's own
        device's.  Returns the
        :class:`~repro_torch.kernels.autotune.tuner.Autotuner`."""
        from repro_torch.common.config import AutotuneConfig
        from repro_torch.kernels.autotune import (Autotuner, AutotuneCache,
                                                  get_device_spec,
                                                  install_cache)
        from repro_torch.kernels.autotune.device import device_kind as kind_of
        atcfg = atcfg or AutotuneConfig(enabled=True)
        kind = device_kind or atcfg.device_kind or kind_of(self.device)
        cache = (AutotuneCache.load(atcfg.cache_dir, device_kind=kind)
                 if atcfg.cache_dir else AutotuneCache(device_kind=kind))
        tuner = Autotuner(cache=cache, spec=get_device_spec(kind),
                          iters=atcfg.iters, device=self.device)
        tuner.tune_all(atcfg.kernels)
        eff = tuner.link_efficiency(self.bwmodel)
        self.bwmodel.set_link_efficiency(eff)
        cache.bwmodel = self.bwmodel.to_dict()
        if atcfg.cache_dir:
            cache.save()
        install_cache(cache)
        if self.kvspill.advisor is not None:
            self.kvspill.advisor.cache = cache
        self.autotuner = tuner
        return tuner

    def calibrate(self, sizes=None, iters=None) -> BandwidthModel:
        """Calibration transfers through the *production* path: each size
        does real swap-out/swap-in round trips via the engine, so the curve
        prices exactly the copies the tier will later run.  The engine's
        per-copy EMA feed is bypassed during the sweep: the per-size
        *minima* of warm runs go into the curve (the first round trip per
        size pays slab pinning and stream creation), and each direction's
        minimum is kept in ``link_curve``."""
        sizes = sizes if sizes is not None else self.cfg.calibration_sizes
        iters = iters if iters is not None else self.cfg.calibration_iters
        eng = self.engine
        saved, eng.bwmodel = eng.bwmodel, None
        try:
            warm = torch.zeros(1024, dtype=torch.uint8, device=self.device)
            eng.wait(eng.submit_swap_in(
                eng.wait(eng.submit_swap_out(warm, "warm")), "warm"))
            for size in sizes:
                arr = torch.zeros(size, dtype=torch.uint8, device=self.device)
                outs, ins = [], []
                for i in range(max(iters, 1) + 1):
                    ev = eng.wait(eng.submit_swap_out(arr, "calib"))
                    ev2 = eng.wait(eng.submit_swap_in(ev, "calib"))
                    if i:                        # drop the cold run
                        outs.append(ev.seconds)
                        ins.append(ev2.seconds)
                self.link_curve[int(size)] = (min(outs), min(ins))
                self.bwmodel.observe(size, (min(outs) + min(ins)) / 2)
        finally:
            eng.bwmodel = saved
        # each direction's own curve prices the engine's contention signals
        eng.link_models = {d: BandwidthModel(self.bwmodel.constant_gbps)
                           for d in (SWAP_OUT, SWAP_IN)}
        for size, (d2h, h2d) in self.link_curve.items():
            eng.link_models[SWAP_OUT].observe(size, d2h)
            eng.link_models[SWAP_IN].observe(size, h2d)
        return self.bwmodel

    def stats(self) -> dict:
        return _metrics.collect(self)

    def summary(self) -> str:
        return _metrics.format_summary(self.stats())
