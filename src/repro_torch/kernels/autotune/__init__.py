"""repro_torch.kernels.autotune — roofline-driven kernel autotuner.  Port of
``repro.kernels.autotune``.

Pieces:

  * :mod:`device` — :class:`DeviceSpec` roofline peaks by device kind
    (``h100_sxm``, ``cpu``) and :func:`device_kind` of the running device;
  * :mod:`space` — per-kernel launch-config search spaces (the CUDA
    kernels' own knobs) + bytes-moved accounting;
  * :mod:`tuner` — measures each variant's achieved fraction of the
    memory-bandwidth roofline, keeps the winner;
  * :mod:`cache` — schema-versioned atomic JSON persistence keyed by
    ``(kernel, shape-bucket, dtype, device_kind)``, stored alongside the
    BandwidthModel snapshot (warm restarts re-measure nothing);
  * :mod:`table` — the process-wide tuned-config table the kernel
    wrappers consult (:func:`install` / :func:`tuned_config`);
  * :mod:`advisor` — prices raw-vs-int8 spill compression with the
    tuned numbers (``spill_compression="auto"``).
"""
from __future__ import annotations

from repro_torch.kernels.autotune.advisor import CompressionAdvisor
from repro_torch.kernels.autotune.cache import (AutotuneCache, SCHEMA_VERSION,
                                                cache_key)
from repro_torch.kernels.autotune.device import (DEFAULT_DEVICE_KIND,
                                                 DEVICE_SPECS, DeviceSpec,
                                                 device_kind, get_device_spec)
from repro_torch.kernels.autotune.table import (clear, install,
                                                installed_count, shape_bucket,
                                                table_key, tuned_config)
from repro_torch.kernels.autotune.tuner import (HOST_LINK_KERNEL, Autotuner,
                                                default_measure)

__all__ = [
    "Autotuner", "AutotuneCache", "CompressionAdvisor", "DeviceSpec",
    "DEVICE_SPECS", "DEFAULT_DEVICE_KIND", "HOST_LINK_KERNEL",
    "SCHEMA_VERSION", "cache_key", "clear", "default_measure",
    "device_kind", "get_device_spec", "install", "install_cache",
    "installed_count", "shape_bucket", "table_key", "tuned_config",
]


def install_cache(cache: AutotuneCache) -> int:
    """Publish a cache's winners to the process-wide table consulted by
    the kernel wrappers; returns the number of installed configs."""
    entries = cache.table_entries()
    install(entries)
    return len(entries)
