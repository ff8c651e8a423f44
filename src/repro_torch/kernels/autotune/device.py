"""Device roofline specs (one source of truth).  Port of
``repro/kernels/autotune/device.py``.

The autotuner judges each kernel's achieved bytes/s against one
:class:`DeviceSpec` selected by device kind, and derates the host link by
the measured fraction of the spec's ``host_bw``.  The registry holds the
port's card and the CPU, and no TPU figure: the H100's peaks are the
constants ``ChameleonConfig`` reads (``common/config.py``), so the planner
and the tuner price against the same numbers.  Unknown kinds fall back to
the default spec's numbers under the asked-for name, as in the reference:
an autotune cache records which kind it was measured on, so a mismatched
spec is visible, never silent.

New in the port: :func:`device_kind` names the running device's kind, so
``AutotuneConfig.device_kind = ""`` tunes for the device the tier runs on.
"""
from __future__ import annotations

import re
from dataclasses import asdict, dataclass
from typing import Dict, Optional, Union

import torch

from repro_torch.common.config import (H100_HBM_BYTES_S, H100_PEAK_FLOPS,
                                       HOST_LINK_GBPS)


@dataclass(frozen=True)
class DeviceSpec:
    """Peak rates used as roofline denominators (bytes/s, FLOP/s)."""
    kind: str
    peak_flops: float            # bf16 matmul peak
    hbm_bw: float                # device memory bytes/s
    ici_bw: float                # per-direction card-to-card bytes/s
    host_bw: float               # host<->device link bytes/s

    def to_dict(self) -> dict:
        return asdict(self)


DEFAULT_DEVICE_KIND = "h100_sxm"

# host_bw IS the Eq-3 constant (ChameleonConfig.host_link_gbps), as in the
# reference.  On the H100 that constant was itself measured on the card, so
# a link measured at it gives an efficiency of 1 and the Eq-3 bandwidth
# stays where it is; a nominal PCIe figure here would derate a measured
# rate a second time.
DEVICE_SPECS: Dict[str, DeviceSpec] = {
    # NVLink 4 on the H100 SXM data sheet: 900 GB/s to the other cards of
    # the host, both directions together, so 450 GB/s each way
    "h100_sxm": DeviceSpec("h100_sxm", H100_PEAK_FLOPS, H100_HBM_BYTES_S,
                           450e9, HOST_LINK_GBPS * 1e9),
    # CPU runs of the plain versions: nominal peaks (one memory channel
    # class); efficiencies measured against them are small and honest
    "cpu": DeviceSpec("cpu", 1e12, 50e9, 10e9, HOST_LINK_GBPS * 1e9),
}


def get_device_spec(kind: Optional[str] = None) -> DeviceSpec:
    """Spec for ``kind`` (default: the port's card).  Unknown kinds fall
    back to the default spec's numbers under the asked-for name so cache
    keys still record what the caller believed it had."""
    if not kind:
        return DEVICE_SPECS[DEFAULT_DEVICE_KIND]
    spec = DEVICE_SPECS.get(kind)
    if spec is None:
        base = DEVICE_SPECS[DEFAULT_DEVICE_KIND]
        return DeviceSpec(kind, base.peak_flops, base.hbm_bw,
                          base.ici_bw, base.host_bw)
    return spec


def device_kind(device: Union[str, torch.device]) -> str:
    """Registry kind of ``device``: ``cpu`` for the CPU, ``h100_sxm`` for a
    CUDA card whose name contains "H100", else the card's name in lower
    case with runs of other characters as ``_`` (an unknown kind)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"no device kind for {dev}")
    name = torch.cuda.get_device_name(dev)
    if "H100" in name:
        return "h100_sxm"
    return re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")
