"""Priced raw-vs-int8 spill compression (``spill_compression="auto"``).
Port of ``repro/kernels/autotune/advisor.py``.

The static ``"int8"`` mode compresses every big-enough float row; this
advisor instead *prices* the two options with tuned numbers and picks
the cheaper one per row:

  raw   = transfer_time(row_bytes)
  int8  = quantize_time + transfer_time(payload + scales) + dequant_time

Transfer times come from the live
:class:`~repro_torch.hostmem.bwmodel.BandwidthModel` (measured curve, or the
efficiency-scaled constant).  Kernel times come from the autotune
cache's achieved bytes/s for the ``quantize``/``dequantize`` kernels (K2a,
K2b) — the roofline measurements taken by the
:class:`~repro_torch.kernels.autotune.tuner.Autotuner`.  With no tuned entry
the kernel cost is treated as free, which reduces to the static int8
rule (compression wins whenever the link saving is positive) — so an
untuned ``auto`` is never worse than ``"int8"`` was.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch import obs
from repro_torch.common.config import HOST_LINK_GBPS
from repro_torch.kernels.autotune.cache import AutotuneCache

COMPRESS_RAW = "raw"
COMPRESS_INT8 = "int8"


class CompressionAdvisor:
    def __init__(self, bwmodel=None, cache: Optional[AutotuneCache] = None,
                 fallback_gbps: float = HOST_LINK_GBPS):
        self.bwmodel = bwmodel
        self.cache = cache
        self.fallback_gbps = fallback_gbps
        self.n_int8 = 0
        self.n_raw = 0

    # ------------------------------------------------------------ pricing
    def _transfer_s(self, nbytes: int) -> float:
        if self.bwmodel is not None:
            return self.bwmodel.transfer_time(nbytes)
        return nbytes / (self.fallback_gbps * 1e9)

    def _achieved_bps(self, kernel: str) -> Optional[float]:
        """Tuned achieved bytes/s for ``kernel``: the best over its
        buckets and dtypes (launch geometry, not exact size, is what was
        tuned)."""
        if self.cache is None:
            return None
        best = None
        for key, e in self.cache.entries.items():
            if key.startswith(kernel + "|") and e.get("achieved_bps"):
                bps = float(e["achieved_bps"])
                best = bps if best is None else max(best, bps)
        return best

    def _kernel_s(self, kernel: str, kernel_bytes: int) -> float:
        bps = self._achieved_bps(kernel)
        return kernel_bytes / bps if bps else 0.0

    def decide(self, row_nbytes: int, itemsize: int, rows: int,
               cls: str = "kv_spill", tag: str = "") -> Tuple[str, dict]:
        """Pick ``"raw"`` or ``"int8"`` for one row; the decision and
        both priced costs go to the audit log."""
        elems = row_nbytes // max(itemsize, 1)
        payload = elems + rows * 4               # int8 bytes + f32 scales
        raw_s = self._transfer_s(row_nbytes)
        # kernel byte accounting mirrors space.py: quantize reads the row
        # and writes payload+scales; dequantize does the mirror image
        q_s = self._kernel_s("quantize", row_nbytes + payload)
        dq_s = self._kernel_s("dequantize", payload + row_nbytes)
        int8_s = q_s + dq_s + self._transfer_s(payload)
        choice = COMPRESS_INT8 if int8_s < raw_s else COMPRESS_RAW
        if choice == COMPRESS_INT8:
            self.n_int8 += 1
        else:
            self.n_raw += 1
        detail = {"raw_s": raw_s, "int8_s": int8_s,
                  "quant_s": q_s + dq_s, "row_nbytes": row_nbytes,
                  "payload_nbytes": payload}
        obs.audit().event("kvspill.compression_choice", cls=cls,
                          tag=tag[:48], choice=choice,
                          raw_us=round(raw_s * 1e6, 3),
                          int8_us=round(int8_s * 1e6, 3),
                          row_nbytes=row_nbytes)
        return choice, detail

    def stats(self) -> dict:
        return {"n_int8": self.n_int8, "n_raw": self.n_raw}
