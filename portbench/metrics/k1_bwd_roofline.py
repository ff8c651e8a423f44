"""K1 backward's operations bound over its device time in the traced
steps, in %: ``yardstick.k1_bwd_flops`` of each traced step at the bf16
peak, over the device time of the kernels ``bwd_delta``, ``bwd_dkdv_*``
and ``bwd_dq_*``."""
from portbench import yardstick

NAMES = ("bwd_delta", "bwd_dkdv", "bwd_dq")


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    t = sum(s for n, s in tr["kernels"].items()
            if any(k in n for k in NAMES))
    if t <= 0:
        return None
    flops = sum(yardstick.k1_bwd_flops(rec["cfg"], s["batch"], s["seq"])
                for s in tr["steps"])
    return 100.0 * flops / yardstick.PEAK_BF16_FLOPS / t
