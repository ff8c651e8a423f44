"""The window's model flops (``yardstick.train_step_flops`` of each step,
no recomputation) over the bf16 peak times the window, in %."""
from portbench import yardstick


def read(rec):
    flops = sum(yardstick.train_step_flops(rec["cfg"], s["batch"], s["seq"])
                for s in rec["steps"])
    return 100.0 * flops / (yardstick.PEAK_BF16_FLOPS * rec["window_s"])
