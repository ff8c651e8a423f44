"""The readers of the program's own spans and counters: ``host_gap_ms``,
``adamw_update_roofline``, ``recorder_ms`` and ``obs_close_ms``.  Each
reads nothing from a run with Chameleon off or from a program without its
span or counter, and a traced run of the small swap cell reports all
four."""
from __future__ import annotations

import pytest

from portbench import harness, yardstick
from portbench.tests import tiny_cells

NEW = ("host_gap_ms", "adamw_update_roofline", "recorder_ms",
       "obs_close_ms")


def _stats(device_s=None, device_n=None, **counters):
    tracer = {"n_spans": 0}
    if device_s is not None:
        tracer.update(device_s=device_s, device_n=device_n)
    return {"profiling_overhead_s": 0.0, "obs": {"tracer": tracer},
            **counters}


def _rec(runtime, n=4, wall=0.5):
    return {"cfg": harness.cell_files("qwen2-7b.swap_drift")[1],
            "runtime": runtime,
            "steps": [{"wall_s": wall, "skipped": False}] * n}


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read(name):
    """Chameleon off (no runtime stats), and a program that has not the
    span or the counter (the stats as they were before them)."""
    read = harness.reader(name)
    assert read(_rec(None)) is None
    assert read(_rec({"before": _stats(), "after": _stats()})) is None


def test_the_readings():
    before = _stats({"compute.fwd": 1.0, "compute.adamw_update": 2.0,
                     "policy_swap.swap_out": 5.0},
                    {"compute.fwd": 3, "compute.adamw_update": 3},
                    recorder_s=1.0, obs_close_s=0.5)
    after = _stats({"compute.fwd": 2.0, "compute.adamw_update": 2.8,
                    "compute.eval": 0.2, "policy_swap.swap_out": 9.0},
                   {"compute.fwd": 7, "compute.adamw_update": 7,
                    "compute.eval": 1},
                   recorder_s=1.02, obs_close_s=0.504)
    rec = _rec({"before": before, "after": after})
    # the copies' lanes are no dispatch: 4 x 0.5 s less 2.0 s of compute
    assert harness.reader("host_gap_ms")(rec) == pytest.approx(0.0)
    bound = yardstick.adamw_bytes(rec["cfg"]) / yardstick.PEAK_HBM_BYTES_S
    assert harness.reader("adamw_update_roofline")(rec) == pytest.approx(
        100.0 * 4 * bound / 0.8)
    assert harness.reader("recorder_ms")(rec) == pytest.approx(5.0)
    assert harness.reader("obs_close_ms")(rec) == pytest.approx(1.0)


def test_a_traced_swap_run_reports_them():
    out = tiny_cells.run("qwen2-7b.swap_drift", trace=True)
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW) <= set(got)
    assert got["recorder_ms"] + got["obs_close_ms"] <= got["monitor_ms"]
    assert got["host_gap_ms"] > 0.0
    assert 0.0 < got["adamw_update_roofline"] < 100.0
