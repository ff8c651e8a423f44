"""The trace reader: busy time as the union of device intervals, idle gaps
named by the innermost host operation, device time by kind."""
from __future__ import annotations

from types import SimpleNamespace

from torch.autograd import DeviceType

from portbench import devtrace


def _ev(name, start_us, end_us, dev, thread=1, kernels=(),
        annotation=False, id=0, linked=None):
    ev = SimpleNamespace(name=name, device_type=dev, thread=thread, id=id,
                         kernels=[SimpleNamespace(name=k, duration=d)
                                  for k, d in kernels],
                         is_user_annotation=annotation,
                         time_range=SimpleNamespace(start=start_us,
                                                    end=end_us))
    if linked is not None:
        ev.linked_correlation_id = linked
    return ev


def test_busy_gaps_and_kinds():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [_ev("nvjet_tst_128x128", 0, 100, cuda),
              _ev("vectorized_elementwise_kernel<add>", 50, 150, cuda),
              _ev("bwd_dkdv_bf16", 400, 500, cuda),
              _ev("flash_fwd_bf16", 500, 520, cuda),
              _ev("aten::matmul", 0, 1000, cpu),
              _ev("cudaStreamSynchronize", 200, 300, cpu)]
    out = devtrace.read(SimpleNamespace(events=lambda: events), 0.001)
    assert abs(out["busy_s"] - 270e-6) < 1e-12      # [0, 150) and [400, 520)
    gaps = out["breakdown"]["idle_gaps"]
    assert gaps[0][0] == "cudaStreamSynchronize"
    assert abs(gaps[0][1] - 250e-6) < 1e-12
    kinds = out["by_kind"]
    assert abs(kinds["gemm"] - 100e-6) < 1e-12
    assert abs(kinds["elementwise"] - 100e-6) < 1e-12
    assert abs(kinds["k1_bwd"] - 100e-6) < 1e-12
    assert abs(kinds["k1_fwd"] - 20e-6) < 1e-12
    assert abs(out["breakdown"]["device_ops"][0][1] - 100e-6) < 1e-12


def test_no_device_events_reads_nothing():
    out = devtrace.read(SimpleNamespace(events=lambda: []), 1.0)
    assert out["busy_s"] == 0.0


def test_apply_ranges_device_time():
    """The time inside the apply ranges in which a kernel ran: kernels on
    any stream merged, clipped to the ranges; copies and the range's own
    mark on the device left out."""
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    A = devtrace.APPLY
    events = [_ev("aten::mm", 0, 50, cpu),
              _ev(A, 100, 300, cpu), _ev(A, 400, 500, cpu),
              _ev("nvjet_tst", 0, 40, cuda),
              _ev("norm_kernel", 90, 110, cuda),             # 10 inside
              _ev("mul_kernel", 150, 180, cuda),
              _ev("copy_kernel", 170, 200, cuda),            # 150-200: 50
              _ev("Memcpy HtoD (Pageable -> Device)", 210, 260, cuda),
              _ev("add_kernel", 295, 309, cuda),             # 5 inside
              _ev("mul_kernel", 420, 430, cuda),             # 10
              _ev(A, 105, 295, cuda, annotation=True)]
    out = devtrace.read(SimpleNamespace(events=lambda: events), 0.001)
    assert abs(out["apply_s"] - 75e-6) < 1e-12
    assert A not in out["kernels"]
    assert abs(out["busy_s"] - 184e-6) < 1e-12   # copies are device work


def test_no_apply_range_reads_nothing():
    events = [_ev("aten::mm", 0, 50, DeviceType.CPU),
              _ev("nvjet_tst", 0, 40, DeviceType.CUDA)]
    out = devtrace.read(SimpleNamespace(events=lambda: events), 0.001)
    assert out["apply_s"] is None


def test_a_traced_run_at_small_sizes():
    """A whole traced run on the CPU: the apply ranges wrap the trainer's
    apply step for the traced steps only, and the readers that need a
    device's events read nothing."""
    from portbench.tests import tiny_cells
    out = tiny_cells.run("qwen2-7b.noswap_drift", trace=True)
    assert out["correct"], out["checks"]
    assert {"grad_ms_p50", "mfu"} <= set(out["metrics"])
    assert "adamw_roofline" not in out["metrics"]
    assert out["device"]["window_s"] > 0 and "breakdown" in out
