"""The tracer's device clock, its records' parents and its ranges in the
profiler's trace (``repro_torch.obs.tracer``), the op stream that no
profiler range may enter (``core.tokenizer``), the trainer's dispatch
phases and iteration stamps, and the Chrome export's device process
through the validator and the report.  The device events are fakes whose
``elapsed_time`` is scripted."""
import contextlib
import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch.configs as PC
from repro_torch import obs
from repro_torch.common.config import ChameleonConfig, TrainConfig
from repro_torch.core import executor as pexec
from repro_torch.core.profiler import profile_step
from repro_torch.core.tokenizer import OpStreamRecorder
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.obs import report
from repro_torch.obs.tracer import SpanTracer
from repro_torch.runtime.trainer import Trainer


class FakeEvent:
    """A timing event at device time ``t`` (seconds)."""

    def __init__(self, t: float, done: bool = True):
        self.t, self.done = t, done

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, other) -> float:
        assert self.done and other.done, "elapsed_time of an open event"
        return (other.t - self.t) * 1e3


def _device(tr):
    return [r for r in tr.records() if r["kind"] == "device"]


@pytest.fixture
def tracer():
    old = obs.set_tracer(SpanTracer(capacity=1024))
    try:
        yield obs.tracer()
    finally:
        obs.set_tracer(old)


# ------------------------------------------------------------ the clock
def test_anchor_maps_device_time_onto_the_host_clock(tracer):
    tracer.set_anchor(FakeEvent(50.0), 1000.0)
    tracer.record_device(obs.LANE_COMPUTE, "fwd", FakeEvent(50.25),
                         FakeEvent(50.5), arg=7)
    assert _device(tracer) == []                   # queued until resolved
    assert tracer.resolve() == 0
    (r,) = _device(tracer)
    assert r["name"] == "fwd" and r["arg"] == 7
    assert r["t0"] == pytest.approx(1000.25) and r["t1"] == pytest.approx(
        1000.5)
    assert tracer.device_time(FakeEvent(51.0)) == pytest.approx(1001.0)
    st = tracer.stats()
    assert st["device_s"] == {"compute.fwd": pytest.approx(0.25)}
    assert st["device_n"] == {"compute.fwd": 1} and st["pending"] == 0


def test_resolution_waits_for_the_events_and_never_blocks(tracer):
    tracer.set_anchor(FakeEvent(0.0), 10.0)
    end = FakeEvent(2.0, done=False)
    tracer.record_device(obs.LANE_POLICY_SWAP, "swap_out", FakeEvent(1.0),
                         end)
    assert tracer.resolve() == 1 and _device(tracer) == []
    end.done = True
    assert tracer.resolve() == 0
    (r,) = _device(tracer)
    assert (r["t0"], r["t1"]) == (pytest.approx(11.0), pytest.approx(12.0))


def test_a_record_keeps_its_anchor_across_a_step_boundary(tracer):
    """A record queued in one step and resolved after the next step's
    anchor maps through the anchor current at its call."""
    tracer.set_anchor(FakeEvent(0.0), 100.0)
    tracer.set_iteration(3)
    tracer.record_device(obs.LANE_COMPUTE, "bwd", FakeEvent(0.5),
                         FakeEvent(0.75))
    tracer.set_anchor(FakeEvent(10.0), 250.0)      # the clocks drifted
    tracer.set_iteration(4)
    tracer.record_device(obs.LANE_COMPUTE, "bwd", FakeEvent(10.5),
                         FakeEvent(10.75))
    tracer.resolve()
    a, b = _device(tracer)
    assert (a["t0"], a["iter"]) == (pytest.approx(100.5), 3)
    assert (b["t0"], b["iter"]) == (pytest.approx(250.5), 4)


def test_host_marks_and_no_anchor(tracer):
    """On the CPU a device record is the host interval, recorded at once;
    with events and no anchor it cannot be placed and is dropped."""
    cpu = torch.device("cpu")
    a = tracer.mark(cpu)
    b = tracer.anchor(cpu)
    assert isinstance(a, float) and isinstance(b, float)
    assert not tracer.anchored
    tracer.record_device(obs.LANE_COMPUTE, "eval", a, b)
    tracer.record_device(obs.LANE_COMPUTE, "eval", FakeEvent(0.0),
                         FakeEvent(1.0))
    assert tracer.resolve() == 0
    (r,) = _device(tracer)
    assert (r["t0"], r["t1"]) == (a, b)
    assert obs.mark_seconds(a, b) == b - a
    assert obs.mark_seconds(FakeEvent(1.0), FakeEvent(1.5)) == 500.0 / 1e3


def test_parents_are_the_innermost_open_span_of_the_thread(tracer):
    seen = {}

    def other():
        tracer.record(obs.LANE_ADAPT, "worker", 0.0, 1.0)

    with tracer.span(obs.LANE_TRAINER, "step"):
        with tracer.span(obs.LANE_COMPUTE, "train_step"):
            tracer.record_device(obs.LANE_COMPUTE, "fwd", 1.0, 2.0)
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        tracer.instant(obs.LANE_ADAPT, "stage:Stable")
    for r in tracer.records():
        seen[r["name"]] = r["parent"]
    assert seen == {"fwd": "train_step", "worker": None,
                    "train_step": "step", "stage:Stable": "step",
                    "step": None}


def test_device_totals_and_window_efficiency_by_kind(tracer):
    """The overlap efficiency reads the spans, or with ``device`` the
    device records, of the compute and transfer lanes: one arithmetic."""
    tracer.record(obs.LANE_COMPUTE, "train_step", 0.0, 10.0)
    tracer.record(obs.LANE_POLICY_SWAP, "swap_out", 8.0, 12.0)
    tracer.record_device(obs.LANE_COMPUTE, "fwd", 0.0, 4.0)
    tracer.record_device(obs.LANE_POLICY_SWAP, "swap_out", 2.0, 6.0)
    tracer.record_device(obs.LANE_POLICY_SWAP, "swap_in", 6.0, 8.0)
    assert obs.window_efficiency(tracer, 0.0, 20.0) == (
        pytest.approx(0.5), pytest.approx(4.0), pytest.approx(2.0))
    assert obs.window_efficiency(tracer, 0.0, 20.0, device=True) == (
        pytest.approx(2.0 / 6.0), pytest.approx(6.0), pytest.approx(2.0))
    st = tracer.stats()["device_s"]
    assert st == {"compute.fwd": 4.0, "policy_swap.swap_out": 4.0,
                  "policy_swap.swap_in": 2.0}


# ------------------------------------------------- the profiler's trace
def _range_names(prof):
    return [e.name for e in prof.events()]


def test_spans_are_profiler_ranges_only_while_it_records(tracer):
    with tracer.span(obs.LANE_MONITOR, "signature"):
        pass                                        # no profiler: no range
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span(obs.LANE_MONITOR, "signature"):
            with obs.profiler_range("exec.pack"):
                torch.ones(2) + 1
    assert {"monitor.signature", "exec.pack"} <= set(_range_names(prof))
    assert [r["name"] for r in tracer.records()].count("signature") == 2
    got = {}

    def worker():                  # a thread given the worker's prefix
        tracer.set_thread_prefix("adapt.worker")
        with profile(activities=[ProfilerActivity.CPU]) as wprof:
            with tracer.span(obs.LANE_ADAPT, "genpolicy_variant"):
                torch.ones(2) * 2
        got["names"] = set(_range_names(wprof))

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert "adapt.worker.genpolicy_variant" in got["names"]
    assert "adapt.genpolicy_variant" not in got["names"]


# ----------------------------------------------------- op-stream invariance
def _work(x, ranged):
    y = x * 2
    if ranged:
        with record_function("outer"), obs.profiler_range("inner"):
            y = y + 1
    else:
        y = y + 1
    return y.sum()


@pytest.mark.parametrize("under_profiler", [False, True],
                         ids=["profiler_off", "profiler_on"])
def test_record_function_ranges_are_no_ops_of_any_counting_mode(
        under_profiler):
    """A ``record_function`` range opened inside a recorded dispatch (the
    harness opens one inside the apply dispatch) leaves the recorder's
    tokens, the detailed profile's op count and the executor's bare
    counter as they are without it, with the profiler on or off."""
    x = torch.ones(8)
    rec = OpStreamRecorder()

    def counts(ranged):
        with rec.iteration() as it:
            _work(x, ranged)
        prof = profile_step(lambda: _work(x, ranged), device="cpu",
                            static_bytes=0)
        ctr = pexec._OpCounter()
        with ctr:
            _work(x, ranged)
        return (it.stream.tokens.tolist(), prof.op_tokens.tolist(),
                ctr.n)

    ctx = (profile(activities=[ProfilerActivity.CPU]) if under_profiler
           else contextlib.nullcontext())
    with ctx:
        plain, ranged = counts(False), counts(True)
    assert plain == ranged


def _cham_trainer(d):
    cfg = PC.get_reduced("llama2-paper")
    tcfg = TrainConfig(steps=8, checkpoint_every=0, checkpoint_dir=str(d),
                       warmup_steps=2, learning_rate=1e-3)
    return Trainer(cfg, tcfg, ChameleonConfig(enabled=True,
                                              hbm_budget_bytes=2 << 20),
                   data=SyntheticTokens(cfg.vocab_size, seq_len=32,
                                        global_batch=2), device="cpu")


def test_profiled_steps_record_the_same_op_stream(tmp_path, tracer):
    """A step under ``torch.profiler``, its spans and the executor's hooks
    ranges, with a ``record_function`` range inside the apply dispatch as
    the benchmark's traced steps open, records the op streams (and so the
    executor's op indices) of the step before it, and runs in the stage a
    twin run without the profiler reaches."""
    twin = _cham_trainer(tmp_path / "twin")
    twin.train(4)
    tr = _cham_trainer(tmp_path / "traced")
    tr.train(3)
    assert tr.rt.step_fn().execution is not None     # the executor runs
    plain = [s.tokens.tolist() for s in tr.rt._sig_acc._prev]
    disp = tr._apply
    inner = disp.fn

    def ranged(*args):
        with record_function("portbench.apply"):
            return inner(*args)

    disp.fn = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tr.train(1)
    finally:
        disp.fn = inner
    names = set(_range_names(prof))
    assert {"compute.train_step", "trainer.settle", "exec.pack",
            "exec.unpack", "monitor.signature", "obs.close_window",
            "portbench.apply"} <= names
    traced = [s.tokens.tolist() for s in tr.rt._sig_acc._prev]
    assert traced == plain and len(plain) == 2
    assert tr.report.stages == twin.report.stages
    st = tr.rt.stats()
    assert 0.0 < st["recorder_s"] + st["obs_close_s"] <= \
        st["profiling_overhead_s"]


# ----------------------------------------------------------- the trainer
def test_trainer_phases_and_iteration_with_chameleon_off(tmp_path, tracer):
    cfg = PC.get_reduced("llama2-paper")
    tcfg = TrainConfig(steps=3, checkpoint_every=0,
                       checkpoint_dir=str(tmp_path), eval_every=2)
    tr = Trainer(cfg, tcfg, ChameleonConfig(enabled=False),
                 data=SyntheticTokens(cfg.vocab_size, 32, 2), device="cpu")
    rep = tr.train(3)
    assert len(rep.device_phases) == 3
    grad = ("fwd", "bwd", "unscale")
    for k, ph in enumerate(rep.device_phases):
        parts = {p: v for p, v in ph.items() if p != "dispatch_s"}
        assert set(parts) == set(grad) | {"clip", "adamw_update"} | (
            {"eval"} if k == 2 else set())
        assert all(v >= 0.0 for v in parts.values())
        assert ph["dispatch_s"] == pytest.approx(sum(parts.values()))
        assert sum(ph[p] for p in grad) <= rep.grad_times[k] + 1e-9
        assert ph["dispatch_s"] <= rep.times[k] + 1e-9
    recs = tracer.records()
    steps = [r["iter"] for r in recs if r["name"] == "train_step"]
    assert steps == [0, 1, 2]
    dev = [r for r in recs if r["kind"] == "device"]
    assert [r["name"] for r in dev if r["iter"] == 0] == [
        "fwd", "bwd", "unscale", "clip", "adamw_update"]
    assert {r["parent"] for r in dev if r["name"] in grad} == {"train_step"}
    assert {r["parent"] for r in dev if r["name"] == "clip"} == {
        "apply_step"}
    host = {r["name"]: r["parent"] for r in recs if r["lane"] == "trainer"}
    assert host == {"batch": None, "step": None, "train_end": None}
    # fwd → bwd → unscale → clip → update lie end to end, in order
    d0 = [r for r in dev if r["iter"] == 0]
    assert all(a["t1"] <= b["t0"] + 1e-9 for a, b in zip(d0, d0[1:]))


# ------------------------------------------- the Chrome export's readers
def test_chrome_export_with_device_records_roundtrips(tmp_path, tracer):
    tracer.set_iteration(2)
    tracer.record(obs.LANE_COMPUTE, "train_step", 10.0, 10.5)
    tracer.set_anchor(FakeEvent(0.0), 10.0)
    tracer.record_device(obs.LANE_COMPUTE, "fwd", FakeEvent(0.1),
                         FakeEvent(0.2))
    tracer.record_device(obs.LANE_POLICY_SWAP, "swap_out", FakeEvent(0.15),
                         FakeEvent(0.3), arg=("act:0", 4096, 0.001))
    path = str(tmp_path / "t.trace.json")
    obs.export_chrome_trace(path, tracer)          # resolves the queue
    obj = json.load(open(path))
    summary = obs.validate_chrome_trace(obj, require_lanes=("compute",))
    assert summary["n_spans"] == 1 and summary["device_spans"] == 2
    assert summary["device_lanes"] == {"compute": 1, "policy_swap": 1}
    xs = {e["name"]: e for e in obj["traceEvents"] if e["ph"] == "X"}
    assert xs["train_step"]["pid"] == 0 and xs["fwd"]["pid"] == 1
    assert xs["fwd"]["ts"] == pytest.approx(100e3)  # one time base
    assert xs["swap_out"]["args"]["detail"] == ["act:0", 4096, 0.001]
    procs = [e["args"]["name"] for e in obj["traceEvents"]
             if e["name"] == "process_name"]
    assert procs == ["device"]
    with pytest.raises(ValueError, match="no spans on required lane"):
        obs.validate_chrome_trace(obj, require_lanes=("policy_swap",))
    rep = report.build_report(obj, None, None)
    assert rep["trace"]["device_lanes"] == summary["device_lanes"]
    md = report.render_markdown(rep)
    assert "- device records over lanes compute:1, policy_swap:1" in md
    assert report.main(["--trace", path, "--out",
                        str(tmp_path / "r.md")]) == 0


def test_the_pending_queue_is_bounded(tracer):
    """With no one to resolve it, the queue keeps the newest ``capacity``
    pairs."""
    small = SpanTracer(capacity=16)
    small.set_anchor(FakeEvent(0.0), 0.0)
    for k in range(18):
        small.record_device(obs.LANE_COMPUTE, f"p{k}", FakeEvent(k),
                            FakeEvent(k + 0.5))
    assert small.stats()["pending"] == 16
    assert small.resolve() == 0
    assert [r["name"] for r in _device(small)] == [f"p{k}"
                                                   for k in range(2, 18)]


def test_train_cli_trace_holds_both_processes(tmp_path):
    """``launch.train --trace-out`` on the CPU writes the host's spans,
    the trainer's, the monitor's and the window close's among them, and
    the device process with the dispatch phases, through the validator
    and the report."""
    from repro_torch.launch import train
    path = str(tmp_path / "t.json")
    train.main(["--reduced", "--device", "cpu", "--steps", "4", "--seq",
                "32", "--global-batch", "2", "--ckpt-dir",
                str(tmp_path / "ckpt"), "--trace-out", path])
    for name in ("runtime", "hostmem", "memory"):
        obs.metrics().unregister_provider(name)
    obj = json.load(open(path))
    summary = obs.validate_chrome_trace(
        obj, require_lanes=("compute", "trainer", "monitor", "obs"))
    assert summary["device_lanes"]["compute"] >= 4 * 5
    names = {e["name"] for e in obj["traceEvents"]
             if e["ph"] == "X" and e["pid"] == 1}
    assert {"fwd", "bwd", "unscale", "clip", "adamw_update"} <= names
    md = report.render_markdown(report.build_report(obj, None, None))
    assert "- device records over lanes compute:" in md
