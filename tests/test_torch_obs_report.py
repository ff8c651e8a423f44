"""The port's trace / metrics validators and post-mortem report
(``repro_torch.obs.validate``, ``repro_torch.obs.report``): the validate
cases of ``tests/test_obs.py`` and the export -> validate -> report cases of
``tests/test_memledger.py``, each also run through the reference's
package on the same inputs, where the two reports must agree.  Also the
train CLI's ``--trace-out`` / ``--audit-out`` / ``--metrics-out`` files
through both CLIs (``python -m repro_torch.obs.validate``, ``python -m
repro_torch.obs.report``) and the report's adaptation events."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from repro import obs as robs
from repro.core.policy import projected_peak as r_projected_peak
from repro.hostmem.engine import TC_POLICY_SWAP as R_TC
from repro.obs.report import main as r_report_main
from repro_torch import faults, obs
from repro_torch.core.policy import projected_peak
from repro_torch.hostmem.engine import TC_POLICY_SWAP
from repro_torch.obs import report
from repro_torch.obs.memledger import LEDGER_TRACKS
from repro_torch.obs.tracer import SpanTracer, chrome_trace_events
from repro_torch.obs.validate import (validate_chrome_trace,
                                      validate_metrics_jsonl)

SRC = Path(__file__).resolve().parents[1] / "src"
PKGS = {"port": (obs, TC_POLICY_SWAP, projected_peak, report.main),
        "ref": (robs, R_TC, r_projected_peak, r_report_main)}


@pytest.fixture(autouse=True)
def _fresh_obs():
    """Isolated obs singletons of both packages per test."""
    faults.disarm()
    old = {k: (m.set_ledger(m.MemoryLedger()),
               m.set_metrics(m.MetricsRegistry()),
               m.set_audit(m.AuditLog()), m.set_tracer(m.SpanTracer()))
           for k, (m, *_rest) in PKGS.items()}
    yield
    faults.disarm()
    for k, (m, *_rest) in PKGS.items():
        led, met, aud, tr = old[k]
        m.set_ledger(led)
        m.set_metrics(met)
        m.set_audit(aud)
        m.set_tracer(tr)


# ----------------------------------------------------- fake profile bits
def _tensor(uid, birth, death, nbytes, layer=0, site="act"):
    return SimpleNamespace(uid=uid, birth=birth, death=death,
                           nbytes=nbytes, layer=layer, site=site)


def _entry(t, out_op, in_op):
    return SimpleNamespace(uid=t.uid, layer=t.layer, site=t.site,
                           nbytes=t.nbytes, birth=t.birth,
                           swap_out_done_op=out_op, swap_in_op=in_op)


def _tag(e):
    return f"{e.site or 'tensor'}:{e.layer}:{e.uid}"


def _scenario(peak_fn):
    """tests/test_memledger.py::_scenario: three overlapping tensors, two
    swap entries whose off-device windows cover the baseline peak."""
    ts = [_tensor(1, 0, 10, 4096), _tensor(2, 1, 9, 8192),
          _tensor(3, 3, 7, 2048)]
    prof = SimpleNamespace(tensors=ts, n_ops=10, static_bytes=1000)
    entries = [_entry(ts[1], out_op=2, in_op=8),
               _entry(ts[2], out_op=4, in_op=6)]
    swap = SimpleNamespace(entries=entries,
                           projected_peak=peak_fn(prof, entries))
    return prof, swap


# ------------------------------------------------------------ validators
def test_metrics_jsonl_roundtrip(tmp_path):
    p = str(tmp_path / "m.jsonl")
    reg = obs.MetricsRegistry()
    reg.counter("c")
    reg.gauge("g", 1.5)
    reg.write_jsonl(p)
    reg.write_jsonl(p)
    assert validate_metrics_jsonl(p) == {"snapshots": 2, "gauges": ["g"],
                                         "providers": []}
    assert validate_metrics_jsonl(p) == robs.validate_metrics_jsonl(p)
    assert validate_metrics_jsonl(p, require_gauges=("g",))["snapshots"] == 2
    with pytest.raises(ValueError, match="missing gauge"):
        validate_metrics_jsonl(p, require_gauges=("absent",))


def test_chrome_export_roundtrips_through_validator(tmp_path):
    tr = SpanTracer(capacity=256)
    tr.set_iteration(1)
    base = time.perf_counter()
    for i, lane in enumerate(obs.LANES):
        tr.record(lane, f"{lane}-work", base + i, base + i + 0.25,
                  arg=("tag", 123))
    tr.instant(obs.LANE_ADAPT, "stage:Stable", t=base + 9.0, arg=(7, "why"))
    p = str(tmp_path / "out.trace.json")
    obs.export_chrome_trace(
        p, tr,
        counters={"overlap_efficiency": [(base + 1.0, 0.5),
                                         (base + 2.0, 0.75)]},
        meta={"run": "unit"})
    obj = json.load(open(p))
    summary = validate_chrome_trace(obj, require_lanes=obs.LANES,
                                    require_counter="overlap_efficiency")
    assert summary == robs.validate_chrome_trace(
        obj, require_lanes=obs.LANES, require_counter="overlap_efficiency")
    assert summary["n_spans"] == len(obs.LANES)
    assert summary["n_instants"] == 1
    assert summary["counters"]["overlap_efficiency"] == 2
    assert obj["otherData"]["run"] == "unit"
    xs = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    assert all(e["ts"] >= 0 for e in xs)
    assert all(e["args"]["iter"] == 1 for e in xs)
    assert xs[0]["args"]["detail"] == ["tag", 123]


def test_validator_rejects_missing_lane_and_bad_events():
    tr = SpanTracer(capacity=64)
    tr.record(obs.LANE_COMPUTE, "c", 0.0, 1.0)
    obj = {"traceEvents": chrome_trace_events(tr)}
    with pytest.raises(ValueError, match="kv_spill"):
        validate_chrome_trace(obj, require_lanes=("compute", "kv_spill"))
    with pytest.raises(ValueError, match="traceEvents"):
        validate_chrome_trace({"events": []})
    bad = {"traceEvents": [dict(e) for e in obj["traceEvents"]]}
    span = next(e for e in bad["traceEvents"] if e["ph"] == "X")
    span["dur"] = -1
    with pytest.raises(ValueError, match="bad dur"):
        validate_chrome_trace(bad)


# ------------------------------------- export + validate + report (ledger)
def test_counter_tracks_export_passes_validator(tmp_path):
    prof, swap = _scenario(projected_peak)
    led = obs.ledger()
    led.close_iteration(1, profile=prof, swap=swap,
                        pool_stats={"bytes_in_use": 512,
                                    "bytes_alloc_total": 512,
                                    "bytes_freed_total": 0})
    tracks = led.counter_tracks()
    assert set(tracks) == set(LEDGER_TRACKS)
    assert all(tracks[name] for name in LEDGER_TRACKS)
    path = str(tmp_path / "t.trace.json")
    obs.export_chrome_trace(path, obs.tracer(), counters=tracks)
    with open(path) as f:
        summary = obs.validate_chrome_trace(
            json.load(f), require_counters=LEDGER_TRACKS)
    for name in LEDGER_TRACKS:
        assert summary["counters"][name] >= 1
    with pytest.raises(ValueError, match="no 'nope' counter"):
        with open(path) as f:
            obs.validate_chrome_trace(json.load(f),
                                      require_counters=("nope",))


def test_metrics_validator_checks_gauges_and_providers(tmp_path):
    prof, swap = _scenario(projected_peak)
    obs.metrics().register_provider("memory", lambda: obs.ledger().stats())
    obs.ledger().close_iteration(1, profile=prof, swap=swap)
    path = str(tmp_path / "m.jsonl")
    obs.metrics().write_jsonl(path)
    ms = obs.validate_metrics_jsonl(
        path, require_gauges=("memory.realized_peak", "memory.peak_error"),
        require_providers=("memory",))
    assert ms["snapshots"] == 1
    with pytest.raises(ValueError, match="missing provider"):
        obs.validate_metrics_jsonl(path, require_providers=("absent",))


def _report_run(tmp_path, pkg):
    """The reference test's scenario through one package: ledger events,
    a scored window, trace / metrics / audit files, then that package's
    report CLI with the 0.10 peak-error gate.  Returns (rc, markdown,
    report JSON)."""
    mod, tc, peak_fn, main = PKGS[pkg]
    d = tmp_path / pkg
    d.mkdir()
    prof, swap = _scenario(peak_fn)
    led = mod.ledger()
    mod.metrics().register_provider("memory", lambda: led.stats())
    audit_path = str(d / "a.jsonl")
    mod.audit().attach_file(audit_path)
    for e in swap.entries:
        led.note_transfer("out", tc, _tag(e), e.nbytes,
                          release_op=e.swap_out_done_op)
    led.close_iteration(1, profile=prof, swap=swap,
                        budget=swap.projected_peak * 2)
    mod.audit().event("adaptation.enqueue", step=1, epoch=0)
    mod.audit().event("adaptation.failed", step=1, epoch=0, error="x")
    trace = str(d / "t.trace.json")
    mod.export_chrome_trace(trace, mod.tracer(),
                            counters=led.counter_tracks())
    metrics = str(d / "m.jsonl")
    mod.metrics().write_jsonl(metrics)
    mod.audit().detach_file()
    out_md, out_js = str(d / "report.md"), str(d / "report.json")
    rc = main(["--trace", trace, "--metrics", metrics, "--audit", audit_path,
               "--out", out_md, "--json", out_js,
               "--check-peak-error", "0.10"])
    return rc, open(out_md).read(), json.load(open(out_js))


def test_report_cli_renders_postmortem_and_gates(tmp_path, capsys):
    """The post-mortem of one scored iteration: the gate passes at 0.10,
    and every section the reference renders equals the reference's; the
    port adds the adaptation worker's events."""
    rc, md, rep = _report_run(tmp_path, "port")
    rrc, rmd, rrep = _report_run(tmp_path, "ref")
    assert rc == rrc == 0
    assert "# Run post-mortem" in md
    assert "predicted vs realized" in md
    assert rep["memory"]["max_abs_peak_error"] == 0.0
    assert set(rep["trace"]["ledger_tracks_present"]) == set(LEDGER_TRACKS)
    assert rep["audit"]["memory"].get("memory.peak") == 1
    for key in ("memory", "overlap", "n_snapshots"):
        assert rep[key] == rrep[key], key
    for key in ("n_spans", "span_lanes", "counters", "ledger_tracks_present"):
        assert rep["trace"][key] == rrep["trace"][key], key
    for fam in ("drift", "policy", "memory", "faults", "ladder", "health",
                "ckpt"):
        assert rep["audit"][fam] == rrep["audit"][fam], fam
    assert rep["audit"]["adaptation"] == {"adaptation.enqueue": 1,
                                          "adaptation.failed": 1}
    assert [e["kind"] for e in rep["audit"]["adaptation_events"]] == [
        "adaptation.failed"]
    assert "- adaptation: adaptation.enqueue=1, adaptation.failed=1" in md


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_report_gate_fails_without_scored_iterations(tmp_path, capsys, pkg):
    """Snapshots with no ``memory.peak_error`` series: the gate fails
    loudly (exit 2) instead of passing a run that never scored."""
    mod, _tc, _peak, main = PKGS[pkg]
    metrics = str(tmp_path / "m.jsonl")
    mod.metrics().gauge("overlap_efficiency", 0.9)
    mod.metrics().write_jsonl(metrics)
    rc = main(["--metrics", metrics, "--out", str(tmp_path / "r.md"),
               "--check-peak-error", "0.10"])
    assert rc == 2
    assert "no memory.peak_error points" in capsys.readouterr().err


def test_report_gate_fails_over_the_limit():
    rep = {"memory": {"max_abs_peak_error": 0.25}}
    assert "exceeds limit" in report.check_peak_error(rep, 0.10)
    assert report.check_peak_error(rep, 0.30) is None
    assert "no metrics" in report.check_peak_error({"memory": None}, 0.1)


# ---------------------------------------- the train CLI's files, both CLIs
def test_train_cli_artifacts_through_validate_and_report(tmp_path):
    """``launch.train --adapt-mode async --policy-store-dir D --trace-out T
    --audit-out A --metrics-out M`` on the CPU: the store keeps the
    worker's record, the validator passes the trace's compute and adapt
    lanes and the metrics' providers, and the report renders the
    adaptation events; its gate fails, since the budget needs no swap and
    nothing is scored."""
    from repro_torch.launch import train
    f = {k: str(tmp_path / k) for k in ("store", "ckpt", "t.json",
                                        "m.jsonl", "a.jsonl", "r.md")}
    stats = train.main([
        "--reduced", "--device", "cpu", "--steps", "30", "--seq", "32",
        "--global-batch", "2", "--adapt-mode", "async", "--metrics-every",
        "5", "--policy-store-dir", f["store"], "--ckpt-dir", f["ckpt"],
        "--trace-out", f["t.json"], "--audit-out", f["a.jsonl"],
        "--metrics-out", f["m.jsonl"]])
    for name in ("runtime", "hostmem", "memory"):
        obs.metrics().unregister_provider(name)
    assert stats["adapt"]["mode"] == "async"
    assert stats["adapt"]["installed"] >= 1 and not stats["adapt"]["failed"]
    assert "Adapting" in stats["stages"] and "GenPolicy" not in stats["stages"]
    assert stats["policystore"]["store"]["records"] >= 1
    assert any(n.endswith(".json") and n != "lsh.index"
               for n in os.listdir(f["store"]))
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    run = lambda *a: subprocess.run([sys.executable, "-m", *a], env=env,
                                    capture_output=True, text=True,
                                    timeout=120)
    v = run("repro_torch.obs.validate", f["t.json"], "--require-lanes",
            "compute,adapt", "--metrics", f["m.jsonl"],
            "--require-providers", "memory,runtime")
    assert v.returncode == 0, v.stderr
    assert "OK" in v.stdout
    r = run("repro_torch.obs.report", "--trace", f["t.json"], "--metrics",
            f["m.jsonl"], "--audit", f["a.jsonl"], "--out", f["r.md"],
            "--check-peak-error", "0.10")
    assert r.returncode == 2 and "no memory.peak_error" in r.stderr
    md = open(f["r.md"]).read()
    assert "- adaptation: " in md and "adaptation.publish=1" in md
    events = [json.loads(ln) for ln in open(f["a.jsonl"])]
    assert {"adaptation.enqueue", "adaptation.publish",
            "policy.apply"} <= {e["kind"] for e in events}
