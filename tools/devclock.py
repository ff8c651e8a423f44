#!/usr/bin/env python3
"""The tracer's device clock and the program's spans on one NVIDIA GPU, for
one benchmark cell, from one checkout:

    python3 tools/devclock.py --workload <cell> [--tree DIR] [--seed N]
        [--steps 100] [--no-traced] [--out FILE]

It builds the cell's trainer as ``portbench.run`` does (``portbench.harness``
of the checkout ``DIR``, default this one: set-up, the first three steps
and the warm-up), then:

  * ``--steps`` steps as the benchmark's window runs them, each followed
    by a device sync and a probe: a timing event recorded on the idle
    device, the host clock read just after, and the probe's time through
    the tracer's anchor (``SpanTracer.device_time``) less that reading,
    the anchor's mapping error.  Per step the wall time, the trainer's
    ``device_phases``, and the host gap (the wall less ``dispatch_s``),
    also as means by bucket, and the tracer's host spans a step by name;
    with Chameleon the runtime's ``recorder_s``, ``obs_close_s`` and
    ``profiling_overhead_s`` over the steps, the overlap efficiency of
    the windows they closed (``obs_stats()["overlap"]``) and the
    executor's copy stall;
  * steps to the next bucket boundary, then four blocks of one schedule
    period each under ``torch.profiler`` as the benchmark's traced steps
    run (``Run.traced``): the first and the last with the program's
    profiler ranges, the middle two with them off (the gate of
    ``repro_torch.obs.tracer`` held false), so each bucket runs once each
    way.  Per block the steps' stages, wall times, busy share and the ten
    longest idle gaps with the host range at each (the innermost, as the
    benchmark names them), and beside each the innermost of the
    program's own ranges (``program_gaps``: a name with a lane's prefix,
    ``exec.`` or the harness's apply range; ``none`` where no such range
    was open).

A checkout without the device clock (an older tree) skips what needs it.
One JSON object to standard output and to ``--out``, with the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e!r}"


def probe_error(torch, tracer, device):
    """The mapping error of a probe recorded on the idle device, in s."""
    torch.cuda.synchronize(device)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    t = time.perf_counter()
    ev.synchronize()
    return tracer.device_time(ev) - t


def quartiles(xs):
    if len(xs) < 2:
        return xs
    return statistics.quantiles(xs, n=4)


def window(run, n_steps, torch, device):
    from repro_torch import obs
    from portbench import yardstick
    tr = run.tr
    tracer = obs.tracer()
    clock = hasattr(tracer, "device_time")
    before = run.runtime_stats()
    n0 = tracer.stats()["n_spans"]
    rows, errs = [], []
    for _ in range(n_steps):
        row = run.step()
        ph = getattr(tr.report, "device_phases", None)
        if ph:
            row["device"] = ph[-1]
        if clock and tracer.anchored:
            errs.append(probe_error(torch, tracer, device))
        rows.append(row)
    after = run.runtime_stats()
    n1 = tracer.stats()["n_spans"]
    out = {"steps": len(rows),
           "wall_ms_median": statistics.median(r["wall_s"] for r in rows)
           * 1e3,
           "stages": sorted({r["stage"] for r in rows if r["stage"]})}
    if errs:
        out["anchor_error_us"] = {
            "max_abs": max(abs(e) for e in errs) * 1e6,
            "median": statistics.median(errs) * 1e6,
            "quartiles": [q * 1e6 for q in quartiles(errs)], "n": len(errs)}
    dev = [r for r in rows if "device" in r]
    if dev:
        gaps = [(r["wall_s"] - r["device"]["dispatch_s"]) * 1e3 for r in dev]
        out["host_gap_ms"] = {"mean": statistics.mean(gaps),
                              "quartiles": quartiles(gaps)}
        phases = sorted({k for r in dev for k in r["device"]})
        out["phase_ms_mean"] = {
            k: statistics.mean(r["device"].get(k, 0.0) for r in dev) * 1e3
            for k in phases}
        upd = [r["device"]["adamw_update"] for r in dev
               if "adamw_update" in r["device"]]
        bound = yardstick.adamw_bytes(run.cfgj) / yardstick.PEAK_HBM_BYTES_S
        out["adamw_update_roofline"] = 100.0 * len(upd) * bound / sum(upd)
        both = [r["device"]["clip"] + r["device"]["adamw_update"]
                for r in dev if "adamw_update" in r["device"]]
        out["apply_roofline"] = 100.0 * len(both) * bound / sum(both)
        by_seq = {}
        for r in dev:
            by_seq.setdefault(r["seq"], []).append(r)
        out["by_bucket"] = {
            seq: {"steps": len(rs),
                  "wall_ms": statistics.mean(r["wall_s"] for r in rs) * 1e3,
                  **{k: statistics.mean(r["device"].get(k, 0.0)
                                        for r in rs) * 1e3
                     for k in phases}}
            for seq, rs in sorted(by_seq.items())}
    if 0 < n1 - n0 <= tracer.capacity:
        # host spans a step by <lane>.<name> (a span's whole length)
        spent = {}
        for r in tracer.records()[-(n1 - n0):]:
            if r["kind"] == "span":
                key = f"{r['lane']}.{r['name']}"
                spent[key] = spent.get(key, 0.0) + r["t1"] - r["t0"]
        out["host_span_ms_a_step"] = {k: v / len(rows) * 1e3
                                      for k, v in sorted(spent.items())}
    if before is not None:
        n = len(rows)
        per = lambda k: ((after[k] - before[k]) / n * 1e3
                         if k in after else None)
        out["monitor_ms"] = per("profiling_overhead_s")
        out["recorder_ms"] = per("recorder_s")
        out["obs_close_ms"] = per("obs_close_s")
        ov0, ov1 = before["obs"]["overlap"], after["obs"]["overlap"]
        moved = ov1["transfer_s"] - ov0["transfer_s"]
        out["overlap"] = {
            "efficiency": ((ov1["hidden_s"] - ov0["hidden_s"]) / moved
                           if moved > 0 else None),
            "transfer_ms_a_step": moved / n * 1e3,
            "measured_windows": ov1["measured"] - ov0["measured"]}
        ex = [r["exec"] for r in rows if r.get("exec")]
        out["copy_stall_ms"] = (sum(e["copy_stall_s"] for e in ex) / n * 1e3
                                if ex else None)
        dev_s = after["obs"]["tracer"].get("device_s")
        if dev_s:
            b = before["obs"]["tracer"]["device_s"]
            out["tracer_device_ms_a_step"] = {
                k: (v - b.get(k, 0.0)) / n * 1e3 for k, v in dev_s.items()}
    return out


def program_gaps(prof, devtrace, prefixes):
    """The ten longest idle gaps of a profile as the benchmark finds them
    (``devtrace.read``), each as [innermost host range, innermost program
    range, seconds]."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not (e.name == devtrace.APPLY
                    or getattr(e, "is_user_annotation", False)):
                dev.append((s, t))
        elif e.device_type == DeviceType.CPU:
            host.append((s, t, e.name))
    _, gaps = devtrace._union(dev)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for g0, g1 in gaps[:10]:
        mid = (g0 + g1) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        ours = [h for h in inner if h[2].startswith(prefixes)]
        name = lambda hs: (min(hs, key=lambda h: h[1] - h[0])[2] if hs
                           else "none")
        out.append([name(inner), name(ours), (g1 - g0) * 1e-6])
    return out


def traced_blocks(run):
    """Four traced blocks of one period: ranges on, off, off, on."""
    from portbench import devtrace, harness
    tmod = importlib.import_module("repro_torch.obs.tracer")
    gate = getattr(tmod, "_profiling", None)
    prefixes = tuple(f"{lane}." for lane in tmod.LANES) + (
        "exec.", devtrace.APPLY)
    real_read = harness.devtrace.read
    profs = []

    def read(prof, window_s):
        profs.append(program_gaps(prof, devtrace, prefixes))
        return real_read(prof, window_s)

    harness.devtrace.read = read
    while run.k % run.schedule.period:
        run.step()
    blocks = []
    for ranges in (True, False, False, True):
        if gate is not None:
            tmod._profiling = gate if ranges else (lambda: False)
        try:
            t = run.traced(run.schedule.period)
        finally:
            if gate is not None:
                tmod._profiling = gate
        walls = [r["wall_s"] for r in t["steps"]]
        blocks.append({
            "ranges": ranges and gate is not None,
            "bucket": t["steps"][0]["seq"],
            "stages": [r["stage"] for r in t["steps"]],
            "wall_ms_mean": statistics.mean(walls) * 1e3,
            "idle_share": (100.0 * (1 - t["busy_s"] / t["window_s"])
                           if t["busy_s"] else None),
            "idle_gaps": t["breakdown"]["idle_gaps"],
            "program_gaps": profs[-1]})
    harness.devtrace.read = real_read
    return blocks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--seed", type=int, default=2_147_483_659)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--no-traced", action="store_true",
                    help="skip the traced blocks")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("devclock: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    _, cfgj, traffic, _ = harness.cell_files(args.workload)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="devclock_") as ckpt:
        run = harness.Run(cfgj, traffic, args.seed, device, ckpt)
        harness.warm_profiler(device)
        run.first_steps()
        run.warm()
        out = {"card": card(), "tree": tree, "workload": args.workload,
               "seed": args.seed, "setup_s": time.perf_counter() - t0}
        out["window"] = window(run, args.steps, torch, device)
        out["traced"] = [] if args.no_traced else traced_blocks(run)
        harness.drop_trainer(run.tr)
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
