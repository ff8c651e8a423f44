"""Chrome trace-event / metrics-JSONL schema validation (repro_torch.obs).

Port of ``repro/obs/validate.py``: proves that an exported
``*.trace.json`` loads as a Chrome trace (Perfetto /
``chrome://tracing``), covers the expected lanes and carries the
expected counter tracks, and that a metrics JSONL holds registry
snapshots with the expected providers.  The port's traces may hold a
second process, ``device`` (``tracer.DEVICE_PID``), of device records:
its complete events are counted apart (``device_spans`` and
``device_lanes`` in the summary, which has those keys only then), and
``--require-lanes`` asks for host spans:

    PYTHONPATH=src python -m repro_torch.obs.validate out.trace.json \
        --require-lanes compute,policy_swap,kv_spill,checkpoint,adapt \
        --require-counters overlap_efficiency,hbm_dynamic,swapped_out \
        --require-providers memory \
        --metrics metrics.jsonl

Also importable (``validate_chrome_trace``) so tests assert the same
schema the CLI enforces.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterable, Optional

from repro_torch.obs.metrics import SNAPSHOT_KEYS
from repro_torch.obs.tracer import DEVICE_PID, LANES

_REQUIRED_EVENT_KEYS = {"name", "ph", "pid"}
_PHASES_WITH_TS = {"X", "i", "C"}


def validate_chrome_trace(obj: dict, *,
                          require_lanes: Iterable[str] = (),
                          require_counter: Optional[str] = None,
                          require_counters: Iterable[str] = ()) -> dict:
    """Validate a loaded trace object; returns a summary dict.  Raises
    ``ValueError`` with a precise message on the first schema problem."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be a JSON object with 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty list")
    lanes_named: Dict[int, str] = {}
    span_lanes: Dict[str, int] = {}
    device_lanes: Dict[str, int] = {}
    counters: Dict[str, int] = {}
    n_spans = n_instants = n_device = 0
    for k, e in enumerate(events):
        if not isinstance(e, dict) or not _REQUIRED_EVENT_KEYS <= set(e):
            raise ValueError(f"event {k} missing required keys "
                             f"{sorted(_REQUIRED_EVENT_KEYS - set(e))}")
        ph = e["ph"]
        if ph in _PHASES_WITH_TS and not isinstance(e.get("ts"), (int, float)):
            raise ValueError(f"event {k} (ph={ph!r}) has no numeric 'ts'")
        device = e["pid"] == DEVICE_PID
        if ph == "M" and e["name"] == "thread_name":
            if not device:
                lanes_named[e.get("tid", -1)] = e["args"]["name"]
        elif ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {k} ('{e['name']}') has bad dur "
                                 f"{dur!r}")
            lane = e.get("cat", lanes_named.get(e.get("tid"), "?"))
            if device:
                device_lanes[lane] = device_lanes.get(lane, 0) + 1
                n_device += 1
            else:
                span_lanes[lane] = span_lanes.get(lane, 0) + 1
                n_spans += 1
        elif ph == "i":
            n_instants += 1
        elif ph == "C":
            if "value" not in e.get("args", {}):
                raise ValueError(f"counter event {k} ('{e['name']}') has no "
                                 "args.value")
            counters[e["name"]] = counters.get(e["name"], 0) + 1
    missing_meta = [l for l in LANES if l not in lanes_named.values()]
    if missing_meta:
        raise ValueError(f"missing thread_name metadata for lanes "
                         f"{missing_meta}")
    for lane in require_lanes:
        if span_lanes.get(lane, 0) == 0:
            raise ValueError(f"no spans on required lane {lane!r} "
                             f"(got {span_lanes})")
    wanted = list(require_counters)
    if require_counter is not None:
        wanted.append(require_counter)
    for cname in wanted:
        if counters.get(cname, 0) == 0:
            raise ValueError(f"no '{cname}' counter events "
                             f"(got {sorted(counters)})")
    out = {"n_events": len(events), "n_spans": n_spans,
           "n_instants": n_instants, "span_lanes": span_lanes,
           "counters": counters}
    if n_device:
        out.update(device_spans=n_device, device_lanes=device_lanes)
    return out


def validate_metrics_jsonl(path: str, *,
                           require_gauges: Iterable[str] = (),
                           require_providers: Iterable[str] = ()) -> dict:
    """Every line must be a registry snapshot with the documented keys;
    the *last* snapshot must additionally carry the required gauges and
    provider blocks (e.g. the ledger's ``memory`` provider)."""
    n = 0
    last = None
    with open(path) as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            snap = json.loads(line)
            missing = [k for k in SNAPSHOT_KEYS if k not in snap]
            if missing:
                raise ValueError(f"snapshot line {i} missing keys {missing}")
            n += 1
            last = snap
    if n == 0:
        raise ValueError(f"{path}: no snapshots")
    for g in require_gauges:
        if g not in last.get("gauges", {}):
            raise ValueError(f"last snapshot missing gauge {g!r} "
                             f"(got {sorted(last.get('gauges', {}))})")
    for p in require_providers:
        if p not in last.get("providers", {}):
            raise ValueError(f"last snapshot missing provider {p!r} "
                             f"(got {sorted(last.get('providers', {}))})")
    return {"snapshots": n, "gauges": sorted(last.get("gauges", {})),
            "providers": sorted(last.get("providers", {}))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="*.trace.json path")
    ap.add_argument("--require-lanes", default="",
                    help="comma-separated lanes that must carry >=1 span")
    ap.add_argument("--require-counter", default=None,
                    help="counter track that must be present (e.g. "
                         "overlap_efficiency)")
    ap.add_argument("--require-counters", default="",
                    help="comma-separated counter tracks that must all be "
                         "present (e.g. hbm_dynamic,swapped_out)")
    ap.add_argument("--require-gauges", default="",
                    help="gauges the last metrics snapshot must carry")
    ap.add_argument("--require-providers", default="",
                    help="provider blocks the last metrics snapshot must "
                         "carry (e.g. memory)")
    ap.add_argument("--metrics", default=None,
                    help="also validate this metrics JSONL file")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        obj = json.load(f)
    split = lambda s: [x for x in s.split(",") if x]
    summary = validate_chrome_trace(
        obj, require_lanes=split(args.require_lanes),
        require_counter=args.require_counter,
        require_counters=split(args.require_counters))
    print(f"{args.trace}: OK — {summary['n_spans']} spans over lanes "
          f"{summary['span_lanes']}, counters {summary['counters']}"
          + (f"; {summary['device_spans']} device records over lanes "
             f"{summary['device_lanes']}" if "device_spans" in summary
             else ""))
    if args.metrics:
        ms = validate_metrics_jsonl(
            args.metrics, require_gauges=split(args.require_gauges),
            require_providers=split(args.require_providers))
        print(f"{args.metrics}: OK — {ms['snapshots']} snapshots, "
              f"providers {ms['providers']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
