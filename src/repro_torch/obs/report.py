"""Post-mortem report (``python -m repro_torch.obs.report``).

Port of ``repro/obs/report.py``.  Turns a run's exported artifacts —
Chrome trace JSON, metrics JSONL, audit-event JSONL — into one markdown
(and optionally JSON) post-mortem: peak trajectory and the
predicted-vs-realized scoreboard, overlap efficiency, drift-tier
decisions, the adaptation worker's events (enqueue, publish, discard,
failed, watchdog; a family the reference's report does not list), fault /
degradation-ladder / health events, and leak suspects.  It doubles as a
gate::

    PYTHONPATH=src python -m repro_torch.obs.report \
        --trace run.trace.json --metrics run.metrics.jsonl \
        --audit run.audit.jsonl --out postmortem.md \
        --json postmortem.json --check-peak-error 0.10

``--check-peak-error FRAC`` exits non-zero when any scored iteration's
|realized - projected| / projected exceeds FRAC — or when no iteration
was scored at all, so the gate cannot silently pass on a run that never
produced the metric.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.obs.memledger import LEDGER_TRACKS
from repro_torch.obs.validate import validate_chrome_trace


def _load_json(path: Optional[str]):
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _load_jsonl(path: Optional[str]) -> Optional[List[dict]]:
    if not path or not os.path.exists(path):
        return None
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(json.loads(line))
    return out


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} GiB"


def _fmt(v, nd=4) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


# --------------------------------------------------------------- sections
def build_report(trace: Optional[dict], snapshots: Optional[List[dict]],
                 audit: Optional[List[dict]], top: int = 8) -> dict:
    """Assemble the structured post-mortem; every section degrades to
    ``None`` when its input artifact is missing."""
    rep: dict = {"sections": []}

    if trace is not None:
        summary = validate_chrome_trace(trace)
        rep["trace"] = {
            "meta": trace.get("otherData", {}),
            "n_spans": summary["n_spans"],
            "span_lanes": summary["span_lanes"],
            "counters": summary["counters"],
            "ledger_tracks_present": [t for t in LEDGER_TRACKS
                                      if summary["counters"].get(t)],
            # the port's device process (obs.validate), where there is one
            "device_lanes": summary.get("device_lanes"),
        }
    else:
        rep["trace"] = None

    last = snapshots[-1] if snapshots else None
    if last is not None:
        gauges = last.get("gauges", {})
        series = last.get("series", {})
        providers = last.get("providers", {})
        mem = providers.get("memory")
        err_pts = series.get("memory.peak_error", [])
        peak_pts = series.get("memory.realized_peak", [])
        rep["memory"] = {
            "scoreboard": (mem or {}).get("scoreboard"),
            "last": (mem or {}).get("last"),
            "leak_suspects": (mem or {}).get("leak_suspects"),
            "iterations": (mem or {}).get("iterations"),
            "peak_trajectory": [p[1] for p in peak_pts[-top:]],
            "error_trajectory": [p[1] for p in err_pts[-top:]],
            "max_abs_peak_error": (max(abs(p[1]) for p in err_pts)
                                   if err_pts else None),
            "headroom_frac": gauges.get("memory.headroom_frac"),
        }
        rep["overlap"] = {
            "last": gauges.get("overlap_efficiency"),
            "points": [p[1] for p in
                       series.get("overlap_efficiency", [])[-top:]],
        }
        rep["counters_snapshot"] = last.get("counters", {})
        rep["n_snapshots"] = len(snapshots)
    else:
        rep["memory"] = rep["overlap"] = rep["counters_snapshot"] = None
        rep["n_snapshots"] = 0

    if audit is not None:
        kinds: dict = {}
        for ev in audit:
            kinds[ev.get("kind", "?")] = kinds.get(ev.get("kind", "?"), 0) + 1
        fam = lambda prefix: {k: v for k, v in sorted(kinds.items())
                              if k.startswith(prefix)}
        rep["audit"] = {
            "n_events": len(audit),
            "drift": fam("drift."),
            "policy": fam("policy."),
            "adaptation": fam("adaptation."),
            "memory": fam("memory."),
            "faults": fam("fault."),
            "ladder": fam("ladder."),
            "health": fam("health."),
            "ckpt": fam("ckpt."),
            "adaptation_events": [
                ev for ev in audit if ev.get("kind") in (
                    "adaptation.failed", "adaptation.watchdog")][-top:],
            "ladder_events": [ev for ev in audit
                              if ev.get("kind", "").startswith("ladder.")
                              ][-top:],
            "leak_events": [ev for ev in audit
                            if ev.get("kind") == "memory.leak_suspect"
                            ][-top:],
            "pressure_events": [ev for ev in audit
                                if ev.get("kind") == "memory.pressure"
                                ][-top:],
        }
    else:
        rep["audit"] = None
    return rep


def render_markdown(rep: dict) -> str:
    L: List[str] = ["# Run post-mortem", ""]
    tr = rep["trace"]
    if tr is not None:
        L += ["## Trace", ""]
        if tr["meta"]:
            L.append("meta: " + ", ".join(f"{k}={v}" for k, v in
                                          sorted(tr["meta"].items())))
        L.append(f"- {tr['n_spans']} spans over lanes "
                 + ", ".join(f"{k}:{v}" for k, v in
                             sorted(tr["span_lanes"].items())))
        if tr["device_lanes"]:
            L.append("- device records over lanes "
                     + ", ".join(f"{k}:{v}" for k, v in
                                 sorted(tr["device_lanes"].items())))
        L.append("- counter tracks: "
                 + ", ".join(f"{k}({v})" for k, v in
                             sorted(tr["counters"].items())))
        missing = [t for t in LEDGER_TRACKS
                   if t not in tr["ledger_tracks_present"]]
        L.append("- ledger occupancy tracks: "
                 + (", ".join(tr["ledger_tracks_present"]) or "none")
                 + (f"  (missing: {', '.join(missing)})" if missing else ""))
        L.append("")
    mem = rep["memory"]
    if mem is not None:
        L += ["## Memory — predicted vs realized", ""]
        sb = mem["scoreboard"] or {}
        L.append(f"- scored iterations: {_fmt(sb.get('n'))} "
                 f"(of {_fmt(mem.get('iterations'))} closed)")
        L.append(f"- peak error: mean |e| = {_fmt(sb.get('mean_abs_error'))},"
                 f" max |e| = {_fmt(sb.get('max_abs_error'))}"
                 f" (worst step {_fmt(sb.get('worst_step'))})")
        last = mem["last"] or {}
        L.append(f"- last iteration: realized "
                 f"{_fmt_bytes(last.get('realized_peak'))}, projected "
                 f"{_fmt_bytes(last.get('projected_peak'))}, headroom "
                 f"{_fmt(last.get('headroom_frac'))}")
        L.append(f"- leak suspects: {_fmt(mem['leak_suspects'])}")
        if mem["peak_trajectory"]:
            L.append("- realized-peak trajectory (last points): "
                     + ", ".join(_fmt_bytes(v)
                                 for v in mem["peak_trajectory"]))
        if mem["error_trajectory"]:
            L.append("- peak-error trajectory: "
                     + ", ".join(_fmt(v) for v in mem["error_trajectory"]))
        L.append("")
    ov = rep["overlap"]
    if ov is not None:
        L += ["## Overlap efficiency", "",
              f"- last: {_fmt(ov['last'])}"
              + (", points: " + ", ".join(_fmt(v, 3) for v in ov["points"])
                 if ov["points"] else ""),
              ""]
    au = rep["audit"]
    if au is not None:
        L += ["## Audit events", "", f"- total: {au['n_events']}"]
        for fam in ("drift", "policy", "adaptation", "memory", "faults",
                    "ladder", "health", "ckpt"):
            if au[fam]:
                L.append(f"- {fam}: "
                         + ", ".join(f"{k}={v}" for k, v in
                                     au[fam].items()))
        for name, evs in (("adaptation", au["adaptation_events"]),
                          ("ladder", au["ladder_events"]),
                          ("pressure", au["pressure_events"]),
                          ("leak", au["leak_events"])):
            if evs:
                L.append(f"- last {name} events:")
                for ev in evs:
                    fields = {k: v for k, v in ev.items()
                              if k not in ("seq", "t", "kind")}
                    L.append(f"    - `{ev['kind']}` "
                             + ", ".join(f"{k}={v}" for k, v in
                                         fields.items()))
        L.append("")
    return "\n".join(L) + "\n"


# ------------------------------------------------------------------- gate
def check_peak_error(rep: dict, limit: float) -> Optional[str]:
    """Return an error string when the gate fails, else ``None``."""
    mem = rep.get("memory")
    if mem is None:
        return "peak-error gate: no metrics snapshots to score"
    worst = mem.get("max_abs_peak_error")
    if worst is None:
        return ("peak-error gate: no memory.peak_error points — "
                "no iteration was scored against a projected peak")
    if worst > limit:
        return (f"peak-error gate: max |realized-projected|/projected = "
                f"{worst:.4f} exceeds limit {limit:.4f}")
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace", default=None, help="*.trace.json path")
    ap.add_argument("--metrics", default=None, help="metrics JSONL path")
    ap.add_argument("--audit", default=None, help="audit-event JSONL path")
    ap.add_argument("--out", default=None,
                    help="write the markdown post-mortem here "
                         "(default: stdout)")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also dump the structured report as JSON")
    ap.add_argument("--top", type=int, default=8,
                    help="trajectory/event tail length per section")
    ap.add_argument("--check-peak-error", type=float, default=None,
                    metavar="FRAC",
                    help="exit 2 unless every scored iteration's "
                         "|peak error| <= FRAC")
    args = ap.parse_args(argv)
    if not (args.trace or args.metrics or args.audit):
        ap.error("need at least one of --trace / --metrics / --audit")
    rep = build_report(_load_json(args.trace), _load_jsonl(args.metrics),
                       _load_jsonl(args.audit), top=args.top)
    md = render_markdown(rep)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
        print(f"wrote {args.out}")
    else:
        print(md, end="")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rep, f, indent=1, default=str)
        print(f"wrote {args.json_out}")
    if args.check_peak_error is not None:
        err = check_peak_error(rep, args.check_peak_error)
        if err is not None:
            print(err, file=sys.stderr)
            return 2
        print(f"peak-error gate: OK (limit {args.check_peak_error})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
