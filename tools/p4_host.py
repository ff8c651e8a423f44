#!/usr/bin/env python3
"""The executor's host time in the grad dispatch (ROADMAP P4), from one or
more checkouts in turns, on one NVIDIA GPU:

    python3 tools/p4_host.py TREE [TREE ...] [--out DIR]

For each TREE in the order given (say parent, change, change, parent: a
tree unpacked with ``git archive`` under ``build/``) and each sequence
length in SEQS, a child process imports that tree's ``chip_smoke.py`` and
``repro_torch``, takes the lowest budget a policy meets for the
train phase's model at 2 x seq tokens (``chip_smoke.exec_budget``, + 1%),
and trains STEPS steps with Chameleon on at that budget, then STEPS with
it off on the same batches (no eval).  Per step it reads the step and grad dispatch
ms, the execution's counters (``Execution.last``: the release ops, the
swap-ins' issue, the pack hooks, the host waits and the books), the pinned
slabs the host tier allocated, and the caching allocator's retries and
reserved peak.  Then STAGING_STEPS more steps with Chameleon on time the
staging's parts with wrappers (the pinned pool's ``alloc``, the engine's
``_enqueue`` and ``_d2h``, the executor's ``_stage``, and the pack hooks
that stage nothing).  The children's JSON goes to ``DIR/<i>_<seq>.json``
(default ``build/p4_host``); the card's name and power limit and one
summary line per child (medians over the Stable steps, against off's on
the same steps) are printed.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQS, STEPS, STAGING_STEPS = (2048, 3072), 24, 3
EXEC_KEYS = ("release_s", "prefetch_s", "pack_s", "hook_s", "copy_stall_s",
             "recompute_s", "wait_s", "host_waits", "host_wait_s",
             "released_late", "settle_s", "kept", "staged", "restored",
             "on_demand", "prefetched", "forced_retires")


def p50(xs):
    xs = sorted(x for x in xs if x is not None)
    return xs[len(xs) // 2] if xs else None


class _Timers:
    """Wall seconds and calls of wrapped methods, reset per step."""

    def __init__(self):
        self.s, self.n = {}, {}

    def wrap(self, owner, name, key=None, when=None):
        fn = getattr(owner, name)
        key = key or name

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if when is None or when(out):
                self.s[key] = self.s.get(key, 0.0) + time.perf_counter() - t0
                self.n[key] = self.n.get(key, 0) + 1
            return out
        setattr(owner, name, timed)

    def take(self):
        out = {k: [self.s[k] * 1e3, self.n[k]] for k in self.s}
        self.s, self.n = {}, {}
        return out


def child(tree: str, seq: int, path: str) -> None:
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    os.chdir(tree)
    import gc
    import torch
    import chip_smoke as cs
    import repro_torch.configs as C
    from repro_torch.common.config import ChameleonConfig
    from repro_torch.core import executor as X
    from repro_torch.hostmem import engine as E
    from repro_torch.hostmem import pool as PL
    from repro_torch.kernels import _build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    torch.zeros(1, device=device)
    cfg = C.get_config("llama2-paper").replace(num_layers=cs.TRAIN_LAYERS,
                                               attn_impl="flash")
    budget, _ = cs.exec_budget(device, cfg, seq=seq, phase="p4_host")

    def reading():
        m = torch.cuda.memory_stats(device)
        torch.cuda.reset_peak_memory_stats(device)
        return (m.get("num_alloc_retries", 0),
                m.get("reserved_bytes.all.peak", 0),
                m.get("allocated_bytes.all.peak", 0))

    def run(on: bool, n: int, timers=None):
        tr = cs.exec_train(device, cfg, ChameleonConfig(
            enabled=on, hbm_budget_bytes=budget), seq=seq, eval_every=0)
        rows, r0 = [], reading()
        for i in range(n + (STAGING_STEPS if timers else 0)):
            if timers is not None and i == n:
                timers.install()
            pool = tr.rt.hostmem.pool if on else None
            s0 = pool.slab_allocs if pool else 0
            tr.train(1)
            r1 = reading()
            row = {"step": i, "step_ms": tr.report.times[-1] * 1e3,
                   "grad_ms": tr.report.grad_times[-1] * 1e3,
                   "loss": tr.report.losses[-1],
                   "alloc_retries": r1[0] - r0[0], "reserved_peak": r1[1],
                   "allocated_peak": r1[2]}
            r0 = r1
            if on:
                ex = tr.rt._last_dispatch.execution
                last = ex.last if ex is not None else {}
                row.update(stage=tr.report.stages[-1],
                           slab_allocs=pool.slab_allocs - s0,
                           policy=tr.rt._last_dispatch.applied.fingerprint,
                           exec={k: last.get(k) for k in EXEC_KEYS})
                if timers is not None and i >= n:
                    row["staging"] = timers.t.take()
            rows.append(row)
        cs.drop_trainer(tr)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        return rows

    class Staging:
        def __init__(self):
            self.t = _Timers()

        def install(self):
            t = self.t
            t.wrap(PL.PinnedSlabPool, "alloc")
            t.wrap(E.TransferEngine, "_enqueue")
            t.wrap(E.TransferEngine, "_d2h")
            t.wrap(X.Execution, "_stage")
            t.wrap(X.Execution, "_pack", key="pack_unstaged",
                   when=lambda out: isinstance(out, torch.Tensor))
            t.take()

    on = run(True, STEPS, Staging())
    off = run(False, STEPS)
    json.dump({"tree": tree, "seq": seq, "budget": budget,
               "card": cs.nvidia_smi_line(), "on": on, "off": off},
              open(path, "w"))


def summary(d: dict) -> dict:
    on, off = d["on"], d["off"]
    stable = [r for r in on[:len(off)] if r.get("stage") == "Stable"]
    idx = [r["step"] for r in stable]
    ex = [r["exec"] for r in stable]

    def med(k, scale=1e3):
        return p50([e[k] * scale if e.get(k) is not None else None
                    for e in ex])
    staging = {}
    for r in on[len(off):]:
        for k, (ms, n) in r.get("staging", {}).items():
            staging.setdefault(k, []).append([round(ms, 3), n])
    return {
        "tree": d["tree"], "seq": d["seq"], "stable_steps": len(idx),
        "policies": sorted({r["policy"][:48] for r in stable}),
        "step_ms": p50([r["step_ms"] for r in stable]),
        "step_ms_off": p50([off[i]["step_ms"] for i in idx]),
        "grad_ms": p50([r["grad_ms"] for r in stable]),
        "grad_ms_off": p50([off[i]["grad_ms"] for i in idx]),
        "release_ms": med("release_s"), "prefetch_ms": med("prefetch_s"),
        "pack_ms": med("pack_s"), "hook_ms": med("hook_s"),
        "copy_stall_ms": med("copy_stall_s"),
        "settle_ms": med("settle_s"), "host_waits": med("host_waits", 1),
        "host_wait_ms": med("host_wait_s"),
        "released_late": med("released_late", 1),
        "staged": med("staged", 1), "restored": med("restored", 1),
        "kept": med("kept", 1),
        "slab_allocs": sum(r["slab_allocs"] for r in stable),
        "alloc_retries": sum(r["alloc_retries"] for r in stable),
        "alloc_retries_off": sum(off[i]["alloc_retries"] for i in idx),
        "reserved_peak": max((r["reserved_peak"] for r in stable), default=0),
        "reserved_peak_off": max((off[i]["reserved_peak"] for i in idx),
                                 default=0),
        "allocated_peak": max((r["allocated_peak"] for r in stable),
                              default=0),
        "allocated_peak_off": max((off[i]["allocated_peak"] for i in idx),
                                  default=0),
        "losses_equal": [r["loss"] for r in on[:len(off)]]
        == [r["loss"] for r in off],
        "staging_ms_calls": staging}


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        child(argv[1], int(argv[2]), argv[3])
        return 0
    out = os.path.join(ROOT, "build", "p4_host")
    trees = []
    it = iter(argv)
    for a in it:
        if a == "--out":
            out = os.path.abspath(next(it))   # children run in their tree
        else:
            trees.append(os.path.abspath(a))
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    os.makedirs(out, exist_ok=True)
    sys.path[:0] = [ROOT]
    import chip_smoke as cs
    print(cs.nvidia_smi_line(), flush=True)
    rc = 0
    for i, tree in enumerate(trees):
        for seq in SEQS:
            path = os.path.join(out, f"{i}_{seq}.json")
            t0 = time.time()
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--child", tree, str(seq), path])
            if r.returncode != 0:
                print(f"p4_host: {tree} at {seq} failed ({r.returncode})",
                      flush=True)
                rc = 1
                continue
            with open(path) as f:
                row = summary(json.load(f))
            row["seconds"] = round(time.time() - t0, 1)
            print(json.dumps(row), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
