"""One run of one cell: set-up, the measured window, the traced steps and
the comparison with the plain reference.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness finds ``portbench/configs/<config>.json``,
``portbench/traffic/<traffic>.json`` and the cell's limits in
``portbench/cells/<cell>.json`` by those names, and every metric's reader
in ``portbench/metrics/<metric>.py``.

The run, on one card:

  1. Set-up: the program's ``Trainer`` (``repro_torch.runtime.trainer``),
     with Chameleon as the traffic file sets it, is built once; the seed's
     weights (``portbench.weights``) are copied into its parameters and
     master copies.  Its first three steps, through ``Trainer.train(1)``
     and the traffic's feed, give the readings the reference follows: each
     step's loss, every leaf's first clipped gradient (its AdamW ``m``
     after one step, over 1 - b1) and every leaf's change after three
     steps (its f32 master against the seed's weights).  Then steps go on
     along the schedule until every bucket has run (and, with Chameleon,
     reached Stable once), up to the next bucket boundary.  Where the
     window runs what the first three steps do not (a longer bucket, a
     swap policy), one step of set-up that runs it is the late step: the
     second step of a visit of the longest bucket, with Chameleon the
     first such step that runs its installed policy with swaps.  Of it
     the loss, the norms of the gradients the optimizer got and the
     change of every leaf from the seed's weights after its update are
     kept.
  2. The window: ``Trainer.train(1)`` step after step for ``--seconds``,
     each timed by the host's clock (every step ends in a device sync);
     the allocator's peak is reset at its start.
  3. With ``--trace 1``: ``trace_steps`` more steps under
     ``torch.profiler``, each apply dispatch inside a
     ``record_function`` range (``devtrace.APPLY``) that ends in a device
     sync (the trainer syncs there too).
  4. The program is freed, and the reference (``portbench.reference``,
     float32, TF32 off) follows every step from the seed's weights on the
     same batches, through the late step where there is one, and gives
     the same readings.  ``portbench.compare`` judges the gaps against
     the cell's limits.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Mapping, Optional

import torch

from portbench import compare, devtrace, feed, weights
from portbench.reference import train as ref_train

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# the cosine schedule's length: longer than any run, so every step of a
# run is on the same slope for every seed
TOTAL_STEPS = 100_000
# steps each bucket runs before the window may start, beside Stable
WARM_STEPS = 2
WARM_PERIODS = 8                      # Stable must come within these
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load(rel: str) -> dict:
    with open(HERE / rel) as f:
        return json.load(f)


def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_files(name: str, benchmark: Optional[dict] = None):
    """(workload entry, configuration, traffic, limits) of a cell."""
    b = benchmark or bench()
    entry = next((w for w in b["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return (entry, load(f"configs/{entry['config']}.json"),
            load(f"traffic/{entry['traffic']}.json"),
            load(f"cells/{name}.json"))


def metrics_for(name: str, benchmark: dict, kind: str) -> List[dict]:
    """The cell's metrics of ``end_to_end`` or ``per_layer``."""
    return [m for m in benchmark[kind]
            if "workloads" not in m or name in m["workloads"]]


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    return importlib.import_module(f"portbench.metrics.{metric}").read


def train_settings(traffic: Mapping) -> dict:
    t = traffic["train"]
    return {"learning_rate": float(t["learning_rate"]),
            "warmup_steps": int(t["warmup_steps"]),
            "total_steps": TOTAL_STEPS,
            "weight_decay": float(t.get("weight_decay", 0.1)),
            "grad_clip": float(t.get("grad_clip", 1.0))}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# --------------------------------------------------------------- program
def port_config(cfgj: Mapping, overrides: Optional[Mapping] = None):
    from repro_torch.configs import get_config
    port = cfgj["port"]
    return get_config(port["arch"]).replace(**{**port["replace"],
                                               **(overrides or {})})


def build_trainer(cfgj, traffic, fd: feed.Feed, device, ckpt_dir: str,
                  port_overrides=None):
    from repro_torch.common.config import (AdaptConfig, ChameleonConfig,
                                           PolicyStoreConfig, TrainConfig)
    from repro_torch.runtime.trainer import Trainer
    settings = train_settings(traffic)
    tcfg = TrainConfig(steps=TOTAL_STEPS,
                       learning_rate=settings["learning_rate"],
                       warmup_steps=settings["warmup_steps"],
                       weight_decay=settings["weight_decay"],
                       grad_clip=settings["grad_clip"], eval_every=0,
                       checkpoint_every=0, checkpoint_dir=ckpt_dir)
    ch = traffic["chameleon"]
    cham, mode = None, None
    if ch["enabled"]:
        if not ch.get("hbm_budget_bytes"):
            raise SystemExit(f"traffic {traffic['name']}: Chameleon is on "
                             "and no hbm_budget_bytes is set")
        mode = ch["placement"]
        cham = ChameleonConfig(
            enabled=True, hbm_budget_bytes=int(ch["hbm_budget_bytes"]),
            policystore=PolicyStoreConfig(enabled=ch["policy_store"]
                                          == "memory"),
            adapt=AdaptConfig(mode=mode))
    cfg = port_config(cfgj, port_overrides)
    return Trainer(cfg, tcfg, cham, data=fd, eval_data=fd, device=device,
                   adapt_mode=mode)


def drop_trainer(tr) -> None:
    """Free the trainer: the metrics registry's providers hold it until
    they are unregistered, its runtime's worker until it is closed."""
    from repro_torch import obs
    for name in ("runtime", "hostmem", "memory"):
        obs.metrics().unregister_provider(name)
    if tr.rt is not None:
        tr.rt.close()
    for o in (obs.tracer(), obs.ledger(), obs.metrics()):
        o.clear()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def around_apply(tr, around):
    """For the block's length the trainer's apply step calls
    ``around(inner, *args)``, where ``inner`` is the apply step."""
    disp = tr._apply
    owner, attr = ((disp, "fn") if hasattr(disp, "fn")
                   else (tr, "_apply"))
    inner = getattr(owner, attr)
    setattr(owner, attr, lambda *args: around(inner, *args))
    try:
        yield
    finally:
        setattr(owner, attr, inner)


def execution_of(tr):
    """The executor's execution that the last grad dispatch ran under, or
    None (Chameleon off, or a plain policy)."""
    if tr.rt is None:
        return None
    d = getattr(tr.rt, "_last_dispatch", None)
    return None if d is None else d.execution


class Run:
    """The program's side of one run."""

    def __init__(self, cfgj, traffic, seed: int, device, ckpt_dir: str,
                 port_overrides=None):
        self.cfgj, self.traffic, self.seed = cfgj, traffic, seed
        self.device = device
        self.schedule = feed.Schedule(traffic)
        self.feed = feed.Feed(self.schedule, cfgj["vocab_size"], seed)
        self.tr = build_trainer(cfgj, traffic, self.feed, device, ckpt_dir,
                                port_overrides)
        master = self.tr.opt_state.master
        weights.load_into(self.tr.model, master, cfgj, seed)
        self.k = 0                         # the next step of the schedule

    def step(self) -> dict:
        """One step of the schedule through ``Trainer.train(1)``."""
        self.feed.step = self.k
        t0 = time.perf_counter()
        self.tr.train(1)
        wall = time.perf_counter() - t0
        rep = self.tr.report
        row = {"step": self.k, "bucket": self.schedule.bucket(self.k),
               "batch": self.schedule.batch, "seq": self.schedule.seq(self.k),
               "wall_s": wall, "time_s": rep.times[-1],
               "grad_s": rep.grad_times[-1], "loss": rep.losses[-1],
               "skipped": bool(rep.skipped_steps
                               and rep.skipped_steps[-1] == self.k),
               "stage": rep.stages[-1] if rep.stages else None}
        ex = execution_of(self.tr)
        if ex is not None:                 # the executor's counters
            row["exec"] = {k: v for k, v in ex.last.items()
                           if isinstance(v, (int, float))}
        self.k += 1
        return row

    # readings of the first three steps
    def first_steps(self) -> dict:
        """The first three steps and their readings; for an expert model
        also the experts each layer's router chose in each step (the
        program's ``models.moe.route``, wrapped for these steps only),
        which the reference follows and judges."""
        from repro_torch.models import moe as port_moe
        from repro_torch.optim.adamw import B1
        calls: List[list] = []
        real = port_moe.route

        def recording(probs, k):
            gate, idx = real(probs, k)
            calls[-1].append(idx.detach().clone())
            return gate, idx

        rows = []
        if self.cfgj["family"] == "moe":
            port_moe.route = recording
        try:
            for k in range(3):
                calls.append([])
                rows.append(self.step())
                if k == 0:
                    grad = {n: g / (1 - B1) for n, g in
                            ref_train.norms(self.tr.opt_state.m).items()}
        finally:
            port_moe.route = real
        out = {"losses": [r["loss"] for r in rows], "grad": grad,
               "change": self.change(), "steps": [r["step"] for r in rows],
               "walls": [r["wall_s"] for r in rows]}
        if self.cfgj["family"] == "moe":
            out["routes"] = [dict(enumerate(c)) for c in calls]
        return out

    def change(self) -> dict:
        """Every leaf's norm of its change from the seed's weights (the
        f32 master where the program keeps one)."""
        master = (self.tr.opt_state.master
                  or dict(self.tr.model.named_parameters()))
        with torch.no_grad():
            return {s.name: float(torch.linalg.vector_norm(
                        master[s.name] - v.float()))
                    for s, v in weights.values(self.cfgj, self.seed,
                                               self.device)}

    def warm(self) -> Optional[dict]:
        """Steps until every bucket has run WARM_STEPS steps and, with
        Chameleon, reached Stable, and until the late step has run
        (``late_step``) where the cell has one, then to the next bucket
        boundary.  Returns the late step, or None."""
        n = len(self.schedule.buckets)
        cham = self.tr.rt is not None
        wants_late = cham or n > 1
        longest = max(range(n), key=lambda b: self.schedule.buckets[b])
        ran, stable = [0] * n, [not cham] * n
        for r in range(self.k):
            ran[self.schedule.bucket(r)] += 1
        late, stages = None, []
        limit = WARM_PERIODS * n * self.schedule.period
        while not (min(ran) >= WARM_STEPS and all(stable)
                   and (late is not None or not wants_late)) \
                or self.k % self.schedule.period:
            if self.k >= limit:
                raise RuntimeError(
                    f"no late step in the longest bucket (with Chameleon: "
                    f"no Stable step with swaps) within {limit} steps: "
                    f"{stages[-24:]}")
            if (wants_late and late is None and self.k >= 3
                    and self.schedule.bucket(self.k) == longest
                    and self.schedule.bucket(self.k - 1) == longest
                    and (not cham
                         or self.tr.rt.machine.stage.value == "Stable")):
                row, late = self.late_step()
            else:
                row = self.step()
            stages.append((row["step"], row["stage"]))
            ran[row["bucket"]] += 1
            if row["stage"] == "Stable":
                stable[row["bucket"]] = True
        self.warm_stages = stages
        return late

    def runtime_stats(self) -> Optional[dict]:
        """Chameleon's runtime's ``stats()``, or None with it off."""
        return None if self.tr.rt is None else self.tr.rt.stats()

    def window(self, seconds: float) -> dict:
        sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        before = self.runtime_stats()
        rows = []
        t0 = time.perf_counter()
        while True:
            rows.append(self.step())
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        runtime = (None if before is None else
                   {"before": before, "after": self.runtime_stats()})
        return {"steps": rows, "window_s": window_s, "peak_bytes": peak,
                "runtime": runtime}

    def traced(self, n_steps: int) -> dict:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        rows = []

        def ranged(inner, *args):
            # the grad dispatch ended in a sync: the device is idle when
            # the range opens, and every kernel of the apply ends in it
            with record_function(devtrace.APPLY):
                out = inner(*args)
                sync(self.device)
            return out

        sync(self.device)
        with profile(activities=acts) as prof, around_apply(self.tr, ranged):
            t0 = time.perf_counter()
            for _ in range(n_steps):
                rows.append(self.step())
            sync(self.device)
            window_s = time.perf_counter() - t0
        out = devtrace.read(prof, window_s)
        out["steps"] = rows
        return out

    def late_step(self):
        """One step with the norms of the gradients the optimizer got
        (clipped in place by the apply step) and every leaf's change
        after it: (its row, the late step), or (its row, None) where
        Chameleon is on and the step did not run a policy that moved
        bytes."""
        got = {}

        def keep(inner, model, opt_state, grads):
            out = inner(model, opt_state, grads)
            got["grad"] = ref_train.norms(grads)
            return out

        with around_apply(self.tr, keep):
            row = self.step()
        swapped = row.get("exec", {}).get("staged_bytes", 0)
        if "grad" not in got or (self.tr.rt is not None and (
                row["stage"] != "Stable" or swapped <= 0)):
            return row, None
        return row, {"loss": row["loss"], "grad": got["grad"],
                     "change": self.change(), "step": row["step"],
                     "seq": row["seq"], "staged_bytes": swapped}


# -------------------------------------------------------------- reference
def followable(cfgj, sched: feed.Schedule, steps: List[int], routes,
               rows: Optional[int] = None) -> bool:
    """Do ``routes`` give every expert layer of every step one (tokens,
    experts a token) choice?"""
    if routes is None or len(routes) != len(steps):
        return False
    L, K = cfgj["num_hidden_layers"], cfgj["num_experts_per_tok"]
    for k, r in zip(steps, routes):
        T = (rows or sched.batch) * sched.seq(k)
        if sorted(r) != list(range(L)) or any(
                tuple(x.shape) != (T, K) for x in r.values()):
            return False
    return True


def reference(cfgj, traffic, seed: int, device, first_steps: List[int],
              late_step: Optional[int] = None, precision: str = "f32",
              rows: Optional[int] = None, double: Optional[str] = None,
              routes=None, record: bool = False) -> dict:
    """The reference's readings, in float32 with TF32 off: it follows
    every step from the seed's weights through the first steps and, where
    ``late_step`` is given, on through it.  An expert model follows
    ``routes`` in the first steps (the program's choices,
    ``Run.first_steps``) and judges them (``route_gap``; None where they
    are not one choice a token and layer); later steps route by
    themselves.  For the readings tool: ``precision`` "fp8" is the
    control, ``rows`` and ``double`` plant faults
    (``reference.train.grads``) in every step, ``record`` returns the
    reference's own routes."""
    from portbench.reference import decoder
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prec = decoder.Precision(precision)
    sched = feed.Schedule(traffic)
    settings = train_settings(traffic)
    if first_steps != list(range(len(first_steps))):
        raise ValueError(f"the first steps {first_steps} do not start at 0")
    last = len(first_steps) - 1
    steps = list(range((last if late_step is None else late_step) + 1))

    def dev_batch(step):
        tokens, labels = feed.batch(sched, cfgj["vocab_size"], seed, step)
        return (torch.from_numpy(tokens).to(device),
                torch.from_numpy(labels).to(device))

    def change_of(p):
        with torch.no_grad():
            return {s.name: float(torch.linalg.vector_norm(
                        p[s.name] - v.float()))
                    for s, v in weights.values(cfgj, seed, device)}

    follow = (routes if followable(cfgj, sched, first_steps, routes, rows)
              else None)
    if follow is not None:
        follow = list(follow) + [None] * (len(steps) - len(follow))
    marks = (0,) if late_step is None else (0, late_step)
    p = {s.name: v.float() for s, v in weights.values(cfgj, seed, device)}
    res = ref_train.run(cfgj, p, [dev_batch(k) for k in steps], settings,
                        prec, rows, double, follow, record, grad_at=marks,
                        change_at=(last,) + marks[1:], change_of=change_of)
    del p
    out = {"losses": res["losses"], "grad": res["grads"][0],
           "change": res["changes"][last]}
    if late_step is not None:
        out["late"] = {"loss": res["losses"][late_step],
                       "grad": res["grads"][late_step],
                       "change": res["changes"][late_step]}
    if routes is not None:
        out["route_gap"] = None if follow is None else res["route_gap"]
    if record:
        out["routes"] = res["routes"][:len(first_steps)]
    return out


# ------------------------------------------------------------------ a run
def device_info(device, count: int = 1) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count}


def warm_profiler(device) -> None:
    """A first, short profile: the card's profiler can miss kernel
    records in a process's first profiles."""
    from torch.profiler import ProfilerActivity, profile
    if device.type != "cuda":
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        x = torch.ones(1 << 20, device=device)
        for _ in range(4):
            x = x * 1.0001
        torch.cuda.synchronize(device)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, benchmark: Optional[dict] = None,
             port_overrides=None, config_overrides=None,
             traffic_overrides=None, limits=None) -> dict:
    """One run of cell ``name``: the result object of the contract, with
    ``checks`` (each number compared and its limit) last.  The overrides
    are for the CPU tests' small sizes."""
    b = benchmark or bench()
    entry, cfgj, traffic, cellj = cell_files(name, b)
    cfgj = {**cfgj, **(config_overrides or {})}
    traffic = {**traffic, **(traffic_overrides or {})}
    limits = limits if limits is not None else cellj["limits"]
    marks = {"started_s": time.perf_counter() - t_start}
    with tempfile.TemporaryDirectory(prefix="portbench_") as ckpt_dir:
        run = Run(cfgj, traffic, seed, device, ckpt_dir, port_overrides)
        marks["trainer_s"] = time.perf_counter() - t_start
        if trace:
            warm_profiler(device)
        first = run.first_steps()
        marks["first_steps_s"] = time.perf_counter() - t_start
        marks["first_step_walls_s"] = first["walls"]
        late = run.warm()
        setup_s = time.perf_counter() - t_start
        marks["warm_steps"] = run.k
        marks["first_stable"] = {
            b: next((k for k, st in run.warm_stages
                     if st == "Stable" and run.schedule.bucket(k) == b), None)
            for b in range(len(run.schedule.buckets))}
        win = run.window(seconds)
        tr_out = run.traced(int(traffic["trace_steps"])) if trace else None
        drop_trainer(run.tr)
        del run
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference(cfgj, traffic, seed, device, first["steps"],
                    None if late is None else late["step"],
                    routes=first.get("routes"))
    ref_s = time.perf_counter() - t_ref
    prog = {"losses": first["losses"], "grad": first["grad"],
            "change": first["change"], "late": late}
    nums = compare.numbers(prog, ref)
    correct, checks = compare.judge(nums, limits)
    rec = {"cfg": cfgj, "traffic": traffic, "setup_s": setup_s,
           "steps": win["steps"], "window_s": win["window_s"],
           "peak_bytes": win["peak_bytes"], "runtime": win["runtime"],
           "trace": tr_out}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(name, b, kind):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_info(device, entry["chips"])
    dev["memory_peak_bytes"] = win["peak_bytes"]
    out = {"correct": correct, "attempted": len(win["steps"]),
           "failed": sum(r["skipped"] for r in win["steps"]),
           "metrics": metrics, "device": dev}
    if tr_out is not None:
        dev["busy_s"] = tr_out["busy_s"]
        dev["window_s"] = tr_out["window_s"]
        out["breakdown"] = tr_out["breakdown"]
        nums["device_s_by_kind"] = tr_out["by_kind"]
        nums["apply_device_s"] = tr_out["apply_s"]
        nums["apply_host_s"] = sum(r["time_s"] - r["grad_s"]
                                   for r in tr_out["steps"] if not r["skipped"])
    out["detail"] = {**nums, "setup": marks, "reference_s": ref_s}
    if late is not None:
        out["detail"]["late_step"] = {k: late[k] for k in
                                      ("step", "seq", "staged_bytes")}
    out["checks"] = checks
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: "
                         f"{found}")
    return out
