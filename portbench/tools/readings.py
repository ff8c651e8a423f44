"""The readings a cell's limits are set from, on the card, in one process.

    python3 -m portbench.tools.readings --workload <cell> --seeds 1-12 \\
        [--control-seeds 1-3] [--fault-seeds 1-3] [--out FILE]

For each seed it runs the program's set-up as a benchmark run does (the
first three steps and the warm-up, with the late step where the cell has
one) and no window, frees it, and compares its readings with the
reference's (``portbench.compare.numbers``, and every leaf's gap): a
``program`` line.  On the
control seeds the reference in fp8 (``decoder.Precision("fp8")``) is put
in the program's place: a ``control`` line.  On the fault seeds two
faults are planted in the reference put in the program's place: each
step's loss and gradients over half of the batch (``half_batch``), and
one gradient leaf doubled where the step produces it (``double_leaf``).
A state left unchanged reads 1 on ``change`` by its definition and is
not run.  One JSON line a reading, to standard output and to ``--out``.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

DOUBLED = "blocks.0.attn.wq"


def seeds(text: str):
    out = []
    for part in text.split(","):
        if not part:
            continue
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def leaf_gaps(got: dict, want: dict) -> dict:
    """Every leaf's gap of ``grad`` and ``change``, and of the late
    step's where there is one."""
    from portbench import compare
    out = {key: compare.leaf_gaps(got[key], want[key])
           for key in ("grad", "change")}
    if got.get("late") is not None:
        for key in ("grad", "change"):
            out["late_" + key] = compare.leaf_gaps(got["late"][key],
                                                   want["late"][key])
    return out


def as_program(ref: dict, first: int = 3) -> dict:
    """The reference's readings in the program's place: the losses of the
    first steps, as a run keeps them."""
    out = {k: ref.get(k) for k in ("grad", "change", "late")}
    out["losses"] = ref["losses"][:first]
    return out


def one_seed(name, seed, device, control: bool, fault: bool, emit,
             **overrides):
    import torch
    from portbench import compare, harness
    _, cfgj, traffic, _ = harness.cell_files(name)
    cfgj = {**cfgj, **overrides.get("config_overrides", {})}
    traffic = {**traffic, **overrides.get("traffic_overrides", {})}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="portbench_") as ckpt:
        run = harness.Run(cfgj, traffic, seed, device, ckpt,
                          overrides.get("port_overrides"))
        first = run.first_steps()
        late = run.warm()
        harness.drop_trainer(run.tr)
        del run
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    t_prog = time.perf_counter() - t0
    prog = {k: first[k] for k in ("losses", "grad", "change")}
    prog["late"] = late
    args = (cfgj, traffic, seed, device, first["steps"],
            None if late is None else late["step"])
    moe = cfgj["family"] == "moe"
    t0 = time.perf_counter()
    ref = harness.reference(*args, routes=first.get("routes"))
    t_ref = time.perf_counter() - t0
    emit({"workload": name, "seed": seed, "kind": "program",
          "numbers": compare.numbers(prog, ref), "losses": prog["losses"],
          "ref_losses": ref["losses"], "program_s": t_prog,
          "reference_s": t_ref, "leaves": leaf_gaps(prog, ref),
          "late_step": None if late is None else
          {k: late[k] for k in ("step", "seq", "staged_bytes")}})

    def judged(kind, got, **extra):
        """``got`` (the reference put in the program's place) against the
        reference, which follows its routes in an expert model."""
        want = (harness.reference(*args, routes=got["routes"])
                if moe else ref)
        emit({"workload": name, "seed": seed, "kind": kind,
              "numbers": compare.numbers(as_program(got), want),
              "leaves": leaf_gaps(as_program(got), want), **extra})

    if control:
        ctl = harness.reference(*args, precision="fp8", record=moe)
        judged("control", ctl, losses=ctl["losses"])
    if fault:
        judged("half_batch", harness.reference(
            *args, rows=traffic["batch"] // 2, record=moe))
        judged("double_leaf", harness.reference(
            *args, double=DOUBLED, record=moe))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    device = torch.device(args.device)
    ctl, flt = set(seeds(args.control_seeds)), set(seeds(args.fault_seeds))

    def emit(row):
        if device.type == "cuda":
            row["card"] = torch.cuda.get_device_name(device)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for s in seeds(args.seeds):
        one_seed(args.workload, s, device, s in ctl, s in flt, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
