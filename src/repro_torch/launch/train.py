"""Training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-paper \
        --reduced --device cpu --steps 18 --budget-gib 0.01

Port of ``repro/launch/train.py``.  Chameleon
runs unless ``--no-chameleon``: ``--budget-gib`` is its HBM budget, and
``--stats-json`` dumps the runtime's ``stats()``, a metrics snapshot and
the audit tail on exit.  ``--policy-store-dir D`` persists adaptation
policies in ``D`` (``--no-policy-store`` drops the in-memory cache too);
``--adapt-mode async|speculative`` moves the variant search onto the
background worker (``repro_torch.adapt``).  ``--trace-out`` writes the
Chrome trace (with the overlap-efficiency and memory-ledger counter
tracks) and ``--audit-out`` streams the audit log as JSONL; both are
what ``python -m repro_torch.obs.validate`` and ``python -m
repro_torch.obs.report`` read.  ``--fault-plan plan.json`` arms a
``repro_torch.faults.FaultPlan`` (a chaos drill) before the trainer is
built and disarms it on exit, printing ``fault plan: fired=<n>`` and, when
the degradation ladder moved, ``ladder: rung=<name> descents=<n>
ascents=<n>``.  ``--autotune`` tunes the host tier's
kernels against the roofline at startup (``repro_torch.kernels.autotune``),
keeping the cache in ``--autotune-cache-dir``, by default
``<policy-store-dir>/autotune``.  ``--multihost`` joins the process group
torchrun's environment describes (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``; NCCL on the card, gloo on the CPU), and
each host then draws its own slice of the global batch; ``--mesh
single|multi`` builds the production mesh (256 or 512 ranks), which the
trainer keeps and trains unsharded, as the reference's does.  Besides the
reference's flags it takes
``--device`` (``cuda`` unless asked) and ``--attn-impl`` (``flash`` trains
every attention through the flash-attention forward and backward
kernels), as ``launch/serve.py`` does.  Weights are random, drawn on the
device from ``TrainConfig.seed``; batches are the reference's synthetic
tokens.  Every family trains: ``--arch mamba2-780m`` and ``--arch
zamba2-1.2b`` through the SSD-scan kernel and its backward on the card,
``--arch granite-moe-1b-a400m`` and ``--arch qwen3-moe-30b-a3b`` with the
moe load-balance loss (``aux``, reported beside ``xent``), with
``--no-chameleon``; ``--arch whisper-large-v3`` (encoder-decoder) and
``--arch llama-3.2-vision-90b --reduced`` (cross-attention into image
embeddings) with the trainer's second input, zero frames or patches as the
reference feeds them.  The full-width vision model does not fit one card's
AdamW state.  ``main(argv)`` returns the run's stats dict.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-paper")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-sized config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--budget-gib", type=float, default=16.0)
    ap.add_argument("--no-chameleon", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    ap.add_argument("--attn-impl", choices=["dense", "chunked", "flash"],
                    default=None,
                    help="attention implementation (default: the config's)")
    ap.add_argument("--metrics-out", default="",
                    help="append metrics-registry snapshots (JSONL) here "
                         "during training")
    ap.add_argument("--metrics-every", type=int, default=25,
                    help="snapshot cadence for --metrics-out (steps)")
    ap.add_argument("--policy-store-dir", default="",
                    help="persist adaptation policies here (fingerprint-"
                         "keyed; a restart with a warm store skips "
                         "GenPolicy for recurring sequences)")
    ap.add_argument("--no-policy-store", action="store_true",
                    help="disable the in-memory policy cache too")
    ap.add_argument("--autotune", action="store_true",
                    help="tune the host tier's kernels against the "
                         "memory-bandwidth roofline at startup and price "
                         "the achieved efficiency into policy generation "
                         "(repro_torch.kernels.autotune)")
    ap.add_argument("--autotune-cache-dir", default="",
                    help="persist tuned configs + bandwidth snapshot here "
                         "(schema-versioned autotune.json; a warm cache "
                         "means restart re-measures nothing).  Defaults "
                         "to <policy-store-dir>/autotune when a policy "
                         "store dir is set")
    ap.add_argument("--adapt-mode", choices=["inline", "async", "speculative"],
                    default="inline",
                    help="adaptation placement: inline runs the paper's "
                         "measured GenPolicy iterations; async moves the "
                         "variant search to a background worker (drift "
                         "never stalls an iteration); speculative also "
                         "pre-generates policies for recurring op "
                         "sequences")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON here on exit "
                         "(open in Perfetto / chrome://tracing)")
    ap.add_argument("--audit-out", default="",
                    help="stream the audit log (JSONL) here as it is "
                         "written")
    ap.add_argument("--fault-plan", default="",
                    help="arm a repro_torch.faults FaultPlan from this JSON "
                         "file (chaos drills: seeded fault schedules keyed "
                         "by site x iteration)")
    ap.add_argument("--multihost", action="store_true")
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--stats-json", default="",
                    help="dump the runtime's stats() dict, a metrics "
                         "snapshot and the audit tail as JSON here on exit")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    args = _parser().parse_args(argv)

    import repro_torch.configs as C
    from repro_torch import faults, obs
    from repro_torch.common.config import (AdaptConfig, AutotuneConfig,
                                           ChameleonConfig,
                                           PolicyStoreConfig, TrainConfig)
    from repro_torch.common.device import resolve_device
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.runtime.trainer import Trainer

    device = resolve_device(args.device)
    host_index, host_count = 0, 1
    if args.multihost:
        import torch.distributed as dist
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        host_index, host_count = dist.get_rank(), dist.get_world_size()
    mesh = None
    if args.mesh != "none":
        from repro_torch.launch.mesh import make_production_mesh
        try:
            mesh = make_production_mesh(multi_pod=(args.mesh == "multi"),
                                        device=device)
        except BaseException:
            _leave(args)
            raise
    cfg = C.get_reduced(args.arch) if args.reduced else C.get_config(args.arch)
    if args.attn_impl:
        cfg = cfg.replace(attn_impl=args.attn_impl)
    seq = args.seq or (128 if args.reduced else 4096)
    gb = args.global_batch or (8 if args.reduced else 256)
    tcfg = TrainConfig(steps=args.steps, checkpoint_dir=args.ckpt_dir,
                       checkpoint_every=max(args.steps // 4, 1),
                       eval_every=max(args.steps // 3, 1))
    at_dir = args.autotune_cache_dir
    if args.autotune and not at_dir and args.policy_store_dir:
        # warm-start colocation: tuned configs restart with the policies
        at_dir = os.path.join(args.policy_store_dir, "autotune")
    cham = ChameleonConfig(enabled=not args.no_chameleon,
                           hbm_budget_bytes=int(args.budget_gib * 2 ** 30),
                           policystore=PolicyStoreConfig(
                               enabled=not args.no_policy_store,
                               dir=args.policy_store_dir),
                           adapt=AdaptConfig(mode=args.adapt_mode),
                           autotune=AutotuneConfig(
                               enabled=args.autotune, cache_dir=at_dir))
    plan = (faults.FaultPlan.load(args.fault_plan) if args.fault_plan
            else None)
    data = SyntheticTokens(cfg.vocab_size, seq, gb, host_index=host_index,
                           host_count=host_count).start()
    if args.audit_out:
        # stream every audit event, not just the in-memory tail: the
        # evidence trail survives a crash
        obs.audit().attach_file(args.audit_out)
    if plan is not None:
        faults.arm(plan)
    tr = None
    try:
        tr = Trainer(cfg, tcfg, cham, mesh=mesh, data=data,
                     metrics_out=args.metrics_out or None,
                     metrics_every=args.metrics_every, device=device)
        if args.resume:
            tr.resume()
        rep = tr.train(args.steps)
        if rep.aux and any(rep.aux):
            print(f"xent {rep.xent[0]:.3f} -> {rep.xent[-1]:.3f}; "
                  f"aux {rep.aux[0]:.4f} -> {rep.aux[-1]:.4f}", flush=True)
        print(f"done: loss {rep.losses[0]:.3f} -> {rep.losses[-1]:.3f}; "
              f"skipped={rep.skipped_steps}; "
              f"checkpoints={len(rep.checkpoints)}", flush=True)
        out = {"arch": cfg.name, "device": str(device),
               "host": [host_index, host_count],
               "attn_impl": cfg.attn_impl, "steps": tr.step,
               "losses": rep.losses, "xent": rep.xent, "aux": rep.aux,
               "eval_losses": rep.eval_losses,
               "times": rep.times, "skipped_steps": rep.skipped_steps,
               "checkpoints": rep.checkpoints, "stages": rep.stages}
        if tr.rt is not None:
            _print_chameleon(tr, rep)
            out["applied"] = tr.rt.applied.fingerprint
            out["policystore"] = rep.policystore
            out["adapt"] = rep.adapt
            hm = tr.rt.hostmem
            out["autotune"] = (hm.autotuner.stats() if hm is not None
                               and hm.autotuner is not None else None)
        out["fault_fired"] = plan.total_fired() if plan is not None else 0
        lad = tr.rt.ladder if tr.rt is not None else None
        out["ladder"] = list(lad.transitions) if lad is not None else []
        return out
    finally:
        data.stop()
        if plan is not None:
            print(f"fault plan: fired={plan.total_fired()}", flush=True)
            faults.disarm()
        if tr is not None and tr.rt is not None:
            lad = tr.rt.ladder
            if lad is not None and lad.transitions:
                print(f"ladder: rung={lad.name} descents={lad.n_descents} "
                      f"ascents={lad.n_ascents}", flush=True)
            tr.rt.close()
        _export_obs(args, tr.rt if tr is not None else None)
        _leave(args)


def _leave(args) -> None:
    """Leave the process group ``--multihost`` joined."""
    if args.multihost:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _print_chameleon(tr, rep) -> None:
    """The reference's end-of-run summary: stages, applied policy, overlap
    efficiency, the memory ledger's scoreboard, the policy store."""
    from repro_torch import obs
    print(f"stages={sorted(set(rep.stages))}; "
          f"chameleon={tr.rt.stats()['applied'][:60]}", flush=True)
    ov = tr.rt.obs_stats()["overlap"]
    if ov["measured"]:
        print(f"overlap efficiency: last {ov['last']:.1%} / "
              f"mean {ov['mean']:.1%} over {ov['measured']} "
              f"transfer-active iterations "
              f"({ov['hidden_s'] * 1e3:.1f} of "
              f"{ov['transfer_s'] * 1e3:.1f} ms hidden)")
    sb = obs.ledger().scoreboard()
    if sb["n"]:
        print(f"memory ledger: {sb['n']} scored iterations, peak error "
              f"mean |e| {sb['mean_abs_error']:.2%} / "
              f"max |e| {sb['max_abs_error']:.2%}")
    ps = rep.policystore
    if ps is not None:
        t, s = ps["tiers"], ps["store"]
        print(f"policystore: {s['records']} records "
              f"({s['dir'] or 'memory-only'}); tiers "
              f"reuse={t['reuse']} warm={t['warm_start']} "
              f"regen={t['regen']} demoted={t['demoted']}; "
              f"genpolicy_steps={ps['genpolicy_steps_total']}; "
              f"adaptations={len(ps['adaptations'])}", flush=True)
    ad = rep.adapt
    if ad is not None and ad["mode"] != "inline":
        print(f"adapt[{ad['mode']}]: jobs={ad['jobs']} "
              f"published={ad['published']} installed={ad['installed']} "
              f"discarded={ad['discarded']} failed={ad['failed']} "
              f"spec_hits={ad['speculative_hits']}", flush=True)


def _export_obs(args, rt) -> None:
    """Flush the obs artifacts the flags asked for, as the reference does.
    Runs from the ``finally`` block, so a crashed run still leaves its
    trace behind.  ``rt`` is None with Chameleon off."""
    import json

    from repro_torch import obs
    if args.audit_out:
        obs.audit().detach_file()
    if args.metrics_out:
        obs.metrics().write_jsonl(args.metrics_out)
    if args.trace_out:
        counters = {"overlap_efficiency": [
            (h["t"], h["efficiency"]) for h in rt.overlap_history
            if h["efficiency"] is not None]} if rt is not None else {}
        counters.update(obs.ledger().counter_tracks())
        obs.export_chrome_trace(args.trace_out, obs.tracer(),
                                counters=counters,
                                meta={"arch": args.arch,
                                      "steps": args.steps})
        print(f"trace: {args.trace_out} "
              f"({obs.tracer().stats()['retained']} events)", flush=True)
    if args.stats_json and rt is not None:
        snap = {"runtime": rt.stats(),
                "obs_snapshot": obs.metrics().snapshot(),
                "audit_tail": obs.audit().tail(200)}
        with open(args.stats_json, "w") as f:
            json.dump(snap, f, indent=1, default=repr)
        print(f"stats: {args.stats_json}", flush=True)


if __name__ == "__main__":
    main()
