"""Dry run: trace every (arch × shape × mesh) cell on the production mesh —
16×16 single-pod and 2×16×16 multi-pod — on fake tensors, and emit the
memory peak per chip and the roofline terms to ``artifacts/dryrun_torch``.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles each
cell for 512 host devices and reads XLA's memory analysis.  Here everything
runs in one process: a fake process group the size of the mesh
(``torch.testing._internal.distributed.fake_pg.FakeStore``, backend
``"fake"``; internal API, so its absence raises, naming it), a
``DeviceMesh`` over it, and the rank-0 share of the sharded step
(``distributed.steps``) run once on ``FakeTensorMode`` tensors of the
cell's device — ``cuda`` where torch is built for it, so the card's path
(K1's fake kernels, K3's and K4's shape rules) is what is traced; a torch
built without CUDA cannot run a backward on fake ``cuda`` tensors, so
there the cell traces ``cpu`` (the record names its device).  Nothing is
allocated.

  * Memory: ``core.profiler.profile_step`` records the step's storages
    (their birth and their death by weakref, which fires for fake storages
    as for real ones) over a static base, this chip's resident state (its
    parameters as held at rest and its optimizer state); ``peak_per_chip``
    is the timeline's peak plus the most weight bytes gathered at use at
    once (``gathered_peak_bytes``: a gather refills a parameter's own
    storage, which the profile does not see born).  One rank's local step
    is traced, so the profile is per chip as it stands
    (``_per_chip_profile`` only sets the static base), where the
    reference rescales a global-shape profile by each site's sharding.
  * Roofline: ``launch.roofline.step_cost`` over the same step.
  * ``departures``: where the cell's layout holds or runs more per chip
    than the reference's: a block whose weights a rank gathers whole for
    compute (none under the default rules: attention splits by head runs
    even where the model dim does not divide the query heads), and
    Mamba-2's B / C columns whole on every rank where the model dim does
    not divide 2 x ``ssm_state`` (their bytes); with any,
    ``comparable_to_reference`` is false and the cell's memory and
    roofline numbers are the port's own, not the reference's.  The
    collective bytes (``roofline.collectives``) include the attention
    weights' gathers at use and their gradients' reduce-scatters, and
    the B / C all-gathers and their backward's reduce-scatters.
  * ``fits_hbm`` (the reference's ``fits_16g``) compares the peak with the
    port's ``ChameleonConfig.hbm_budget_bytes``, recorded beside it;
    ``device_peak_est`` is the reference's ``device_peak_est_tpu``.

Policy modes for train cells:
  none / raw   plain autograd (save everything; eager has no difference)
  chameleon    paper-faithful: profile the baseline step, generate the swap
               policy for this chip's budget (Algo 2), lower it to sites
  remat        every block recomputed in the backward (torch.utils.checkpoint)
  offload_all  WarmUp-stage conservative policy (every candidate site)
  offload_inputs  only the per-layer residual snapshot (``ln_in``)
A swap policy is not executed on fake tensors (the host tier moves real
bytes): as the reference does on its CPU backend, its effect on the device
peak is analytic, the peak less the bytes it offloads
(``device_peak_est``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama2_paper \\
        --shape train_4k --mesh single --policy none
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Optional

import torch

import repro_torch.configs as C
from repro_torch.common.config import (SHAPES_BY_NAME, ChameleonConfig,
                                       ShapeConfig, TrainConfig)
from repro_torch.core.executor import Executor
from repro_torch.core.memtrace import build_timeline
from repro_torch.core.policy import ChameleonOOMError, generate_policy
from repro_torch.core.profiler import profile_step
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import steps as S
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import mesh_config

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")


def _zero_stage(arch: str) -> int:
    return 3 if arch == "llama3_2_vision_90b" else 2


def _estimate_t_iter(cfg, shape, chips: int) -> float:
    tokens = shape.global_batch * shape.seq_len
    mf = R.model_flops_train(cfg.active_param_count(), tokens)
    return mf / (chips * R.PEAK_FLOPS * 0.4)   # assume 40% MFU


def default_device() -> str:
    """``cuda`` where torch is built for it (module doc), else ``cpu``."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


@contextlib.contextmanager
def fake_world(chips: int):
    """A fake default process group of ``chips`` ranks (this process is
    rank 0) for the duration."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch.testing._internal.distributed.fake_pg."
            "FakeStore (the fake process group), which this torch lacks"
        ) from e
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "destroy the current one first")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=chips)
    try:
        yield
    finally:
        shd.clear_groups()
        dist.destroy_process_group()


def _resident_bytes(*trees) -> int:
    """Bytes of the distinct storages of the tensors in ``trees``."""
    seen = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            t = x.to_local() if hasattr(x, "to_local") else x
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    for t in trees:
        walk(t)
    return int(sum(seen.values()))


def _departures(sm) -> dict:
    """Where this cell's layout computes or holds more per chip than the
    reference's (``distributed.steps``' module doc): the blocks whose
    weights a rank gathers whole for compute with their bytes, and the
    bytes of Mamba-2's B / C runs held whole on every rank (where the model
    dim does not divide them).  A cell with any is not comparable to the
    reference's memory and roofline numbers."""
    dep = sm.departures()
    whole = dep["computed_whole"]
    return {"computed_whole_over_model": sorted(whole),
            "computed_whole_over_model_bytes": int(sum(whole.values())),
            "ssm_bc_whole_bytes": dep["ssm_bc_bytes"],
            "comparable_to_reference": not (whole or dep["ssm_bc_bytes"])}


def _per_chip_profile(prof, static_bytes: int):
    """The traced step is this chip's own, so only the static base (this
    chip's resident state) is set."""
    prof.static_bytes = int(static_bytes)
    return prof


@contextlib.contextmanager
def _full_remat():
    """Every block of the stack recomputed in the backward: the reference's
    ``full_remat`` policy, each layer under ``torch.utils.checkpoint``."""
    import torch.utils.checkpoint as ckpt
    from repro_torch.models import transformer as T
    saved = (T.dense_block, T.ssm_block)

    def wrap(fn):
        def run(*a, **kw):
            return ckpt.checkpoint(fn, *a, use_reentrant=False, **kw)
        return run

    T.dense_block, T.ssm_block = wrap(saved[0]), wrap(saved[1])
    try:
        yield
    finally:
        T.dense_block, T.ssm_block = saved


def _policy_info(mode: str, prof, budget: int) -> dict:
    """What the swap policy of ``mode`` moves, from the baseline profile."""
    ex = Executor(ChameleonConfig(hbm_budget_bytes=budget))
    tl = build_timeline(prof)
    info = {"policy": mode, "baseline_peak_per_chip": int(tl.peak),
            "static_per_chip": int(prof.static_bytes),
            "budget_per_chip": int(budget)}
    if mode == "chameleon":
        if tl.peak <= budget:
            return {**info, "policy": "fits-baseline"}
        ccfg = ChameleonConfig(hbm_budget_bytes=budget)
        try:
            swap = generate_policy(prof, ccfg, budget, timeline=tl)
        except ChameleonOOMError as e:
            mode = "offload_all"
            info.update(policy="offload_all-fallback", error=str(e))
        else:
            applied = ex.lower(swap, prof)
            info.update(summary=swap.summary(),
                        offload_sites=sorted(applied.offload),
                        projected_peak_per_chip=int(swap.projected_peak),
                        stall_s=swap.stall_time,
                        swapped_bytes_per_chip=int(swap.swapped_bytes))
            return info
    sites = ({"ln_in"} if mode == "offload_inputs"
             else ex.conservative(prof).offload)
    info["offload_sites"] = sorted(sites)
    info["swapped_bytes_per_chip"] = int(sum(
        t.nbytes for t in prof.candidates if t.site in sites))
    return info


def _local_batch(batch, mesh, rules, B: int):
    """This chip's rows (the reference's ``_batch_axes``: a batch smaller
    than the batch dims is replicated)."""
    with shd.use_mesh(mesh, rules):
        dims = shd.resolve_axes("batch", mesh)
    n = shd.coordinate(mesh, dims)[1] if dims else 1
    if B < n or B % n:
        return dict(batch), B
    return S.shard_batch(batch, mesh, rules), B // n


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             policy_mode: str = "chameleon",
             out_dir: Optional[str] = None, verbose: bool = True,
             mesh=None, cfg=None, shape=None,
             rules_name: str = "default", *, device: Optional[str] = None,
             mesh_shape=None, budget_bytes: Optional[int] = None,
             device_kind: Optional[str] = None) -> dict:
    """One cell.  ``mesh``/``cfg``/``shape`` override the production ones
    (``mesh`` a mesh over the caller's fake group); without ``mesh`` a
    fake group and mesh of the production shape (or ``mesh_shape``, a
    ``MeshConfig``) are made for the cell.  ``rules_name='dp_only'``
    applies the TP->DP mapping.  ``budget_bytes`` overrides the HBM budget
    per chip; ``device_kind`` the roofline's ``DeviceSpec``."""
    cfg = cfg if cfg is not None else C.get_config(arch)
    shape = shape if shape is not None else SHAPES_BY_NAME[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped",
                "reason": "full-attention arch; long_500k needs "
                          "sub-quadratic decode (DESIGN.md §5)"}
    if mesh is None:
        mc = mesh_shape or mesh_config(multi_pod)
        with fake_world(mc.num_devices):
            from torch.distributed.device_mesh import init_device_mesh
            dev = device or default_device()
            m = init_device_mesh(dev, mc.shape, mesh_dim_names=mc.axes)
            return run_cell(arch, shape_name, multi_pod, policy_mode,
                            out_dir, verbose, m, cfg, shape, rules_name,
                            device=dev, budget_bytes=budget_bytes,
                            device_kind=device_kind)
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = device or mesh.device_type
    chips = mesh.size()
    budget = (ChameleonConfig().hbm_budget_bytes if budget_bytes is None
              else int(budget_bytes))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "mesh_shape": list(mesh.mesh.shape), "chips": chips,
           "policy_mode": policy_mode, "rules": rules_name, "device": dev}
    rules = shd.DP_ONLY_RULES if rules_name == "dp_only" else None
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    t0 = time.time()
    with shd.use_mesh(mesh, rules):
        args, meta = SP.input_specs(cfg, shape, device=dev, mode=mode)
        N = cfg.active_param_count()
        if meta["step"] == "train":
            # dp_only: ZeRO-3 semantics come from the rules themselves
            zero = 0 if rules_name == "dp_only" else _zero_stage(arch)
            model, opt, batch, ls = args
            with mode:
                sm, so = S.shard_model(cfg, model, mesh, opt,
                                       zero_stage=zero, rules=rules)
                local, _ = _local_batch(batch, mesh, rules,
                                        shape.global_batch)
            gsh = S.to_shardings({n: lay.opt for n, lay in
                                  sm.layouts.items()}, mesh)
            step = S.make_train_step(cfg, TrainConfig(), grad_shardings=gsh)
            remat = policy_mode == "remat"

            def fn():
                with _full_remat() if remat else contextlib.nullcontext():
                    return step(sm, so, local, ls)

            static = _resident_bytes(dict(sm.module.named_parameters()),
                                     sm.shards, so.m, so.v, so.master)
            departures = _departures(sm)
            mf = R.model_flops_train(N, shape.global_batch * shape.seq_len)
            rec["zero_stage"] = zero
        else:
            model = args[0]
            with mode:
                sm, _ = S.shard_model(cfg, model, mesh, zero_stage=0,
                                      rules=rules)
            if meta["step"] == "prefill":
                with mode:
                    local, _ = _local_batch(args[1], mesh, rules,
                                            shape.global_batch)
                step = S.make_prefill_step(cfg)

                def fn():
                    return step(sm, local)

                mf = 2.0 * N * shape.global_batch * shape.seq_len
            else:
                with mode:
                    toks, Bl = _local_batch({"t": args[1]}, mesh, rules,
                                            shape.global_batch)
                    lshape = ShapeConfig(shape.name, shape.kind,
                                         shape.seq_len, Bl)
                    with sm.context():
                        state = SP.decode_state_specs(
                            sm.local_cfg, lshape, device=dev, mode=mode,
                            model=sm.module)
                step = S.make_decode_step(cfg)

                def fn():
                    return step(sm, toks["t"], state)

                mf = R.model_flops_decode(N, shape.global_batch)
            static = _resident_bytes(dict(sm.module.named_parameters()))
            departures = _departures(sm)
        with mode:
            cost, _ = R.step_cost(fn)
            t_cost = time.time() - t0
            prof = profile_step(fn, device="cpu", static_bytes=static)
        t_trace = time.time() - t0 - t_cost
    prof = _per_chip_profile(prof, static)
    prof.t_iter = _estimate_t_iter(cfg, shape, chips)
    tl = build_timeline(prof)
    terms = R.analyze(cost, chips, model_flops=mf, device_kind=device_kind)
    # weights gathered at use refill storages the profile does not see
    # born: the most alive at once is added to the timeline's peak
    gathered = int(sm.peak_gathered_bytes)
    peak = int(tl.peak) + gathered
    rec.update(
        status="ok", cost_s=round(t_cost, 2), trace_s=round(t_trace, 2),
        departures=departures,
        memory={"static_bytes": int(static),
                "temp_bytes": int(peak - static),
                "peak_per_chip": peak,
                "gathered_peak_bytes": gathered,
                "hbm_budget_bytes": int(budget),
                "fits_hbm": bool(peak <= budget)},
        roofline=terms.to_dict())
    if meta["step"] == "train" and policy_mode not in ("none", "raw",
                                                       "remat"):
        info = _policy_info(policy_mode, prof, budget)
        rec["policy_info"] = info
        off = info.get("swapped_bytes_per_chip")
        if off is not None:
            rec["memory"]["offloaded_per_chip_analytic"] = int(off)
            rec["memory"]["device_peak_est"] = int(peak - off)
            rec["memory"]["fits_hbm_with_offload"] = bool(peak - off
                                                          <= budget)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = "" if rules_name == "default" else f"__{rules_name}"
        fname = (f"{arch}__{shape_name}__{mesh_name}"
                 f"__{policy_mode}{suffix}.json")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    if verbose:
        r = rec["roofline"]
        print(f"[{mesh_name:6s}] {arch:24s} {shape_name:12s} "
              f"trace={t_cost + t_trace:7.1f}s "
              f"peak/chip={peak / 2**30:6.2f}GiB "
              f"compute={r['compute_s'] * 1e3:8.2f}ms "
              f"mem={r['memory_s'] * 1e3:8.2f}ms "
              f"coll={r['collective_s'] * 1e3:8.2f}ms "
              f"-> {r['bottleneck']}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--policy", default="chameleon",
                    choices=["none", "raw", "chameleon", "remat",
                             "offload_all", "offload_inputs"])
    ap.add_argument("--rules", choices=["default", "dp_only"],
                    default="default")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=ARTIFACTS)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default: cuda where "
                         "torch is built for it, else cpu)")
    args = ap.parse_args(argv)

    archs = ([C.ALIASES.get(args.arch, args.arch)] if args.arch
             else C.ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES_BY_NAME)
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                sfx = "" if args.rules == "default" else f"__{args.rules}"
                fname = os.path.join(
                    args.out,
                    f"{arch}__{shape}__{mesh}__{args.policy}{sfx}.json")
                if os.path.exists(fname) and not args.force:
                    print(f"cached: {fname}")
                    continue
                try:
                    run_cell(arch, shape, mesh == "multi", args.policy,
                             args.out, rules_name=args.rules,
                             device=args.device)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape, mesh, repr(e)))
                    print(f"FAIL {arch} {shape} {mesh}: {e!r}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall requested cells traced OK")


if __name__ == "__main__":
    main()
