"""The three adaptation placements in the port's trainer (``inline``,
``async``, ``speculative``; ``repro_torch.core.runtime`` with
``repro_torch.adapt``) on the reference's drift scenario
(``benchmarks/adapt_bench.py``'s drift-stall suite, reduced): llama2-paper
reduced, two sequence-length buckets of 4 x 64 and 4 x 96 tokens
alternating every 12 steps, 48 steps, the policy store off.  The step hook
drains the worker, so every job has published before the next boundary
polls: the installs are deterministic.

* The port's per-step stages equal the reference trainer's under the same
  hook, in every placement (8 MiB, the reference bench's budget).
* Every async install is what the reference's pipeline computes for the
  same snapshot (its profile converted to the reference's classes): kind,
  knob, predicted time and every swap entry.  At 8 MiB every variant of
  the port's profile is the conservative fallback (the port profiles
  storages, and its reduced step peaks at 16.4 MiB where the reference's
  traced one peaks near 12), so the installs are also held at 16 MiB,
  where the 4 x 64 bucket gets a swap policy.
* The losses are equal across placements; speculative installs a parked
  policy (a hit) with no GenPolicy step.

No wall-time bar runs here: CPU step times move too much to hold a 1.5x
ratio (the chip smoke's ``chameleon_async`` phase holds it on the card).
"""
import dataclasses
import shutil
import tempfile
import threading

import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as PC
from repro.adapt import AdaptSnapshot as RSnapshot
from repro.adapt import AdaptationPipeline as RPipeline
from repro.common.config import AdaptConfig as RAdaptCfg
from repro.common.config import ChameleonConfig as RCfg
from repro.common.config import PolicyStoreConfig as RPSCfg
from repro.common.config import ResilienceConfig as RResCfg
from repro.common.config import TrainConfig as RTrainConfig
from repro.core.executor import Executor as RExecutor
from repro.core.profiler import ProfileData as RProfile
from repro.core.profiler import TensorInstance as RTensor
from repro.data.synthetic import SyntheticTokens as RTokens
from repro.runtime.trainer import Trainer as RTrainer
from repro_torch.common.config import (AdaptConfig, ChameleonConfig,
                                       PolicyStoreConfig, ResilienceConfig,
                                       TrainConfig)
from repro_torch.core.profiler import ProfileData
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.runtime.trainer import Trainer
from tests.test_torch_planning import _entry

torch.set_num_threads(1)      # tier-1 runs several xdist workers

STEPS, PERIOD, SEQS, BATCH = 48, 12, (64, 96), 4
# the hook's drain deadline: far past any job's time, loaded or not
DRAIN_S = 600.0
MODES = ("inline", "async", "speculative")


def _tcfg(mod, d):
    return mod(steps=STEPS, checkpoint_every=0, checkpoint_dir=d,
               eval_every=0, warmup_steps=2, learning_rate=1e-3)


def _drift(pkg: str, mode: str, budget: int) -> dict:
    """One drift run in ``pkg`` ("port" or "ref"); the hook drains the
    worker, then switches the bucket every PERIOD steps.

    Wall time decides nothing: the worker starts a job only inside the
    hook (``gate``), so a job submitted at a step's kickoff can never
    publish before that step's own poll, however the threads are
    scheduled; the hook's drain must finish (a timeout fails the test
    instead of shifting an install); and both packages run with the
    watchdog and the pacing off, which the drained hook makes moot, and
    without the link-health layer, through their own configs.  No fault
    is injected here, so that layer's only input would be the host
    clock: on a loaded host a CPU copy over its 50 ms timeout floor
    moves the degradation ladder, whose new policy changes the op stream
    and so the stages."""
    d = tempfile.mkdtemp()
    try:
        if pkg == "port":
            cfg = PC.get_reduced("llama2_paper")
            cham = ChameleonConfig(enabled=True, hbm_budget_bytes=budget,
                                   policystore=PolicyStoreConfig(
                                       enabled=False),
                                   adapt=AdaptConfig(pace_s=0.0),
                                   resilience=ResilienceConfig(
                                       enabled=False, adapt_timeout_s=0.0))
            mk = lambda seq, seed: SyntheticTokens(cfg.vocab_size, seq,
                                                   BATCH, seed=seed)
            tr = Trainer(cfg, _tcfg(TrainConfig, d), cham, data=mk(64, 0),
                         adapt_mode=mode, device="cpu")
        else:
            cfg = RC.get_reduced("llama2_paper")
            cham = RCfg(enabled=True, hbm_budget_bytes=budget,
                        policystore=RPSCfg(enabled=False),
                        adapt=RAdaptCfg(pace_s=0.0),
                        resilience=RResCfg(enabled=False,
                                           adapt_timeout_s=0.0))
            mk = lambda seq, seed: RTokens(cfg.vocab_size, seq, BATCH,
                                           seed=seed)
            tr = RTrainer(cfg, _tcfg(RTrainConfig, d), cham, data=mk(64, 0),
                          adapt_mode=mode)
        buckets = [mk(s, i) for i, s in enumerate(SEQS)]
        runs = []
        gate = threading.Event()
        pipe_run = tr.rt.pipeline.run

        def gated(snap, **kw):
            assert gate.wait(DRAIN_S)
            res = pipe_run(snap, **kw)
            if pkg == "port":              # every worker run, in order
                runs.append((snap, res))
            return res
        tr.rt.pipeline.run = gated

        ran = []                           # the policy each step ran

        def hook(step):
            if pkg == "port":
                ran.append(tr.rt._last_dispatch.applied)
            gate.set()
            assert tr.rt.service.drain(timeout=DRAIN_S)
            gate.clear()
            if (step + 1) % PERIOD == 0:
                tr.data = buckets[((step + 1) // PERIOD) % 2]

        try:
            rep = tr.train(STEPS, fault_hook=hook)
        finally:
            tr.rt.close()
        return {"stages": list(rep.stages), "losses": list(rep.losses),
                "adapt": rep.adapt, "genpolicy_steps": rep.genpolicy_steps,
                "adaptations": [(a["trigger_step"], a["end_step"], a["tier"])
                                for a in tr.rt.adaptations],
                "runs": runs, "ran": ran, "cfg": tr.cham}
    finally:
        shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def drift():
    out = {(pkg, m, 8): _drift(pkg, m, 8 << 20)
           for pkg in ("port", "ref") for m in MODES}
    out[("port", "async", 16)] = _drift("port", "async", 16 << 20)
    return out


# ----------------------------------------------------------------- helpers
def _ref_cfg(pcfg):
    """The reference's ChameleonConfig with the port config's values
    (link and device rates included)."""
    kw = {}
    for f in dataclasses.fields(pcfg):
        v = getattr(pcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = type(getattr(RCfg(), f.name))(**dataclasses.asdict(v))
        kw[f.name] = v
    return RCfg(**kw)


def _to_ref(prof) -> RProfile:
    """A port profile in the reference's classes."""
    ts = [RTensor(t.uid, t.nbytes, t.birth, t.death, site=t.site,
                  layer=t.layer, dtype_code=t.dtype_code,
                  shape=tuple(t.shape), producer_token=t.producer_token)
          for t in prof.tensors]
    return RProfile(np.asarray(prof.op_tokens), ts, prof.t_iter,
                    prof.static_bytes, scan_layers=prof.scan_layers)


def _ref_result(pcfg, snap):
    rcfg = _ref_cfg(pcfg)
    return RPipeline(rcfg, RExecutor(rcfg)).run(RSnapshot(
        profile=_to_ref(snap.profile), t_iter=snap.t_iter,
        budget=snap.budget, bwmodel=snap.bwmodel,
        contention_s=snap.contention_s, backlog=snap.backlog,
        gen_knobs=snap.gen_knobs, iter_exact=snap.iter_exact,
        step=snap.step))


def _policy(res):
    return (res.kind, res.knob, res.predicted_t, res.applied.fingerprint,
            [_entry(e) for e in res.swap.entries] if res.swap else None)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("mode", MODES)
def test_stages_equal_the_references(drift, mode):
    """Per-step stages and adaptation records (trigger, end, tier) under
    the draining hook are the reference trainer's."""
    port, ref = drift[("port", mode, 8)], drift[("ref", mode, 8)]
    assert port["stages"] == ref["stages"]
    assert port["adaptations"] == ref["adaptations"]
    for key in ("jobs", "installed", "speculative_jobs", "speculative_hits",
                "failed", "watchdog_fired", "snapshots"):
        assert port["adapt"][key] == ref["adapt"][key], key
    if mode != "inline":
        assert "GenPolicy" not in port["stages"]
        assert port["adapt"]["installed"] == STEPS // PERIOD


@pytest.mark.parametrize("budget", [8, 16])
def test_async_installs_equal_the_reference_pipelines(drift, budget):
    """Each worker run installs what the reference's pipeline computes
    for the same snapshot; at 16 MiB the short bucket's policy swaps."""
    run = drift[("port", "async", budget)]
    assert len(run["runs"]) == STEPS // PERIOD
    kinds = set()
    for snap, res in run["runs"]:
        assert isinstance(snap.profile, ProfileData)   # materialized
        assert _policy(res) == _policy(_ref_result(run["cfg"], snap))
        kinds.add(res.kind)
    if budget == 16:
        assert "genpolicy" in kinds
        assert any(res.swap is not None and res.swap.entries
                   for _, res in run["runs"])


def test_losses_equal_across_placements(drift):
    losses = [drift[("port", m, 8)]["losses"] for m in MODES]
    assert losses[0] == losses[1] == losses[2]
    assert drift[("port", "async", 16)]["losses"] == losses[0]


def test_speculative_hits_with_no_genpolicy_step(drift):
    sp = drift[("port", "speculative", 8)]
    assert sp["adapt"]["speculative_hits"] >= 1
    assert sp["genpolicy_steps"] == 0
    assert sp["adapt"]["speculative_jobs"] >= 1
    # the last visit installs the parked policy in the step it settles:
    # one Adapting step, where the async run waits for its worker
    last = slice(STEPS - PERIOD, STEPS)
    assert sp["stages"][last].count("Adapting") == 1
    assert drift[("port", "async", 8)]["stages"][last].count("Adapting") > 1


def test_stream_key_separates_sequence_length_buckets(drift):
    """Both buckets record the same eager op stream; their snapshots
    still carry distinct stream keys (fingerprint + arg shapes), so the
    worker retains one snapshot per bucket, as the reference does with
    its shape-dependent traced streams."""
    run = drift[("port", "async", 8)]
    keys = [snap.iter_exact for snap, _ in run["runs"]]
    assert keys[0] != keys[1] and keys[0] == keys[2] and keys[1] == keys[3]
    assert len({snap.iter_fp.exact for snap, _ in run["runs"]}) == 1
    assert run["adapt"]["snapshots"] == 2


def test_recurring_bucket_runs_its_policy_from_its_first_step(drift):
    """Async: the first step of a recurring bucket runs the policy last
    installed for that bucket (``ChameleonRuntime.step_fn(args)``), not
    the previous bucket's; inline runs the previous bucket's policy for
    that step, as the reference does."""
    for budget in (8, 16):
        run = drift[("port", "async", budget)]
        installed = [res.applied for _, res in run["runs"]]
        assert run["ran"][2 * PERIOD] is installed[0]     # 4 x 64 again
        assert run["ran"][3 * PERIOD] is installed[1]     # 4 x 96 again
        assert run["ran"][PERIOD] is installed[0]         # first visit
    inline = drift[("port", "inline", 8)]
    assert inline["ran"][2 * PERIOD] is inline["ran"][2 * PERIOD - 1]
