"""The executor (paper §6, ``repro_torch.core.executor``) against the
reference's ``repro.core.executor``.

Lowering is numpy over one profile, so from the reference's
``llama_profile`` carried to the port with ``ProfileData.from_arrays``
(``tests/test_torch_planning.py::to_port``) both packages must give the
same ``offload`` / ``save`` / ``remat`` sets, fingerprints and release
plans, with and without the remat fallback.

Execution has no reference counterpart to compare numbers with (the
reference applies a remat policy inside XLA).  The reference's bar is
``tests/test_matching_executor.py::test_offload_policy_grads_exact``:
gradients under the offload-everything policy within rtol 5e-3 of the
baseline's.  That is the ceiling; the port's offload is a byte copy and
its remat reruns the same ops, so here loss and gradients are bit-equal
to the baseline's (reduced llama2-paper, one thread, the CPU engine).
"""
import weakref

import numpy as np
import pytest
import torch

import repro_torch.configs as PC
from repro.core import executor as rexec
from repro.core import memtrace as rmem
from repro.core import policy as rpol
from repro_torch import faults
from repro_torch.common.config import ChameleonConfig, ResilienceConfig
from repro_torch.common.config import TrainConfig
from repro_torch.core import executor as pexec
from repro_torch.core import memtrace as pmem
from repro_torch.core import policy as ppol
from repro_torch.core import sites
from repro_torch.core.profiler import MIN_TRACK_BYTES, profile_step
from repro_torch.core.tokenizer import OpStreamRecorder
from repro_torch.distributed import steps as S
from repro_torch.hostmem import HostMemTier
from repro_torch.hostmem.engine import TransferError
from repro_torch.models import transformer as T
from tests.test_torch_planning import cfgs, to_port

torch.set_num_threads(1)      # tier-1 runs several xdist workers


# ---------------------------------------------------------------- lowering
def _applied(ap):
    return (sorted(ap.offload), sorted(ap.save), sorted(ap.remat),
            ap.fingerprint, dict(ap.release_plan), ap.raw)


def _budget(prof, frac):
    """The static bytes plus ``frac`` of the dynamic peak."""
    peak = rmem.build_timeline(prof).peak
    return int(prof.static_bytes + frac * (peak - prof.static_bytes))


@pytest.mark.parametrize("frac", [0.9, 0.8, 0.7, 0.6])
@pytest.mark.parametrize("remat", [None, True, False])
def test_lowering_matches_reference(llama_profile, frac, remat):
    ref, _ = llama_profile
    port = to_port(ref)
    budget = _budget(ref, frac)
    rcfg, pcfg = cfgs(groups_per_phase=8, allow_remat_fallback=True)
    rpolicy = rpol.generate_policy(ref, rcfg, budget)
    ppolicy = ppol.generate_policy(port, pcfg, budget)
    ra = rexec.Executor(rcfg).lower(rpolicy, ref, remat_fallback=remat)
    pa = pexec.Executor(pcfg).lower(ppolicy, port, remat_fallback=remat)
    assert _applied(pa) == _applied(ra)
    assert pa.offload, "a policy under this budget offloads something"
    assert not (pa.offload & pa.save) and not (pa.offload & pa.remat)
    if remat is False:
        assert not pa.remat


def test_fixed_policies_match_reference(llama_profile):
    ref, _ = llama_profile
    port = to_port(ref)
    rcfg, pcfg = cfgs()
    rx, px = rexec.Executor(rcfg), pexec.Executor(pcfg)
    assert px.site_universe(port) == rx.site_universe(ref)
    assert px.site_universe(None) == rx.site_universe(None)
    for name in ("baseline", "raw"):
        assert _applied(getattr(px, name)()) == _applied(getattr(rx, name)())
    for prof_r, prof_p in ((ref, port), (None, None)):
        assert (_applied(px.conservative(prof_p))
                == _applied(rx.conservative(prof_r)))
    assert pexec.CHEAP_RECOMPUTE_SITES == rexec.CHEAP_RECOMPUTE_SITES
    # baseline and raw are plain autograd: no execution context
    assert px.execution(px.baseline()) is None
    assert px.execution(px.raw()) is None


def test_bind_release_points(llama_profile):
    ref, _ = llama_profile
    port = to_port(ref)
    _, pcfg = cfgs(groups_per_phase=8)
    pol = ppol.generate_policy(port, pcfg, _budget(ref, 0.8))
    ap = pexec.Executor(pcfg).lower(pol, port)
    eng = HostMemTier(device="cpu").engine
    eng.plan_release("stale", 3)
    assert pexec.Executor(pcfg).bind_release_points(ap, eng) == len(
        ap.release_plan) > 0
    assert eng.planned_releases() == ap.release_plan


# ---------------------------------------------------------------- execution
@pytest.fixture(scope="module")
def step():
    """Reduced llama2-paper, one batch from a numpy seed, the baseline grad
    step's loss and gradients, and its detailed profile."""
    cfg = PC.get_reduced("llama2_paper")
    model = T.init_model(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    tok = torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 64)))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    grad = S.make_grad_step(cfg, TrainConfig())
    loss, grads, _ = grad(model, batch, 1.0)
    prof = profile_step(lambda: grad(model, batch, 1.0), device="cpu")
    return dict(cfg=cfg, model=model, batch=batch, loss=loss, grads=grads,
                prof=prof)


def _run(step, ex, rec=None):
    fn = S.make_grad_step(step["cfg"], TrainConfig(), ex)
    if rec is None:
        return fn(step["model"], step["batch"], 1.0)
    with rec.iteration() as it:
        out = fn(step["model"], step["batch"], 1.0)
    return out + (it.stream,)


def _bit_equal(step, loss, grads):
    assert torch.equal(loss, step["loss"])
    assert grads.keys() == step["grads"].keys()
    for k in grads:
        assert torch.equal(grads[k], step["grads"][k]), k


class _Saved:
    """The oracle for the bytes a policy must move: the storages autograd
    saves in a baseline step, each with the first (site, layer) ``tag``
    gave it and its order among that pair's (a label goes when its storage
    is freed: addresses are reused)."""

    def __init__(self):
        self.labels, self.saved, self.seq = {}, {}, {}

    def note_site(self, x, name, layer, recompute):
        st = x.untyped_storage()
        if st._cdata in self.labels or st.nbytes() < MIN_TRACK_BYTES:
            return
        site = sites.base_site(name)
        k = self.seq.get((site, layer), 0)
        self.seq[(site, layer)] = k + 1
        self.labels[st._cdata] = ((site, layer, k), weakref.ref(
            st, lambda _r, key=st._cdata: self.labels.pop(key, None)))

    def pack(self, t):
        st = t.untyped_storage()
        lab = self.labels.get(st._cdata)
        if lab is not None:
            self.saved[id(lab)] = (lab[0], st.nbytes())
        return t


def _moved_bytes(step, ap):
    """Bytes of the saved storages of the offloaded sites, and of the
    policy's entries outside the remat sites."""
    o = _Saved()
    with sites.executing(o), torch.autograd.graph.saved_tensors_hooks(
            o.pack, lambda t: t):
        _run(step, None)
    uids = {e.uid for e in (ap.swap.entries if ap.swap else ())}
    entries = {(t.site, t.layer, t.tag_seq) for t in step["prof"].candidates
               if t.uid in uids and t.site not in ap.remat}
    return sum(nb for key, nb in o.saved.values()
               if key[0] in ap.offload or key in entries)


def _engine(**resilience):
    return HostMemTier(device="cpu",
                       resilience=ResilienceConfig(**resilience)).engine


def test_conservative_step_is_bit_exact_and_moves_the_sites(step):
    prof = step["prof"]
    x = pexec.Executor(ChameleonConfig())
    ap = x.conservative(prof)
    eng = _engine()
    ex = x.execution(ap, eng, prof)
    before = eng.by_class["policy_swap"].as_dict()
    loss, grads, finite, stream = _run(step, ex, OpStreamRecorder())
    after = eng.by_class["policy_swap"].as_dict()
    _bit_equal(step, loss, grads)
    assert bool(finite)
    want = _moved_bytes(step, ap)
    moved_out = after["bytes_out"] - before["bytes_out"]
    moved_in = after["bytes_in"] - before["bytes_in"]
    assert moved_out == moved_in == want > 0
    last = ex.last
    assert last["staged_bytes"] == last["restored_bytes"] == want
    # every swap-in planned from the profile, none fetched on demand, and
    # the class window never forced a retire on the forward
    assert last["on_demand"] == 0 and last["prefetched"] == last["staged"]
    assert last["forced_retires"] == 0 and last["never_restored"] == 0
    # views saved twice (q, k, v by the attention and a product) staged once
    assert last["views"] > last["staged"]
    # the executor's copies add no op to the recorded stream
    np.testing.assert_array_equal(stream.tokens, step["prof"].op_tokens)
    assert eng.pool.bytes_in_use == 0


def test_views_of_one_storage_are_staged_once():
    eng = _engine()
    ap = pexec.AppliedPolicy(None, {"ffn_pre"}, set(), set(), "t")
    ex = pexec.Executor(ChameleonConfig()).execution(ap, eng)
    w = torch.randn(64, 64, requires_grad=True)
    with ex.run():
        h = sites.tag(w @ w, "ffn_pre")
        y = (h * h).sum() + (h[:16] * 2).sum()    # h saved three times
        y.backward()
    with torch.no_grad():
        ref = w.detach().clone().requires_grad_(True)
    h2 = ref @ ref
    ((h2 * h2).sum() + (h2[:16] * 2).sum()).backward()
    assert torch.equal(w.grad, ref.grad)
    assert ex.last["staged"] == 1 and ex.last["views"] == 2
    # no profile: the swap-in waited for the unpack
    assert ex.last["on_demand"] == 1
    assert eng.by_class["policy_swap"].bytes_out == 64 * 64 * 4


def _lowered(step, frac, remat=True):
    prof = step["prof"]
    cfg = ChameleonConfig(groups_per_phase=step["cfg"].num_layers)
    tl = pmem.build_timeline(prof)
    pol = ppol.generate_policy(prof, cfg, int(tl.peak * frac), timeline=tl)
    return pexec.Executor(cfg).lower(pol, prof, remat_fallback=remat)


@pytest.mark.parametrize("frac", [0.9, 0.95])
def test_lowered_policy_with_remat_is_bit_exact(step, frac):
    """A lowered policy: its offloaded sites whole, its other entries one
    tensor each, its remat sites recomputed."""
    prof = step["prof"]
    ap = _lowered(step, frac)
    assert ap.remat == {"ffn_act"}
    x = pexec.Executor(ChameleonConfig())
    eng = _engine()
    x.bind_release_points(ap, eng)
    ex = x.execution(ap, eng, prof)
    loss, grads, _, stream = _run(step, ex, OpStreamRecorder())
    _bit_equal(step, loss, grads)
    # ffn_act of every layer recomputed in the backward, and the
    # recomputation is not in the op stream either
    assert ex.last["recomputed"] == step["cfg"].num_layers
    np.testing.assert_array_equal(stream.tokens, prof.op_tokens)
    c = eng.by_class["policy_swap"]
    assert c.bytes_out == c.bytes_in == _moved_bytes(step, ap) > 0
    # the planned swap-outs retire at their promised ops (entries of a
    # remat site are recomputed, not moved)
    planned = [t for t in ap.release_plan if t.split(":")[0] not in ap.remat]
    assert c.released_at_op == len(planned) > 0
    assert ex.last["on_demand"] == 0


def test_profile_around_an_executed_step_sees_the_baseline(step):
    """The executor's copies add no token (or storage) to a detailed
    profile taken around the step: it hooks into the profile's counting
    mode instead of stacking its own."""
    prof = step["prof"]
    x = pexec.Executor(ChameleonConfig())
    ex = x.execution(x.conservative(prof), _engine(), prof)
    got = profile_step(lambda: _run(step, ex), device="cpu")
    np.testing.assert_array_equal(got.op_tokens, prof.op_tokens)
    assert ex.last["on_demand"] == 0 and ex.last["staged"] > 0


def test_profile_tokens_equal_the_recorders(step):
    rec = OpStreamRecorder()
    *_, stream = _run(step, None, rec)
    np.testing.assert_array_equal(stream.tokens, step["prof"].op_tokens)


def test_without_a_profile_every_swap_in_is_on_demand(step):
    x = pexec.Executor(ChameleonConfig())
    eng = _engine()
    ex = x.execution(x.conservative(None), eng, None)
    loss, grads, _ = _run(step, ex)
    _bit_equal(step, loss, grads)
    assert ex.last["on_demand"] == ex.last["staged"] > 0
    assert ex.last["prefetched"] == 0


def test_failed_swap_raises_without_resilience(step):
    """No fallback: with the ladder off (resilience disabled) a copy that
    fails raises out of the step."""
    x = pexec.Executor(ChameleonConfig())
    ex = x.execution(x.conservative(step["prof"]), _engine(enabled=False),
                     step["prof"])
    plan = faults.FaultPlan([faults.FaultSpec("engine.transfer_error",
                                              prob=1.0)])
    with faults.injected(plan), pytest.raises(TransferError):
        _run(step, ex)


def test_failed_swap_is_retained_with_resilience(step):
    """With resilience on, a D2H that fails for good keeps its source on
    the device (the engine's retained copy) and the step stays bit-exact;
    link health records the errors for the ladder."""
    x = pexec.Executor(ChameleonConfig())
    eng = _engine(max_retries=0, retry_backoff_s=0.0)
    ex = x.execution(x.conservative(step["prof"]), eng, step["prof"])
    plan = faults.FaultPlan([faults.FaultSpec("engine.transfer_error",
                                              prob=1.0, max_fires=3)])
    with faults.injected(plan):
        loss, grads, _ = _run(step, ex)
    _bit_equal(step, loss, grads)
    assert eng.n_failed_out == 3 and eng.n_hbm_fallback_in == 3
    assert eng.health.links["policy_swap"].n_errors == 3


def test_offload_without_an_engine_raises():
    x = pexec.Executor(ChameleonConfig())
    with pytest.raises(ValueError, match="no transfer engine"):
        x.execution(x.conservative(None), None)
