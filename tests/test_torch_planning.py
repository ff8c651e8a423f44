"""Planning (§5: timeline, MRL, candidates, the simulator, Algo 2, Algo 3
and §6.1 matching): the port's numpy copies against the reference, exactly.

Every case builds one profile in the reference's classes and carries it to
the port's with ``ProfileData.from_arrays`` (as ``models.convert`` carries
weights), then runs both packages and compares with ``==``: the timeline,
the MRL, the candidate list with its scores, the policy entries with their
swap-in and free times, the stall time and the projected peak, the passive
swap order, the match mapping.  Both packages get explicit, equal
``ChameleonConfig`` values (link rate, groups, C), so no default of either
package enters a comparison.  The cases are those of
``tests/test_simulator_policy.py``, ``tests/test_oom_warmup.py``, the
matching half of ``tests/test_matching_executor.py`` and the
``llama_profile`` fixture (the reference's profile of a reduced llama2
step) at several budgets.
"""
import numpy as np
import pytest

from repro.common.config import ChameleonConfig as RCfg
from repro.core import candidates as rcand
from repro.core import matching as rmatch
from repro.core import memtrace as rmem
from repro.core import mrl as rmrl
from repro.core import oom as room
from repro.core import policy as rpol
from repro.core import simulator as rsim
from repro.core.profiler import ProfileData as RProfile
from repro.core.profiler import TensorInstance as RTensor
from repro_torch.common.config import ChameleonConfig as PCfg
from repro_torch.core import candidates as pcand
from repro_torch.core import matching as pmatch
from repro_torch.core import memtrace as pmem
from repro_torch.core import mrl as pmrl
from repro_torch.core import oom as poom
from repro_torch.core import policy as ppol
from repro_torch.core import simulator as psim
from repro_torch.core.profiler import ProfileData as PProfile
from repro_torch.hostmem.bwmodel import BandwidthModel as PBw
from repro.hostmem.bwmodel import BandwidthModel as RBw

CFG = dict(host_link_gbps=32.0, score_coef_c=1.0, m_warmup_stable=2,
           n_genpolicy_steps=5, groups_per_phase=0,
           hbm_budget_bytes=16 * 1024 ** 3)


def cfgs(**kw):
    d = {**CFG, **kw}
    return RCfg(**d), PCfg(**d)


def to_port(ref: RProfile) -> PProfile:
    ts = ref.tensors
    return PProfile.from_arrays(
        np.asarray(ref.op_tokens), [t.nbytes for t in ts],
        [t.birth for t in ts], [t.death for t in ts],
        t_iter=ref.t_iter, static_bytes=ref.static_bytes,
        uids=[t.uid for t in ts], sites=[t.site for t in ts],
        layers=[t.layer for t in ts], dtype_codes=[t.dtype_code for t in ts],
        shapes=[t.shape for t in ts],
        producer_tokens=[t.producer_token for t in ts],
        scan_layers=ref.scan_layers)


def synth_profile(n_layers=8, ops_per_layer=10, res_bytes=64 << 20,
                  t_iter=1.0):
    """tests/test_simulator_policy.py::synth_profile, in the reference's
    classes: a symmetric fwd/bwd stream, one tagged residual per layer."""
    n_fwd = n_layers * ops_per_layer
    n_ops = 2 * n_fwd
    tensors = [RTensor(i, res_bytes, (i + 1) * ops_per_layer - 1,
                       n_ops - (i + 1) * ops_per_layer, site="resid_post",
                       layer=i, dtype_code=1, shape=(res_bytes // 4,))
               for i in range(n_layers)]
    return RProfile(np.zeros(n_ops, np.int32), tensors, t_iter, 0)


def _entry(e):
    return (e.uid, e.site, e.layer, e.nbytes, e.birth, e.death, e.swap_in_op,
            e.swap_out_done_op, e.stalled, e.score, e.t_swap)


def _policy(pol):
    return ([_entry(e) for e in pol.entries], pol.projected_peak,
            pol.baseline_peak, pol.budget, pol.stall_time, pol.t_iter,
            pol.n_ops, pol.fingerprint, pol.contention_s, pol.occupancy,
            pol.swapped_bytes)


def _gen(mod, prof, cfg, budget, **kw):
    try:
        return _policy(mod.generate_policy(prof, cfg, budget, **kw))
    except mod.ChameleonOOMError as e:
        return ("oom", str(e))


def _same_planning(ref, port, rcfg, pcfg, budget, ref_kw=None, port_kw=None):
    """Timeline, MRL, candidates and policy: equal in both packages."""
    rtl, ptl = rmem.build_timeline(ref), pmem.build_timeline(port)
    np.testing.assert_array_equal(ptl.usage, rtl.usage)
    assert (ptl.peak, ptl.peak_op, ptl.static_bytes) == \
        (rtl.peak, rtl.peak_op, rtl.static_bytes)
    rm, pm = rmrl.MRL.from_timeline(rtl, budget), \
        pmrl.MRL.from_timeline(ptl, budget)
    np.testing.assert_array_equal(pm.ops, rm.ops)
    np.testing.assert_array_equal(pm.required, rm.required)
    rcl = rcand.build_candidate_list(ref, rm, rcfg)
    pcl = pcand.build_candidate_list(port, pm, pcfg)
    assert [(c.tensor.uid, c.n_mre, c.score) for c in pcl] == \
        [(c.tensor.uid, c.n_mre, c.score) for c in rcl]
    want = _gen(rpol, ref, rcfg, budget, **(ref_kw or {}))
    got = _gen(ppol, port, pcfg, budget, **(port_kw or {}))
    assert got == want
    return got


# ----------------------------------------------------- the llama profile
@pytest.mark.parametrize("frac", [0.95, 0.8, 0.6, 0.4, 0.2])
def test_llama_profile_policy_parity(llama_profile, frac):
    ref = llama_profile[0]
    port = to_port(ref)
    tl = rmem.build_timeline(ref)
    budget = int(ref.static_bytes + frac * (tl.peak - ref.static_bytes))
    rcfg, pcfg = cfgs()
    got = _same_planning(ref, port, rcfg, pcfg, budget)
    if got[0] != "oom":
        assert got[1] <= budget


@pytest.mark.parametrize("groups", [2, 8, 32])
@pytest.mark.parametrize("frac", [0.6, 0.2])
def test_llama_profile_policy_parity_over_groups(llama_profile, frac,
                                                 groups):
    """The grouping knobs of the GenPolicy variants, a few groups (most
    candidates fit no layer, the stalled fallback runs) to many: the
    simulator's placement equals the reference's candidate by candidate."""
    ref = llama_profile[0]
    port = to_port(ref)
    tl = rmem.build_timeline(ref)
    budget = int(ref.static_bytes + frac * (tl.peak - ref.static_bytes))
    rcfg, pcfg = cfgs(groups_per_phase=groups)
    _same_planning(ref, port, rcfg, pcfg, budget)


def test_llama_profile_calibrated_link_parity(llama_profile):
    """A measured link curve (the same points in both bandwidth models)
    prices every transfer in both simulators alike."""
    ref = llama_profile[0]
    port = to_port(ref)
    tl = rmem.build_timeline(ref)
    budget = int(ref.static_bytes + 0.5 * (tl.peak - ref.static_bytes))
    points = [(1 << 16, 9e-6), (1 << 20, 4e-5), (1 << 24, 5e-4)]
    rbw, pbw = RBw(32.0), PBw(32.0)
    for n, s in points:
        rbw.observe(n, s)
        pbw.observe(n, s)
    rcfg, pcfg = cfgs(groups_per_phase=8)
    _same_planning(ref, port, rcfg, pcfg, budget,
                   ref_kw={"bwmodel": rbw}, port_kw={"bwmodel": pbw})


class _FixedEngine:
    """Link contention as an engine reports it, fixed for both packages."""

    def __init__(self, delay, occ):
        self.delay, self.occ, self.released = delay, occ, {}

    def queued_delay(self):
        return self.delay

    def sustained_contention(self):
        return self.occ

    def plan_release(self, tag, op):
        self.released[tag] = op


@pytest.mark.parametrize("delay,occ", [(0.0, 0.0), (0.05, 0.0),
                                       (0.0, 0.3), (0.2, 0.5)])
def test_contention_pricing_parity(llama_profile, delay, occ):
    ref = llama_profile[0]
    port = to_port(ref)
    tl = rmem.build_timeline(ref)
    budget = int(ref.static_bytes + 0.5 * (tl.peak - ref.static_bytes))
    rcfg, pcfg = cfgs(groups_per_phase=8)
    re, pe = _FixedEngine(delay, occ), _FixedEngine(delay, occ)
    _same_planning(ref, port, rcfg, pcfg, budget,
                   ref_kw={"engine": re}, port_kw={"engine": pe})
    assert pe.released == re.released


def test_llama_profile_matching_and_projection_parity(llama_profile):
    ref = llama_profile[0]
    port = to_port(ref)
    r, p = rmatch.match_instances(ref, ref), pmatch.match_instances(port, port)
    assert (p.mapping, p.unmatched, p.moved) == \
        (r.mapping, r.unmatched, r.moved)
    rcfg, pcfg = cfgs()
    tl = rmem.build_timeline(ref)
    budget = int(ref.static_bytes + 0.6 * (tl.peak - ref.static_bytes))
    rp = rpol.generate_policy(ref, rcfg, budget)
    pp = ppol.generate_policy(port, pcfg, budget)
    assert ppol.projected_peak(port, pp.entries) == \
        rpol.projected_peak(ref, rp.entries)
    assert pp.site_fractions(port) == rp.site_fractions(ref)
    assert pp.offload_sites(port) == rp.offload_sites(ref)


# -------------------------------------- tests/test_simulator_policy.py
def test_eq1_group_time():
    ref = synth_profile(t_iter=2.0)
    port = to_port(ref)
    rcfg, pcfg = cfgs(groups_per_phase=8)
    rs = rsim.Simulator(ref, ref.n_ops // 2, rcfg)
    ps = psim.Simulator(port, port.n_ops // 2, pcfg)
    assert [(l.start_op, l.end_op, l.kind, l.remaining_time)
            for l in ps.layers] == [(l.start_op, l.end_op, l.kind,
                                     l.remaining_time) for l in rs.layers]
    fwd = [l for l in ps.layers if l.kind == "FWD"]
    assert len(fwd) == 8
    for lay in fwd:
        assert lay.remaining_time == pytest.approx(
            (lay.end_op - lay.start_op) * 2.0 / port.n_ops)


def test_swap_in_backward_search():
    ref = synth_profile(t_iter=10.0)
    port = to_port(ref)
    rcfg, pcfg = cfgs(groups_per_phase=8)
    rs = rsim.Simulator(ref, ref.n_ops // 2, rcfg)
    ps = psim.Simulator(port, port.n_ops // 2, pcfg)
    re = rs.place_swap_in(rcand.Candidate(ref.tensors[0], 5, 1.0))
    pe = ps.place_swap_in(pcand.Candidate(port.tensors[0], 5, 1.0))
    assert _entry(pe) == _entry(re)
    assert not pe.stalled
    assert ps.peak_op <= pe.swap_in_op < port.tensors[0].death


@pytest.mark.parametrize("t_iter,res_bytes,frac", [
    (1e-6, 1 << 30, 0.5),           # no budget anywhere: a stalled swap
    (10.0, 64 << 20, 0.6),          # swap-out completion, reuse intervals
    (5.0, 64 << 20, 0.3),           # never double-booked
])
def test_simulate_and_free_times(t_iter, res_bytes, frac):
    ref = synth_profile(t_iter=t_iter, res_bytes=res_bytes)
    port = to_port(ref)
    rcfg, pcfg = cfgs(groups_per_phase=8)
    out = []
    for mod, cmod, mem, mrl, prof, cfg in (
            (rsim, rcand, rmem, rmrl, ref, rcfg),
            (psim, pcand, pmem, pmrl, port, pcfg)):
        sim = mod.Simulator(prof, prof.n_ops // 2, cfg)
        tl = mem.build_timeline(prof)
        m = mrl.MRL.from_timeline(tl, int(tl.peak * frac))
        entries = sim.simulate(cmod.build_candidate_list(prof, m, cfg), m)
        sim.set_free_time(entries)
        out.append(([_entry(e) for e in entries], sim.stall_time,
                    list(sim.reuse_intervals(entries)),
                    list(sim.naive_reuse_intervals(entries)),
                    list(m.required), [l.remaining_time for l in sim.layers]))
    assert out[1] == out[0]
    entries, stall, custom, naive, _, _ = out[1]
    if t_iter < 1e-3:
        assert any(e[8] for e in entries) and stall > 0
    else:
        assert all(e[7] > e[4] for e in entries)
        assert all(c <= n for c, n in zip(custom, naive))


@pytest.mark.parametrize("frac", [0.9, 0.7, 0.5])
def test_policy_meets_budget(frac):
    ref = synth_profile(n_layers=12, t_iter=30.0)
    port = to_port(ref)
    tl = rmem.build_timeline(ref)
    budget = int(tl.peak * frac)
    rcfg, pcfg = cfgs(groups_per_phase=12)
    got = _same_planning(ref, port, rcfg, pcfg, budget)
    assert got[-1] >= tl.peak - budget - (64 << 20) and len(got[0]) >= 1
    assert got[1] <= tl.peak


def test_policy_raises_below_floor():
    ref = synth_profile()
    ref.tensors.append(RTensor(999, 10 << 30, 0, ref.n_ops, site=None))
    port = to_port(ref)
    rcfg, pcfg = cfgs(groups_per_phase=8)
    got = _same_planning(ref, port, rcfg, pcfg, 1 << 30)
    assert got[0] == "oom"


def test_candidate_scoring_eq2():
    ref = synth_profile()
    port = to_port(ref)
    tl = pmem.build_timeline(port)
    m = pmrl.MRL.from_timeline(tl, int(tl.peak * 0.5))
    cl = pcand.build_candidate_list(port, m, cfgs()[1])
    scores = [c.score for c in cl]
    assert cl and scores == sorted(scores, reverse=True)
    mres = [c.n_mre for c in cl]
    assert mres == sorted(mres, reverse=True)


# ---------------------------------------------- tests/test_oom_warmup.py
def _fit(mod, prof, cfg, budget):
    try:
        absent, peak, order = mod.passive_swap_fit(prof, cfg, budget)
        return sorted(absent), peak, [t.uid for t in order]
    except Exception as e:                      # noqa: BLE001 — compared
        return type(e).__name__, str(e)


@pytest.mark.parametrize("case", ["reaches_budget", "closest_size",
                                  "impossible", "llama"])
def test_passive_swap_parity(case, llama_profile):
    if case == "reaches_budget":
        ref = synth_profile(n_layers=10)
        budget = int(rmem.build_timeline(ref).peak * 0.5)
    elif case == "closest_size":
        ref = RProfile(np.zeros(100, np.int32), [
            RTensor(0, 100, 10, 90, site="resid_post", layer=0),
            RTensor(1, 55, 10, 90, site="resid_post", layer=1),
            RTensor(2, 300, 10, 90, site="resid_post", layer=2)], 1.0, 0)
        budget = 400
    elif case == "impossible":
        ref = synth_profile(n_layers=2)
        ref.tensors.append(RTensor(99, 10 << 30, 0, ref.n_ops))
        budget = 1 << 20
    else:
        ref = llama_profile[0]
        tl = rmem.build_timeline(ref)
        budget = int(ref.static_bytes + 0.7 * (tl.peak - ref.static_bytes))
    port = to_port(ref)
    rcfg, pcfg = cfgs()
    got = _fit(poom, port, pcfg, budget)
    assert got == _fit(room, ref, rcfg, budget)
    if case == "closest_size":
        assert got[2][0] == 1 and got[1] <= 400
    elif case == "impossible":
        assert got[0] == "ChameleonOOMError"
    else:
        assert got[1] <= budget and got[0]


def test_warmup_offload_sites():
    ref = synth_profile(n_layers=8)
    port = to_port(ref)
    budget = int(rmem.build_timeline(ref).peak * 0.5)
    rcfg, pcfg = cfgs()
    assert poom.warmup_offload_sites(port, pcfg, budget) == \
        room.warmup_offload_sites(ref, rcfg, budget) == {"resid_post"}


# ------------------------- the matching half of test_matching_executor.py
def _match(mod, old, new):
    r = mod.match_instances(old, new)
    return r.mapping, r.unmatched, r.moved


@pytest.mark.parametrize("case", ["identity", "shift", "dtype_change"])
def test_matching_parity(case):
    old = synth_profile(n_layers=8, ops_per_layer=10)
    new = synth_profile(n_layers=8,
                        ops_per_layer=11 if case == "shift" else 10)
    if case == "dtype_change":
        for t in new.tensors:
            t.dtype_code = 7
    pold, pnew = to_port(old), to_port(new)
    got = _match(pmatch, pold, pnew)
    assert got == _match(rmatch, old, new)
    slow = pmatch.match_instances_reference(pold, pnew)
    assert got == (slow.mapping, slow.unmatched, slow.moved)
    if case == "dtype_change":
        assert not got[0] and len(got[1]) == 8
    else:
        assert len(got[0]) == 8
        layer = {t.uid: t.layer for t in pnew.candidates}
        assert all(layer[n] == o for o, n in got[0].items())


def test_features_are_equal_integers():
    ref = synth_profile()
    port = to_port(ref)
    got = [pmatch.pack_features(t, port.n_ops) for t in port.candidates]
    assert got == [rmatch.pack_features(t, ref.n_ops) for t in ref.candidates]
    assert all(isinstance(f, int) and f >= 0 for f in got)


def test_remap_policy_hit_rate():
    ref, new = synth_profile(t_iter=30.0), \
        synth_profile(ops_per_layer=11, t_iter=30.0)
    port, pnew = to_port(ref), to_port(new)
    rcfg, pcfg = cfgs(groups_per_phase=8)
    budget = int(rmem.build_timeline(ref).peak * 0.6)
    rp = rpol.generate_policy(ref, rcfg, budget)
    pp = ppol.generate_policy(port, pcfg, budget)
    re, rhit = rmatch.remap_policy(rp, ref, new)
    pe, phit = pmatch.remap_policy(pp, port, pnew)
    assert ([_entry(e) for e in pe], phit) == ([_entry(e) for e in re], rhit)
    assert phit >= 0.9 and {e.site for e in pe} == {e.site for e in pp.entries}


# -------------------------------------------- a fresh variant's replay (P3)
def _variants(ref, budget, knob, **kw):
    """The reference's and the port's ``AdaptationPipeline.variant`` on the
    same profile: (reference variant, port variant)."""
    from repro.adapt.pipeline import AdaptationPipeline as RPipe
    from repro.core.executor import Executor as RExec
    from repro_torch.adapt.pipeline import AdaptationPipeline as PPipe
    from repro_torch.core.executor import Executor as PExec
    rcfg, pcfg = cfgs(**kw)
    rv = RPipe(rcfg, RExec(rcfg)).variant(ref, knob, budget)
    pv = PPipe(pcfg, PExec(pcfg)).variant(to_port(ref), knob, budget)
    return rv, pv


def _applied(v):
    a = v.applied
    return (sorted(a.offload), sorted(a.save), sorted(a.remat),
            a.fingerprint, a.release_plan,
            None if v.swap is None else _policy(v.swap))


@pytest.mark.parametrize("frac", [0.9, 0.7, 0.5])
def test_variant_over_budget_replay_lowers_conservative(frac):
    """A fast step (t_iter 10 ms) leaves the swap-outs no time to finish
    before the peak: Algo 2 clears its MRL but the replay stays over the
    budget.  The reference lowers that policy; the port takes the
    conservative fallback, as under ChameleonOOMError."""
    ref = synth_profile(n_layers=4, ops_per_layer=2, t_iter=0.01)
    budget = int(frac * rmem.build_timeline(ref).peak)
    rv, pv = _variants(ref, budget, 0.25)
    assert rv.swap is not None and rv.swap.projected_peak > budget
    assert pv.swap is None and pv.knob == rv.knob
    assert pv.applied.fingerprint == "warmup-offload-all"
    assert pv.applied.offload == {"resid_post"}


@pytest.mark.parametrize("frac,knob", [(0.95, 0.25), (0.8, 0.5), (0.6, 1.0),
                                       (0.4, 0.25), (0.2, 0.5)])
def test_variant_equals_the_references_where_the_replay_fits(
        llama_profile, frac, knob):
    """Wherever the reference's fresh policy replays within the budget (or
    Algo 2 raises, or the baseline fits), the port's variant is the
    reference's: the same sites, release plan and policy entries."""
    ref = llama_profile[0]
    tl = rmem.build_timeline(ref)
    budget = int(ref.static_bytes + frac * (tl.peak - ref.static_bytes))
    rv, pv = _variants(ref, budget, knob)
    assert rv.swap is None or rv.swap.projected_peak <= budget
    assert _applied(pv) == _applied(rv) and pv.knob == rv.knob


def test_variant_equals_the_references_on_a_slow_step():
    """The synthetic profile with time to swap (t_iter 2 s): the replay
    fits and both packages lower the same policy."""
    ref = synth_profile(t_iter=2.0)
    budget = int(0.6 * rmem.build_timeline(ref).peak)
    rv, pv = _variants(ref, budget, 0.5, groups_per_phase=8)
    assert rv.swap is not None and rv.swap.projected_peak <= budget
    assert _applied(pv) == _applied(rv)
