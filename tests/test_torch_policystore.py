"""repro_torch.policystore (a numpy copy of repro.policystore): ports of
``tests/test_policystore.py`` — fingerprint stability properties, store
round-trip / eviction / corruption handling, drift-tier routing, and the
runtime integration bar (recurring sequences skip GenPolicy; a cold start
with a warm on-disk store never enters GenPolicy; shape drift re-adapts)
through the port's ``Trainer`` on the CPU — plus fingerprints of one
shared profile equal to the reference's."""
import json
import os
import shutil
import tempfile

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import torch

import repro_torch.configs as C
from repro import policystore as rps
from repro.common.config import PolicyStoreConfig as RPolicyStoreConfig
from repro_torch.common.config import (ChameleonConfig, PolicyStoreConfig,
                                       TrainConfig)
from repro_torch.core.simulator import PolicyEntry
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.hostmem.bwmodel import BandwidthModel
from repro_torch.policystore import (DriftClassifier, PolicyRecord,
                                     PolicyStore, Tier, bandwidth_drift,
                                     fingerprint_profile, fingerprint_tokens,
                                     similarity)
from repro_torch.runtime.trainer import Trainer
from tests.test_torch_planning import to_port

torch.set_num_threads(1)      # tier-1 runs several xdist workers

CFG = PolicyStoreConfig()

# tight enough that swap policies really generate for the reduced llama2
# (the port's baseline peak of the grad dispatch ~16 MiB at seq 64, inputs
# counted as its static bytes as the reference's traced program does)
BUDGET = 8 << 20


def _fp(tokens, **kw):
    return fingerprint_tokens(np.asarray(tokens, np.int32), **kw)


def _record(fp, *, budget=BUDGET, knob=1.0, kind="conservative",
            bw_curve=()):
    rec = PolicyRecord.from_policy(
        fingerprint=fp, prepare_fingerprint=fp, swap=None, candidates=[],
        n_ops=max(fp.length, 1), knob=knob, measured_t=0.1, budget=budget,
        policy_kind=kind)
    rec.bw_curve = list(bw_curve)
    return rec


def _store_with(fp, **kw):
    store = PolicyStore(PolicyStoreConfig())
    store.put(_record(fp, **kw))
    return store


# ------------------------------------------------------------ fingerprints
def test_fingerprint_identity_and_determinism():
    toks = np.arange(500) % 17 + 1
    a, b = _fp(toks), _fp(toks.copy())
    assert a.exact == b.exact
    np.testing.assert_array_equal(a.minhash, b.minhash)
    assert similarity(a, b) == 1.0


def test_fingerprint_site_bytes_separate_shape_buckets():
    """Identical token streams with different per-site byte totals (the
    seq-len bucket case) must get distinct exact keys."""
    toks = np.arange(300) % 11 + 1
    a = fingerprint_tokens(toks, {"attn_out": 1 << 20})
    b = fingerprint_tokens(toks, {"attn_out": 3 << 19})
    assert a.exact != b.exact
    assert similarity(a, b) > 0.9          # still near-identical content


def test_similarity_one_requires_exact_hash():
    """1.0 is the exclusive mark of hash equality: a token-identical
    program with different aggregates must score strictly below it (the
    reuse tier uses hash identity to gate conservative-record reuse)."""
    toks = np.arange(300) % 11 + 1
    a = fingerprint_tokens(toks, {"attn_out": 1000})
    b = fingerprint_tokens(toks)            # same tokens, no aggregates
    assert a.exact != b.exact
    assert similarity(a, b) < 1.0


def test_fingerprint_dict_roundtrip():
    fp = fingerprint_tokens(np.arange(200) % 9 + 1, {"ffn_pre": 4096})
    fp2 = type(fp).from_dict(json.loads(json.dumps(fp.to_dict())))
    assert fp2.exact == fp.exact and fp2.length == fp.length
    np.testing.assert_array_equal(fp2.minhash, fp.minhash)
    assert similarity(fp, fp2) == 1.0


@given(st.lists(st.integers(1, 25), min_size=300, max_size=600),
       st.integers(0, 6))
@settings(max_examples=25, deadline=None)
def test_minor_perturbation_stays_reuse(seq, extra):
    """<= ~2% appended ops keep the sequence in the reuse tier."""
    base = np.asarray(seq, np.int32)
    fp = _fp(base)
    store = _store_with(fp)
    perturbed = np.concatenate([base, base[: extra]])
    dec = DriftClassifier(CFG).classify(_fp(perturbed), store)
    assert dec.tier is Tier.REUSE, (dec.tier, dec.similarity, dec.reason)


@given(st.lists(st.integers(1, 25), min_size=300, max_size=600))
@settings(max_examples=25, deadline=None)
def test_layer_doubling_falls_to_regen(seq):
    """A layer-count change ~tiles the scanned region: the shingle set
    barely moves but the length gate must refuse reuse AND warm-start."""
    base = np.asarray(seq, np.int32)
    store = _store_with(_fp(base))
    doubled = np.concatenate([base, base])
    dec = DriftClassifier(CFG).classify(_fp(doubled), store)
    assert dec.tier is Tier.REGEN, (dec.tier, dec.similarity, dec.reason)


@given(st.lists(st.integers(1, 20), min_size=300, max_size=500))
@settings(max_examples=25, deadline=None)
def test_model_change_falls_to_regen(seq):
    base = np.asarray(seq, np.int32)
    store = _store_with(_fp(base))
    other = np.asarray(seq, np.int32) + 40        # disjoint op vocabulary
    dec = DriftClassifier(CFG).classify(_fp(other), store)
    assert dec.tier is Tier.REGEN


# ------------------------------------------------------------------- store
@pytest.fixture
def tmpdir():
    d = tempfile.mkdtemp()
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _swap_record(fp, n_entries=3, budget=BUDGET):
    entries = [PolicyEntry(uid=i, site="attn_out", layer=i, nbytes=1 << 16,
                           birth=10 * i, death=10 * i + 100,
                           swap_in_op=10 * i + 80, swap_out_done_op=10 * i + 5,
                           stalled=False, score=0.5 + i)
               for i in range(n_entries)]

    class _Swap:
        pass

    sw = _Swap()
    sw.entries = entries
    sw.projected_peak, sw.baseline_peak, sw.budget = 1 << 20, 2 << 20, budget
    sw.stall_time, sw.t_iter, sw.n_ops, sw.contention_s = 0.0, 0.1, 500, 0.0
    return PolicyRecord.from_policy(
        fingerprint=fp, prepare_fingerprint=fp, swap=sw, candidates=[],
        n_ops=500, knob=2.0, measured_t=0.123, budget=budget)


def test_store_disk_roundtrip(tmpdir):
    fp = _fp(np.arange(400) % 13 + 1)
    store = PolicyStore(PolicyStoreConfig(dir=tmpdir))
    store.put(_swap_record(fp))

    store2 = PolicyStore(PolicyStoreConfig(dir=tmpdir))
    assert len(store2) == 1 and store2.n_loaded == 1
    rec = store2.get_exact(fp.exact)
    assert rec is not None and rec.knob == 2.0 and rec.measured_t == 0.123
    sw = rec.swap_policy()
    assert sw is not None and len(sw.entries) == 3
    assert sw.entries[1].swap_out_done_op == 15
    assert similarity(fp, rec.prepare_fingerprint) == 1.0


def test_store_eviction_is_lru_and_removes_files(tmpdir):
    store = PolicyStore(PolicyStoreConfig(dir=tmpdir, max_records=2))
    fps = [_fp(np.arange(300) % k + 1) for k in (7, 11, 13)]
    for fp in fps:
        store.put(_record(fp))
    assert len(store) == 2 and store.n_evictions == 1
    assert store.get_exact(fps[0].exact) is None       # oldest evicted
    on_disk = {n[:-5] for n in os.listdir(tmpdir) if n.endswith(".json")}
    assert on_disk == {fps[1].exact, fps[2].exact}


def test_store_corrupt_and_wrong_schema_skipped(tmpdir):
    fp = _fp(np.arange(200) % 5 + 1)
    store = PolicyStore(PolicyStoreConfig(dir=tmpdir))
    store.put(_record(fp))
    with open(os.path.join(tmpdir, "garbage.json"), "w") as f:
        f.write("{not json!!")
    bad = _record(_fp(np.arange(100) % 3 + 1)).to_json()
    bad["schema"] = 99
    with open(os.path.join(tmpdir, "badschema.json"), "w") as f:
        json.dump(bad, f)

    store2 = PolicyStore(PolicyStoreConfig(dir=tmpdir))
    assert len(store2) == 1
    assert store2.n_corrupt == 2
    assert store2.get_exact(fp.exact) is not None


def test_store_touch_bumps_lru(tmpdir):
    store = PolicyStore(PolicyStoreConfig(dir=tmpdir, max_records=2))
    fps = [_fp(np.arange(300) % k + 1) for k in (7, 11, 13)]
    store.put(_record(fps[0]))
    store.put(_record(fps[1]))
    store.touch(store.get_exact(fps[0].exact))         # 0 now most recent
    store.put(_record(fps[2]))                         # evicts 1, not 0
    assert store.get_exact(fps[0].exact) is not None
    assert store.get_exact(fps[1].exact) is None
    assert store.get_exact(fps[0].exact).uses == 1


def test_readonly_store_never_deletes_shared_records(tmpdir):
    """A serving process attaching a shared training store with a smaller
    capacity must not evict other writers' on-disk records."""
    writer = PolicyStore(PolicyStoreConfig(dir=tmpdir))
    fps = [_fp(np.arange(300) % k + 1) for k in (7, 11, 13)]
    for fp in fps:
        writer.put(_record(fp))
    reader = PolicyStore(PolicyStoreConfig(dir=tmpdir, max_records=2),
                         readonly=True)
    assert len(reader) == 2                         # memory side trimmed
    on_disk = [n for n in os.listdir(tmpdir) if n.endswith(".json")]
    assert len(on_disk) == 3                        # disk side untouched
    reader.touch(reader.records()[0])               # no writes either
    assert len([n for n in os.listdir(tmpdir) if n.endswith(".json")]) == 3


def test_nearest_exact_key_fast_path():
    fp = _fp(np.arange(400) % 13 + 1)
    store = _store_with(fp)
    rec, sim = store.nearest(fp)
    assert sim == 1.0 and rec.key == fp.exact
    assert store.n_exact_hits == 1 and store.n_sim_hits == 0


def test_nearest_below_warm_floor_counts_as_miss():
    """A best match the classifier can't use must not report as a hit."""
    fp = _fp(np.arange(400) % 13 + 1)
    store = _store_with(fp)
    unrelated = _fp(np.arange(400) % 7 + 60)
    rec, sim = store.nearest(unrelated)
    assert rec is not None and sim < CFG.warm_threshold
    assert store.n_misses == 1 and store.n_sim_hits == 0
    store.nearest(fp)
    assert store.n_exact_hits == 1


def test_projected_peak_replay():
    """The reuse tier re-verifies a remapped schedule with the same
    timeline replay generate_policy prices a fresh one with."""
    from repro_torch.core.policy import projected_peak
    from repro_torch.core.profiler import ProfileData, TensorInstance
    tensors = [TensorInstance(0, 100, birth=1, death=9, site="a"),
               TensorInstance(1, 100, birth=3, death=6, site="a")]
    prof = ProfileData(np.zeros(10, np.int32), tensors, t_iter=0.1,
                       static_bytes=7)
    assert projected_peak(prof, []) == 207          # both live at op 3
    e = PolicyEntry(uid=0, site="a", layer=0, nbytes=100, birth=1, death=9,
                    swap_in_op=8, swap_out_done_op=2)
    assert projected_peak(prof, [e]) == 107         # t0 absent during [2,8)


# ------------------------------------------------------------------- drift
def test_budget_mismatch_caps_reuse_at_warm_start():
    fp = _fp(np.arange(400) % 13 + 1)
    store = _store_with(fp, budget=8 << 20)
    dec = DriftClassifier(CFG).classify(fp, store, budget=16 << 20)
    assert dec.tier is Tier.WARM_START and "budget" in dec.reason


def test_bandwidth_drift_guard():
    fp = _fp(np.arange(400) % 13 + 1)
    snapshot = [(1 << 20, 1e-4), (1 << 22, 4e-4)]
    store = _store_with(fp, bw_curve=snapshot)
    rec = store.records()[0]

    drifted = BandwidthModel(32.0)
    drifted.observe(1 << 20, 1e-3)          # 10x slower than the snapshot
    drifted.observe(1 << 22, 4e-3)
    assert bandwidth_drift(rec, drifted) > CFG.bw_drift_limit
    dec = DriftClassifier(CFG).classify(fp, store, bwmodel=drifted)
    assert dec.tier is Tier.WARM_START and "bw_drift" in dec.reason

    # an uncalibrated live model is the constant fallback, not drift
    assert bandwidth_drift(rec, BandwidthModel(32.0)) == 1.0
    dec2 = DriftClassifier(CFG).classify(fp, store,
                                         bwmodel=BandwidthModel(32.0))
    assert dec2.tier is Tier.REUSE


def test_demote_counts():
    dc = DriftClassifier(CFG)
    fp = _fp(np.arange(100) % 5 + 1)
    dec = dc.classify(fp, _store_with(fp))
    dec2 = dc.demote(dec, "match-miss")
    assert dec2.tier is Tier.WARM_START
    assert dc.counters["demoted"] == 1 and dc.counters["warm_start"] == 1
    # the failed reuse is taken back: tiers sum to the adaptation count
    assert dc.counters["reuse"] == 0


# ------------------------------------------------- runtime integration bar
# eval period must exceed one cold adaptation (m warmup + n genpolicy
# steps ~ 9-10) or the first adaptation never completes and stores
def _trainer(store_dir, ckdir, *, steps=40, eval_every=13, seed=0):
    cfg = C.get_reduced("llama2_paper")
    tcfg = TrainConfig(steps=steps, checkpoint_every=0, checkpoint_dir=ckdir,
                       eval_every=eval_every, warmup_steps=2,
                       learning_rate=1e-3)
    cham = ChameleonConfig(
        enabled=True, hbm_budget_bytes=BUDGET,
        policystore=PolicyStoreConfig(enabled=store_dir is not None,
                                      dir=store_dir or ""))
    data = SyntheticTokens(cfg.vocab_size, 64, 4, seed=seed)
    return Trainer(cfg, tcfg, cham, data=data, device="cpu")


@pytest.fixture(scope="module")
def warm_run():
    """One store-backed training run with eval interleave (shared by the
    recurring-sequence and cold-restart tests)."""
    store_dir, ckdir = tempfile.mkdtemp(), tempfile.mkdtemp()
    tr = _trainer(store_dir, ckdir)
    rep = tr.train(40)
    yield store_dir, tr, rep
    shutil.rmtree(store_dir, ignore_errors=True)
    shutil.rmtree(ckdir, ignore_errors=True)


def test_recurring_sequence_skips_genpolicy(warm_run, tmpdir):
    """ISSUE 4 acceptance: train->eval->train with the store enabled takes
    strictly fewer GenPolicy steps than with it disabled, and the math is
    unchanged."""
    _store_dir, tr_on, rep_on = warm_run
    tr_off = _trainer(None, tmpdir)
    rep_off = tr_off.train(40)
    assert rep_on.genpolicy_steps < rep_off.genpolicy_steps, (
        rep_on.genpolicy_steps, rep_off.genpolicy_steps)
    tiers = rep_on.policystore["tiers"]
    assert tiers["reuse"] + tiers["warm_start"] >= 1
    assert rep_off.policystore is None
    # the reference allows 2e-4; the executor's swaps are byte copies
    assert rep_on.losses == rep_off.losses
    # reuse adaptations recover in strictly fewer steps than cold ones
    on_steps = [a["steps"] for a in rep_on.policystore["adaptations"]
                if a["tier"] == "reuse"]
    off_steps = [a["steps"] for a in tr_off.rt.adaptations]
    if on_steps and off_steps:
        assert max(on_steps) < min(s for s in off_steps if s > 0)


def test_cold_restart_applies_cached_policy(warm_run, tmpdir):
    """ISSUE 4 acceptance: a cold-started process with a warm on-disk
    store applies a cached policy without entering GenPolicy."""
    store_dir, _tr, _rep = warm_run
    tr = _trainer(store_dir, tmpdir, steps=8, eval_every=0)
    assert len(tr.rt.store) >= 1           # loaded from disk
    rep = tr.train(8)
    assert rep.genpolicy_steps == 0, rep.stages
    assert set(rep.stages) == {"Stable"}
    assert rep.policystore["tiers"]["reuse"] >= 1
    assert rep.policystore["store"]["loaded"] >= 1


def test_shape_drift_triggers_readaptation(tmpdir):
    """Seq-len bucket switches are invisible to the token stream; the
    runtime must still re-enter WarmUp (and the store must key the two
    buckets separately)."""
    tr = _trainer(os.path.join(tmpdir, "store"),
                  os.path.join(tmpdir, "ck"), steps=24, eval_every=0)
    cfg = tr.cfg
    other = SyntheticTokens(cfg.vocab_size, 96, 4, seed=1)

    def hook(step):
        if step == 11:
            tr.data = other

    rep = tr.train(24, fault_hook=hook)
    assert any(why == "shape-change"
               for _s, why, _to in tr.rt.machine.transitions), \
        tr.rt.machine.transitions
    assert not rep.failures
    assert len(tr.rt.store) >= 1


# ------------------------------------------------- parity with the reference
def test_fingerprints_of_a_shared_profile_equal_the_references(
        llama_profile):
    ref, _ = llama_profile
    port = to_port(ref)
    for kw in ({}, {"n_perms": 32, "shingle": 3}):
        a = rps.fingerprint_profile(ref, **kw)
        b = fingerprint_profile(port, **kw)
        assert b.to_dict() == a.to_dict()


@given(st.lists(st.integers(1, 40), min_size=50, max_size=400),
       st.integers(1, 6))
@settings(max_examples=20, deadline=None)
def test_similarity_and_tiers_equal_the_references(seq, cut):
    toks = np.asarray(seq, np.int32)
    other = np.concatenate([toks[cut:], toks[:cut]])
    ra, rb = (rps.fingerprint_tokens(t, cache=False) for t in (toks, other))
    pa, pb = (fingerprint_tokens(t, cache=False) for t in (toks, other))
    assert pa.to_dict() == ra.to_dict() and pb.to_dict() == rb.to_dict()
    assert similarity(pa, pb) == rps.similarity(ra, rb)
    rstore = rps.PolicyStore(RPolicyStoreConfig())
    pstore = PolicyStore(PolicyStoreConfig())
    rstore.put(rps.PolicyRecord.from_policy(
        fingerprint=ra, prepare_fingerprint=ra, swap=None, candidates=[],
        n_ops=len(toks), knob=1.0, measured_t=0.1, budget=BUDGET,
        policy_kind="conservative"))
    pstore.put(PolicyRecord.from_policy(
        fingerprint=pa, prepare_fingerprint=pa, swap=None, candidates=[],
        n_ops=len(toks), knob=1.0, measured_t=0.1, budget=BUDGET,
        policy_kind="conservative"))
    rd = rps.DriftClassifier(RPolicyStoreConfig()).classify(rb, rstore)
    pd = DriftClassifier(CFG).classify(pb, pstore)
    assert (pd.tier.value, pd.similarity, pd.reason) == (
        rd.tier.value, rd.similarity, rd.reason)
