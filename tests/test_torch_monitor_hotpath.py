"""Monitoring hot path of the port (``repro_torch.core`` matching, tokenizer
signatures and simulator; ``repro_torch.policystore`` LSH index): the cases
of ``tests/test_monitor_hotpath.py`` that the port's other tests lack, each
held against the reference on the same inputs.

* **parity** — the vectorized implementations against their kept plain
  versions (``match_instances`` vs ``match_instances_reference``, the
  incremental ``SignatureAccumulator`` vs a from-scratch histogram, the
  LSH-probed ``nearest`` vs ``nearest_exhaustive``) and against the
  reference's functions on the same profiles, streams and records;
* **guards** — operation counters, not wall clock: the signature update
  does work proportional to the *changed* dispatches, and ``nearest`` at
  1k records evaluates far fewer similarities than the record count.

The scan-capped virtual-length cases need a traced ``lax.scan``; an eager
op stream has no scans, so they are not ported.
"""
import copy
import json
import os
import shutil
import tempfile

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro import policystore as rps
from repro.common.config import ChameleonConfig as RCfg
from repro.common.config import PolicyStoreConfig as RPSCfg
from repro.core import matching as rmatch
from repro.core import simulator as rsim
from repro.core import tokenizer as rtok
from repro.core.profiler import ProfileData as RProfile
from repro.core.profiler import TensorInstance as RTensor
from repro_torch import policystore as pps
from repro_torch.common.config import ChameleonConfig as PCfg
from repro_torch.common.config import PolicyStoreConfig as PPSCfg
from repro_torch.core import matching as pmatch
from repro_torch.core import simulator as psim
from repro_torch.core import tokenizer as ptok
from repro_torch.core.candidates import Candidate, build_candidate_list
from repro_torch.core.memtrace import build_timeline
from repro_torch.core.mrl import MRL
from repro_torch.core.stages import Stage, StageMachine
from tests.test_torch_planning import synth_profile, to_port

SITES = ("attn_out", "ffn_pre", "resid_post", "qkv_proj", "moe_gate")


# ------------------------------------------------------------------ helpers
def _rand_profile(seed, n_sites, n_layers, per, jitter, dtype_seed):
    """tests/test_monitor_hotpath.py::_rand_profile, in the reference's
    classes (``to_port`` gives the port's)."""
    r = np.random.RandomState(seed)
    tensors = []
    uid = 0
    n_ops = max(n_sites * n_layers * per, 1)
    for s in range(n_sites):
        shape = (32 + s, 8 * (1 + s % 3))
        for l in range(n_layers):
            birth = min((s * n_layers + l) * per
                        + int(r.randint(0, jitter + 1)), n_ops - 1)
            tensors.append(RTensor(
                uid, 1 << 16, birth, n_ops - birth, site=SITES[s % len(SITES)],
                layer=l, dtype_code=1 + (s + dtype_seed) % 3, shape=shape))
            uid += 1
    # a few duplicate-feature instances exercise the greedy bucket order
    for extra in range(min(n_layers, 3)):
        t = tensors[extra]
        tensors.append(RTensor(
            uid, t.nbytes, min(t.birth + 1, n_ops - 1), t.death,
            site=t.site, layer=t.layer, dtype_code=t.dtype_code,
            shape=t.shape))
        uid += 1
    return RProfile(np.zeros(n_ops, np.int32), tensors, 1.0, 0)


def _empty():
    return RProfile(np.zeros(4, np.int32), [], 1.0, 0)


def _match(mod, old, new, tol, ref_impl=False):
    fn = mod.match_instances_reference if ref_impl else mod.match_instances
    r = fn(old, new, tol)
    return r.mapping, r.unmatched, r.moved


def _assert_match_parity(old, new, tol=16):
    """The port's vectorized match equals its plain version and the
    reference's match of the same profiles."""
    pold, pnew = to_port(old), to_port(new)
    got = _match(pmatch, pold, pnew, tol)
    assert got == _match(pmatch, pold, pnew, tol, ref_impl=True)
    assert got == _match(rmatch, old, new, tol)


def _record(mod, fp):
    return mod.PolicyRecord.from_policy(
        fingerprint=fp, prepare_fingerprint=fp, swap=None, candidates=[],
        n_ops=max(fp.length, 1), knob=1.0, measured_t=0.1, budget=1 << 30,
        policy_kind="conservative")


def _stores(streams, max_records=256, dirs=(None, None)):
    """The same streams' records in a reference and a port store."""
    stores = []
    for mod, cfg, d in ((rps, RPSCfg, dirs[0]), (pps, PPSCfg, dirs[1])):
        store = mod.PolicyStore(cfg(max_records=max_records, dir=d or ""))
        for t in streams:
            store.put(_record(mod, mod.fingerprint_tokens(t, cache=False)))
        stores.append(store)
    return stores


def _nearest_both(stores, tokens):
    """(key, similarity) of ``nearest`` and of ``nearest_exhaustive`` in
    each store."""
    out = []
    for store, mod in zip(stores, (rps, pps)):
        q = mod.fingerprint_tokens(tokens, cache=False)
        rec, sim = store.nearest(q)
        ex_rec, ex_sim = store.nearest_exhaustive(q)
        out.append(((rec.key if rec else None, sim),
                    (ex_rec.key if ex_rec else None, ex_sim)))
    return out


# ----------------------------------------------------- matching: parity
@given(st.integers(0, 10_000), st.integers(1, 5), st.integers(1, 10),
       st.integers(2, 16), st.integers(0, 30))
@settings(max_examples=40, deadline=None)
def test_match_parity_random_pairs(seed, n_sites, n_layers, per, jitter):
    old = _rand_profile(seed, n_sites, n_layers, per, jitter=0, dtype_seed=0)
    new = _rand_profile(seed + 1, n_sites, n_layers, per + 1, jitter=jitter,
                        dtype_seed=0)
    _assert_match_parity(old, new)


@given(st.integers(0, 10_000), st.integers(1, 4), st.integers(1, 8))
@settings(max_examples=20, deadline=None)
def test_match_parity_structural_drift(seed, n_sites, n_layers):
    """Dtype changes, layer-count changes and empty sides agree with the
    plain version and the reference too (all-unmatched cases included)."""
    old = _rand_profile(seed, n_sites, n_layers, 8, 0, dtype_seed=0)
    new = _rand_profile(seed, n_sites, max(n_layers - 1, 1), 8, 2,
                        dtype_seed=1)     # shifted dtype codes
    _assert_match_parity(old, new)
    _assert_match_parity(old, _empty())
    _assert_match_parity(_empty(), new)


def test_match_tolerance_zero_and_features_cached():
    old = _rand_profile(3, 3, 6, 10, 0, 0)
    new = _rand_profile(4, 3, 6, 10, 5, 0)
    _assert_match_parity(old, new, tol=0)
    pold = to_port(old)
    feats = pmatch.candidate_feature_arrays(pold)
    assert pmatch.candidate_feature_arrays(pold) is feats   # lazily cached
    assert pold.feature_arrays() is feats
    ref = rmatch.candidate_feature_arrays(old)
    for field in ("uids", "key", "pos", "layer", "birth"):
        np.testing.assert_array_equal(getattr(feats, field),
                                      getattr(ref, field))


def test_feature_cache_dropped_on_tensor_replacement():
    """A shallow copy whose ``tensors`` are replaced must not leak the old
    instances through the derived candidate / feature caches."""
    prof = to_port(_rand_profile(5, 2, 4, 8, 0, 0))
    _ = prof.candidates                     # populate caches
    prof.feature_arrays()
    prof2 = copy.copy(prof)
    prof2.tensors = prof.tensors[:3]
    assert len(prof2.candidates) == 3
    assert prof2.feature_arrays().n == 3
    assert len(prof.candidates) == len(prof.tensors)  # original intact


# ------------------------------------------ incremental signature: parity
@st.composite
def _stream_lists(draw):
    n = draw(st.integers(1, 5))
    return [draw(st.lists(st.integers(1, 30), min_size=0, max_size=120))
            for _ in range(n)]


@given(_stream_lists(), _stream_lists())
@settings(max_examples=40, deadline=None)
def test_signature_accumulator_matches_scratch(lists_a, lists_b):
    """The port's incremental signature equals a from-scratch histogram
    and the reference accumulator's, update for update."""
    acc, racc = ptok.SignatureAccumulator(), rtok.SignatureAccumulator()
    for lists in (lists_a, lists_b, lists_a):
        sig = acc.update([ptok.TokenStream(np.asarray(l, np.int32))
                          for l in lists])
        rsig = racc.update([rtok.TokenStream(np.asarray(l, np.int32))
                            for l in lists])
        concat = (np.concatenate([np.asarray(l, np.int32) for l in lists])
                  if any(lists) else np.zeros(0, np.int32))
        assert sig.length == concat.size == rsig.length
        ref_hist = ptok.token_histogram(concat)
        m = max(sig.hist.size, ref_hist.size, rsig.hist.size)
        pad = lambda h: np.pad(h, (0, m - h.size))
        np.testing.assert_array_equal(pad(sig.hist), pad(ref_hist))
        np.testing.assert_array_equal(pad(sig.hist), pad(rsig.hist))
        np.testing.assert_array_equal(sig.materialize(), concat)
    assert acc.stats() == racc.stats()


@given(_stream_lists(), _stream_lists())
@settings(max_examples=30, deadline=None)
def test_sig_similarity_matches_legacy_and_reference(lists_a, lists_b):
    cat = lambda ls: np.concatenate(
        [np.asarray(l, np.int32) for l in ls] or [np.zeros(0, np.int32)])
    sa, sb = (ptok.Signature.from_tokens(cat(ls)) for ls in (lists_a,
                                                            lists_b))
    ld, cos = ptok.sig_similarity(sa, sb)
    ld_plain, cos_plain = ptok.similarity(sa.materialize(), sb.materialize())
    ld_ref, cos_ref = rtok.sig_similarity(
        rtok.Signature.from_tokens(cat(lists_a)),
        rtok.Signature.from_tokens(cat(lists_b)))
    assert ld == pytest.approx(ld_plain, abs=1e-12) and ld == ld_ref
    assert cos == pytest.approx(cos_plain, abs=1e-12) and cos == cos_ref


def test_stage_machine_accepts_signatures():
    cfg = PCfg(m_warmup_stable=1, n_genpolicy_steps=1)
    sm = StageMachine(cfg)
    acc = ptok.SignatureAccumulator()
    s = ptok.TokenStream(np.array([1, 2, 3] * 50, np.int32))
    for i in range(6):
        sm.observe(acc.update([s]), i)
    assert sm.stage is Stage.STABLE
    grown = ptok.TokenStream(
        np.array([1, 2, 3] * 50 + [7, 8, 9] * 30, np.int32))
    assert sm.observe(acc.update([grown]), 6) is Stage.WARMUP


def test_degenerate_token_ids_bounded():
    """Huge token ids must not size the histogram by the largest id; the
    similarity equals the reference's."""
    a = np.array([1, 2, (1 << 31) - 5], np.int64)
    b = np.array([1, 2, 3], np.int64)
    ld, cos = ptok.similarity(a, b)
    assert 0.0 <= ld <= 1.0 and 0.0 <= cos <= 1.0
    assert (ld, cos) == rtok.similarity(a, b)
    hist = ptok.token_histogram(a)
    assert hist.size <= ptok.MAX_DENSE_TOKEN + 1


# ----------------------------------------------------- LSH: recall/parity
@pytest.fixture(scope="module")
def lsh_stores():
    rng = np.random.RandomState(42)
    streams = [rng.randint(1, 50, size=300 + (i % 7) * 10).astype(np.int32)
               for i in range(120)]
    return _stores(streams), streams


def test_lsh_nearest_recall_above_floor(lsh_stores):
    """Every perturbed recurrence of a stored stream is found at a
    similarity no worse than the exhaustive scan's (recall 1.0 above the
    floor); below the reuse floor the result is identical; and the port's
    answers are the reference's."""
    stores, streams = lsh_stores
    cfg = stores[1].cfg
    rng = np.random.RandomState(7)
    found = total = 0
    for i in range(0, 120, 5):
        base = streams[i]
        t = np.concatenate([base, base[: rng.randint(0, 8)]])
        ref, port = _nearest_both(stores, t)
        assert port == ref
        (_, sim), (_, ex_sim) = port
        if ex_sim >= cfg.warm_threshold:
            total += 1
            if sim >= min(ex_sim, cfg.reuse_threshold) - 1e-12:
                found += 1
        if ex_sim < cfg.reuse_threshold:    # fallback ran: exact parity
            assert sim == pytest.approx(ex_sim, abs=1e-12)
    assert total > 0
    assert found == total                  # recall 1.0 above the floor


def test_lsh_nearest_miss_is_exhaustive_exact(lsh_stores):
    stores, _ = lsh_stores
    ref, port = _nearest_both(stores,
                              np.arange(400, dtype=np.int32) % 9 + 200)
    assert port == ref
    (_, sim), (_, ex_sim) = port
    assert sim == pytest.approx(ex_sim, abs=1e-12)
    assert sim < stores[1].cfg.warm_threshold


def test_lsh_index_tracks_puts_and_evictions():
    streams = [np.arange(200, dtype=np.int32) % k + 1
               for k in (5, 7, 11, 13, 17, 19)]
    ref, port = _stores(streams, max_records=4)
    assert len(port.index) == 4            # evicted keys removed
    assert port.index.keys() == set(r.key for r in port.records())
    assert port.index.keys() == ref.index.keys()


def test_lsh_index_persistence_and_rebuild():
    """The persisted index is used as-is on a clean reload and rebuilt
    when it is corrupt or missing, as in the reference; the port's index
    file holds the reference's entries."""
    dirs = (tempfile.mkdtemp(), tempfile.mkdtemp())
    try:
        streams = [np.arange(300, dtype=np.int32) % k + 1 for k in (5, 9, 13)]
        ref, port = _stores(streams, dirs=dirs)
        paths = [os.path.join(d, "lsh.index") for d in dirs]
        assert all(os.path.exists(p) for p in paths)
        with open(paths[0]) as f, open(paths[1]) as g:
            assert json.load(f) == json.load(g)

        cfg = PPSCfg(dir=dirs[1])
        q = pps.fingerprint_tokens(np.arange(300, dtype=np.int32) % 9 + 1,
                                   cache=False)
        store2 = pps.PolicyStore(cfg)      # clean reload: no rebuild
        assert store2.n_index_rebuilds == 0
        assert store2.index.keys() == set(r.key for r in store2.records())
        assert store2.nearest(q)[1] == 1.0

        with open(paths[1], "w") as f:     # corrupt: rebuilt from records
            f.write("{broken")
        store3 = pps.PolicyStore(cfg)
        assert store3.n_index_rebuilds == 1
        assert store3.nearest(q)[1] == 1.0

        os.remove(paths[1])                # missing: same story
        store4 = pps.PolicyStore(cfg)
        assert store4.n_index_rebuilds == 1
        assert os.path.exists(paths[1])    # re-persisted
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


def test_lsh_index_json_roundtrip():
    rng = np.random.RandomState(0)
    sigs = {f"k{i}": rng.randint(0, 1 << 30, size=64).astype(np.int64)
            for i in range(10)}
    idx, ridx = pps.LSHIndex(64, 16), rps.LSHIndex(64, 16)
    for k, s in sigs.items():
        idx.add(k, (s,))
        ridx.add(k, (s,))
    assert idx.to_json() == ridx.to_json()
    idx2 = pps.LSHIndex.from_json(json.loads(json.dumps(idx.to_json())))
    for k, s in sigs.items():
        assert k in idx2.query(s)
        assert idx2.query(s) == ridx.query(s)


# ------------------------------------------------- operation-count guards
def test_guard_signature_work_proportional_to_changed_dispatches():
    """Histogram work only for changed slots: an unchanged iteration costs
    zero update tokens, a one-dispatch change exactly that dispatch's old
    + new length; the reference's counters agree."""
    rng = np.random.RandomState(0)
    toks = [rng.randint(1, 90, size=2000).astype(np.int32) for _ in range(8)]
    accs = []
    for mod in (ptok, rtok):
        streams = [mod.TokenStream(t) for t in toks]
        acc = mod.SignatureAccumulator()
        acc.update(streams)
        base_tokens = acc.update_tokens
        for _ in range(5):                  # steady state: zero array work
            acc.update(streams)
        assert acc.update_tokens == base_tokens
        assert acc.changed_slots == len(streams)
        changed = list(streams)
        changed[3] = mod.TokenStream(np.arange(1500, dtype=np.int32) % 89 + 1)
        acc.update(changed)
        assert acc.changed_slots == len(streams) + 1
        assert (acc.update_tokens - base_tokens
                == streams[3].virtual_len + changed[3].virtual_len)
        accs.append(acc.stats())
    assert accs[0] == accs[1]


def test_guard_nearest_probe_count_at_1k_records():
    """At 1k records a recurring-stream lookup evaluates the full
    similarity for a tiny fraction of the store, and finds what the
    reference finds."""
    rng = np.random.RandomState(3)
    streams = [rng.randint(1, 40, size=350).astype(np.int32)
               for _ in range(1000)]
    ref, port = _stores(streams, max_records=1024)
    assert len(port) == 1000
    base = streams[700]
    q = np.concatenate([base, base[:4]])
    port.n_sim_evals = 0
    rec, sim = port.nearest(pps.fingerprint_tokens(q, cache=False))
    rrec, rsim = ref.nearest(rps.fingerprint_tokens(q, cache=False))
    assert (rec.key, sim) == (rrec.key, rsim)
    assert sim >= port.cfg.reuse_threshold
    assert port.n_sim_evals <= 32, port.n_sim_evals   # << 1000 records


def test_guard_runtime_signature_stats_exposed():
    from repro_torch.core.runtime import ChameleonRuntime
    rt = ChameleonRuntime(PCfg(enabled=False), lambda policy: None,
                          device="cpu")
    assert set(rt.stats()["signature"]) == {"iterations", "changed_slots",
                                            "update_tokens"}


# ------------------------------------------------- simulator search parity
@given(st.integers(0, 500), st.integers(2, 12), st.integers(4, 16),
       st.integers(1, 40))
@settings(max_examples=25, deadline=None)
def test_simulator_backward_search_parity(seed, n_layers, groups, res_mb):
    """The vectorized backward search picks exactly the layer the plain
    loop would, and the reference simulator's swap-in op."""
    rng = np.random.RandomState(seed)
    ref = synth_profile(n_layers=n_layers, ops_per_layer=10,
                        res_bytes=res_mb << 20,
                        t_iter=float(rng.uniform(0.01, 10.0)))
    prof = to_port(ref)
    sim = psim.Simulator(prof, prof.n_ops // 2, PCfg(groups_per_phase=groups))
    rs = rsim.Simulator(ref, ref.n_ops // 2, RCfg(groups_per_phase=groups))
    peak_layer = sim.layer_of(sim.peak_op)
    from repro.core.candidates import Candidate as RCandidate
    for t, rt_ in zip(prof.tensors, ref.tensors):
        ts = sim.t_swap(t.nbytes)
        expect = None
        for li in range(sim.layer_of(t.death) - 1, peak_layer, -1):
            if sim.layers[li].remaining_time > ts:    # the plain loop
                expect = li
                break
        e = sim.place_swap_in(Candidate(t, 1, 1.0))
        re_ = rs.place_swap_in(RCandidate(rt_, 1, 1.0))
        if expect is None:
            assert e is None and re_ is None
        else:
            assert e.swap_in_op == sim.layers[expect].start_op
            assert e.swap_in_op == re_.swap_in_op


def test_simulator_forward_search_parity():
    """The vectorized forward search (swap-out completion) equals the
    plain loop replayed on a fresh simulator, and the reference's."""
    ref = synth_profile(t_iter=10.0)
    prof = to_port(ref)
    cfg = PCfg(groups_per_phase=8)
    sim = psim.Simulator(prof, prof.n_ops // 2, cfg)
    tl = build_timeline(prof)
    mrl = MRL.from_timeline(tl, int(tl.peak * 0.6))
    entries = sim.simulate(build_candidate_list(prof, mrl, cfg), mrl)
    plain = psim.Simulator(prof, prof.n_ops // 2, cfg)
    for e in entries:                       # reapply swap-in budget spend
        li = plain.layer_of(e.swap_in_op)
        plain.layers[li].remaining_time -= plain.t_swap(e.nbytes)
    expected = {}
    for e in sorted(entries, key=lambda e: e.birth):
        ts = plain.t_swap(e.nbytes)
        done = None
        for lj in range(plain.layer_of(e.birth), len(plain.layers)):
            if plain.layers[lj].remaining_time > ts:
                plain.layers[lj].remaining_time -= ts
                done = plain.layers[lj]
                break
        if done is None:
            done = plain.layers[plain.layer_of(plain.peak_op)]
        expected[e.uid] = done.end_op
    sim.set_free_time(entries)
    assert {e.uid: e.swap_out_done_op for e in entries} == expected

    from repro.core.candidates import build_candidate_list as rbuild
    from repro.core.memtrace import build_timeline as rtimeline
    from repro.core.mrl import MRL as RMRL
    rs = rsim.Simulator(ref, ref.n_ops // 2, RCfg(groups_per_phase=8))
    rtl = rtimeline(ref)
    rmrl = RMRL.from_timeline(rtl, int(rtl.peak * 0.6))
    rentries = rs.simulate(rbuild(ref, rmrl, RCfg(groups_per_phase=8)), rmrl)
    rs.set_free_time(rentries)
    assert ({e.uid: e.swap_out_done_op for e in rentries}
            == {e.uid: e.swap_out_done_op for e in entries})
