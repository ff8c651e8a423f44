"""Multi-feature fuzzy matching (paper §6.1 + Appendix A).

A numpy copy of ``repro/core/matching.py``: given one ``ProfileData`` it
computes what the reference computes, bit for bit
(``tests/test_torch_planning.py``).

Across retraces there are no stable tensor identities; policy entries are
re-associated with the new program's site instances using integer-only
feature comparison (the paper's trick: one-hot operator tags + bit-packed
call stacks instead of string compares).

Features per instance, packed into a single int64:
  bits  0..31  site one-hot   (site vocabulary maps to 32 bits, like the
                               paper's "32 most frequent operators")
  bits 32..39  dtype code
  bits 40..55  shape hash     (16-bit product/dim mix)
  bits 56..63  position bucket (birth op / n_ops quantized to 256)

Exact match requires identical site bit + dtype + shape hash; position may
drift by up to ``pos_tolerance`` buckets (minor sequence changes shift op
indices slightly — the tolerance is what lets Chameleon ride out small
changes without regenerating the policy).

Hot path: :func:`match_instances` is array-native.  All candidate features
are packed into int64 numpy arrays **once per profile** (lazily, cached on
the profile object), new candidates are sorted/grouped by their exact-mask
key, and the position-tolerance assignment resolves per bucket with array
ops — no per-pair ``pack_features`` calls.  The original per-instance
Python loop survives as :func:`match_instances_reference`; property tests
(tests/test_monitor_hotpath.py) prove the two produce identical results.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.profiler import ProfileData, TensorInstance
from repro_torch.core.sites import SITE_INDEX


def _site_bit(site: Optional[str]) -> int:
    if site is None:
        return 0
    return 1 << (SITE_INDEX.get(site, hash(site) & 31) % 32)


def _shape_hash(shape: Tuple[int, ...]) -> int:
    h = 0
    for d in shape:
        h = (h * 131 + d) & 0xFFFF
    return h


def pack_features(t: TensorInstance, n_ops: int) -> int:
    pos = min(int(t.birth * 256 / max(n_ops, 1)), 255)
    return (_site_bit(t.site)
            | (t.dtype_code & 0xFF) << 32
            | _shape_hash(t.shape) << 40
            | pos << 56)


_EXACT_MASK = (1 << 56) - 1          # site | dtype | shape
_POS_SHIFT = 56
_NO_MATCH = np.int64(1) << 40       # larger than any reachable distance


@dataclass
class CandidateFeatures:
    """Candidate features of one profile as flat int64 arrays (one row per
    candidate, in ``prof.candidates`` order)."""
    uids: np.ndarray                 # int64
    key: np.ndarray                  # int64, exact-mask features (bits 0..55)
    pos: np.ndarray                  # int64, position bucket 0..255
    layer: np.ndarray                # int64
    birth: np.ndarray                # int64

    @property
    def n(self) -> int:
        return int(self.uids.size)


def candidate_feature_arrays(prof) -> CandidateFeatures:
    """Feature arrays for ``prof.candidates``, computed once and cached on
    the profile object (works for :class:`ProfileData` and the store's
    profile stubs alike).  The base key per unique (site, dtype, shape) is
    memoized, so repeated shapes across layers — the common case — cost one
    dict hit each; position buckets come from one vectorized expression.
    The cache assumes candidates are not mutated afterwards."""
    cached = getattr(prof, "_cand_feat_cache", None)
    if cached is not None:
        return cached
    cands = prof.candidates
    n = len(cands)
    n_ops = max(int(prof.n_ops), 1)
    uids = np.fromiter((t.uid for t in cands), np.int64, n)
    births = np.fromiter((t.birth for t in cands), np.int64, n)
    layers = np.fromiter((t.layer for t in cands), np.int64, n)
    base = np.empty(n, np.int64)
    memo: Dict[Tuple, int] = {}
    for i, t in enumerate(cands):
        mk = (t.site, t.dtype_code, t.shape)
        b = memo.get(mk)
        if b is None:
            b = (_site_bit(t.site)
                 | (t.dtype_code & 0xFF) << 32
                 | _shape_hash(t.shape) << 40)
            memo[mk] = b
        base[i] = b
    pos = np.minimum(births * 256 // n_ops, 255)
    feats = CandidateFeatures(uids, base, pos, layers, births)
    try:
        prof._cand_feat_cache = feats
    except AttributeError:
        pass                          # slotted stub: just skip caching
    return feats


@dataclass
class MatchResult:
    mapping: Dict[int, int]          # old uid -> new uid
    unmatched: List[int]             # old uids with no counterpart
    moved: int                       # matched but position drifted


def match_instances(old: ProfileData, new: ProfileData,
                    pos_tolerance: int = 16) -> MatchResult:
    """Associate old candidate instances with new ones (integer compares
    only; layer index breaks ties among identical features).

    Array-native: new candidates are lex-sorted by (key, layer, birth) so
    each old candidate resolves against one contiguous bucket with a single
    vectorized distance/argmin, exactly reproducing the reference greedy
    assignment (first minimum in (layer, birth) order wins)."""
    of = candidate_feature_arrays(old)
    nf = candidate_feature_arrays(new)
    if of.n == 0:
        return MatchResult({}, [], 0)
    if nf.n == 0:
        return MatchResult({}, [int(u) for u in of.uids], 0)

    order = np.lexsort((nf.birth, nf.layer, nf.key))
    skey = nf.key[order]
    spos = nf.pos[order]
    slayer = nf.layer[order]
    suid = nf.uids[order]

    # group old candidates by key too (stable: preserves candidate order
    # within a bucket, which is what the greedy tie-break depends on; the
    # buckets themselves are independent, so bucket order is free)
    oorder = np.argsort(of.key, kind="stable")
    okey = of.key[oorder]
    runs = np.flatnonzero(np.diff(okey)) + 1
    ostarts = np.concatenate([[0], runs, [of.n]])

    lo = np.searchsorted(skey, okey[ostarts[:-1]], side="left")
    hi = np.searchsorted(skey, okey[ostarts[:-1]], side="right")

    mapping: Dict[int, int] = {}
    unmatched: List[Tuple[int, int]] = []       # (orig old index, uid)
    moved = 0
    for bi in range(ostarts.size - 1):
        o_idx = oorder[ostarts[bi]:ostarts[bi + 1]]
        l, h = int(lo[bi]), int(hi[bi])
        if l == h:
            unmatched.extend((int(i), int(of.uids[i])) for i in o_idx)
            continue
        # (o, b) distance matrix for the whole bucket, one vectorized op
        d = (np.abs(spos[l:h][None, :] - of.pos[o_idx][:, None])
             + (slayer[l:h][None, :] != of.layer[o_idx][:, None]))
        for r, i in enumerate(o_idx):
            j = int(np.argmin(d[r]))
            dj = int(d[r, j])
            if dj > pos_tolerance:
                unmatched.append((int(i), int(of.uids[i])))
                continue
            d[:, j] = _NO_MATCH                 # column consumed
            mapping[int(of.uids[i])] = int(suid[l + j])
            if dj:
                moved += 1
    unmatched.sort()                            # reference order: old order
    return MatchResult(mapping, [u for _, u in unmatched], moved)


def match_instances_reference(old: ProfileData, new: ProfileData,
                              pos_tolerance: int = 16) -> MatchResult:
    """Original per-instance Python implementation, kept as the parity
    oracle for the vectorized :func:`match_instances`."""
    new_feats: Dict[int, List[TensorInstance]] = {}
    for t in new.candidates:
        key = pack_features(t, new.n_ops) & _EXACT_MASK
        new_feats.setdefault(key, []).append(t)
    for lst in new_feats.values():
        lst.sort(key=lambda t: (t.layer, t.birth))

    mapping: Dict[int, int] = {}
    unmatched: List[int] = []
    moved = 0
    used: set = set()
    for t in old.candidates:
        f = pack_features(t, old.n_ops)
        key = f & _EXACT_MASK
        pos = f >> _POS_SHIFT
        best = None
        best_d = None
        for c in new_feats.get(key, ()):  # integer comparisons only
            if c.uid in used:
                continue
            cpos = pack_features(c, new.n_ops) >> _POS_SHIFT
            d = abs(int(cpos) - int(pos)) + (0 if c.layer == t.layer else 1)
            if d <= pos_tolerance and (best_d is None or d < best_d):
                best, best_d = c, d
        if best is None:
            unmatched.append(t.uid)
        else:
            used.add(best.uid)
            mapping[t.uid] = best.uid
            if best_d:
                moved += 1
    return MatchResult(mapping, unmatched, moved)


def remap_policy(policy, old: ProfileData, new: ProfileData,
                 pos_tolerance: int = 16):
    """Carry a SwapPolicy across a *minor* sequence change by re-pointing
    its entries at the matched new instances.  Returns (entries, hit_rate);
    the caller regenerates the policy when hit_rate is low (the stage
    machine will already be back in WarmUp for major changes)."""
    res = match_instances(old, new, pos_tolerance)
    by_uid = {t.uid: t for t in new.candidates}
    remapped = []
    for e in policy.entries:
        nid = res.mapping.get(e.uid)
        if nid is None:
            continue
        t = by_uid[nid]
        ne = type(e)(t.uid, t.site, t.layer, t.nbytes, t.birth, t.death,
                     e.swap_in_op, e.swap_out_done_op, e.stalled, e.score)
        remapped.append(ne)
    hit = len(remapped) / max(len(policy.entries), 1)
    return remapped, hit
