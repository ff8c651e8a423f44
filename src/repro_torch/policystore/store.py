"""Persistent fingerprint-keyed policy store (repro_torch.policystore).

A numpy copy of ``repro/policystore/store.py`` (no JAX in it):
fingerprints, records and decisions equal the reference's for the same
inputs.

One :class:`PolicyRecord` is everything a later adaptation needs to avoid
a cold GenPolicy cycle for a recurring op sequence:

  * the two fingerprints it is reachable by — the **prepare** fingerprint
    (the profiled train-step stream, exact-hit on process cold start) and
    the **iteration** fingerprint (the full dispatch-sequence signature,
    matched by similarity on mid-run drift);
  * the serialized :class:`~repro_torch.core.policy.SwapPolicy` entries plus
    the candidate instances of the profile it was generated from (what
    ``core/matching.py`` needs to re-associate entries with a retraced
    program);
  * the winning grouping knob and its measured ``T_iter`` (what seeds a
    warm-started variant search);
  * a snapshot of the bandwidth-model curve it was priced under (what
    the drift guards compare against the live link before trusting the
    cached schedule).

The :class:`PolicyStore` keeps records in an in-memory LRU and, when a
directory is configured, mirrors each record to one JSON file
(``<key>.json``, atomic tmp+rename writes).  Loads are corruption-safe —
an unreadable or schema-incompatible file is skipped and counted, never
fatal — and eviction removes the disk file with the memory entry.

``nearest`` is sublinear: an LSH band-bucket index over the MinHash
signatures (``lshindex.py``, persisted as ``lsh.index`` next to the
records and rebuilt when missing, corrupt, or out of sync) shortlists
probable matches; only when the probe finds nothing reuse-grade does a
vectorized fallback run — one numpy pass computes a per-record *upper
bound* on the calibrated similarity, and exact scoring proceeds in
decreasing-bound order, stopping as soon as the bound cannot beat the
best hit.  The bound is tight: the operator-histogram and site-byte
cosines are evaluated exactly as dense matrix products over the bounded
token/site vocabularies (rows normalized once, rebuilt lazily after
mutations), so the per-row bound *equals* the blended score up to
rounding — a true miss scores O(1) records after the vectorized pass
instead of falling back to O(records) scalar evaluations.  Rows whose
histogram overflows the vocab cap keep the old optimistic constant (the
bound must stay an upper bound).  The result is identical to the
exhaustive scan whenever the exhaustive best is below the reuse
threshold, and reuse-grade otherwise; ``n_sim_evals`` counts full
similarity evaluations so tests can assert probe work ≪ records —
``nearest_exhaustive`` stays as the parity oracle.

The store is thread-safe (one re-entrant lock around record/index/row
state), as the reference's: the background adaptation worker
(``repro_torch.adapt.service``) shares it with the training thread, and a
server's refresher re-scans it from a thread of its own.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import faults, obs
from repro_torch.policystore.fingerprint import Fingerprint, similarity
from repro_torch.policystore.lshindex import LSHIndex

SCHEMA_VERSION = 1

_ENTRY_FIELDS = ("uid", "site", "layer", "nbytes", "birth", "death",
                 "swap_in_op", "swap_out_done_op", "stalled", "score")
_CAND_FIELDS = ("uid", "nbytes", "birth", "death", "site", "layer",
                "dtype_code", "shape", "producer_token")


class _ProfileStub:
    """The slice of ProfileData that ``core.matching`` reads: candidate
    instances plus the op count (for position bucketing)."""

    def __init__(self, candidates, n_ops: int):
        self.candidates = candidates
        self.n_ops = n_ops


@dataclass
class PolicyRecord:
    key: str                               # prepare-fingerprint exact hash
    fingerprint: Fingerprint               # iteration-sequence signature
    prepare_fingerprint: Fingerprint       # profiled train-step stream
    entries: List[dict] = field(default_factory=list)
    # what the adaptation winner was: "swap" (entries carry the schedule),
    # "baseline" (fit without swapping — re-verified against the observed
    # timeline before reuse), or "conservative" (offload-all fallback —
    # always safe to reapply)
    policy_kind: str = "swap"
    policy_meta: dict = field(default_factory=dict)
    candidates: List[dict] = field(default_factory=list)
    n_ops: int = 0
    knob: float = 1.0
    measured_t: float = 0.0
    budget: int = 0
    bw_constant_gbps: float = 0.0
    bw_curve: List[Tuple[int, float]] = field(default_factory=list)
    created: float = 0.0
    uses: int = 0

    # ------------------------------------------------------ construction
    @classmethod
    def from_policy(cls, *, fingerprint: Fingerprint,
                    prepare_fingerprint: Fingerprint, swap, candidates,
                    n_ops: int, knob: float, measured_t: float, budget: int,
                    bwmodel=None, policy_kind: str = "swap") -> "PolicyRecord":
        import numbers

        def _plain(v):
            if isinstance(v, bool) or v is None or isinstance(v, str):
                return v
            if isinstance(v, numbers.Integral):
                return int(v)           # numpy ints -> JSON-safe
            return float(v)

        entries = []
        meta: dict = {}
        if swap is not None:
            entries = [{f: _plain(getattr(e, f)) for f in _ENTRY_FIELDS}
                       for e in swap.entries]
            meta = {"projected_peak": int(swap.projected_peak),
                    "baseline_peak": int(swap.baseline_peak),
                    "budget": int(swap.budget),
                    "stall_time": float(swap.stall_time),
                    "t_iter": float(swap.t_iter), "n_ops": int(swap.n_ops),
                    "contention_s": float(swap.contention_s),
                    "occupancy": float(getattr(swap, "occupancy", 0.0))}
        cands = [{f: ([int(d) for d in getattr(t, f)] if f == "shape"
                      else _plain(getattr(t, f))) for f in _CAND_FIELDS}
                 for t in candidates]
        curve: List[Tuple[int, float]] = []
        gbps = 0.0
        if bwmodel is not None:
            curve = [(int(s), float(t)) for s, t, _gbps in bwmodel.curve()]
            gbps = float(bwmodel.constant_gbps)
        return cls(key=prepare_fingerprint.exact, fingerprint=fingerprint,
                   prepare_fingerprint=prepare_fingerprint, entries=entries,
                   policy_kind=("swap" if entries else policy_kind),
                   policy_meta=meta, candidates=cands, n_ops=int(n_ops),
                   knob=float(knob), measured_t=float(measured_t),
                   budget=int(budget), bw_constant_gbps=gbps,
                   bw_curve=curve, created=time.time())

    # -------------------------------------------------------- reanimation
    def swap_policy(self):
        """Rebuild the stored SwapPolicy (None when the cached adaptation
        concluded the baseline fits without swapping)."""
        if not self.entries:
            return None
        from repro_torch.core.policy import SwapPolicy
        from repro_torch.core.simulator import PolicyEntry
        entries = [PolicyEntry(**{f: e[f] for f in _ENTRY_FIELDS})
                   for e in self.entries]
        m = self.policy_meta
        return SwapPolicy(entries, m.get("projected_peak", 0),
                          m.get("baseline_peak", 0),
                          m.get("budget", self.budget),
                          m.get("stall_time", 0.0), m.get("t_iter", 0.0),
                          m.get("n_ops", self.n_ops),
                          contention_s=m.get("contention_s", 0.0),
                          occupancy=m.get("occupancy", 0.0))

    def profile_stub(self) -> _ProfileStub:
        from repro_torch.core.profiler import TensorInstance
        cands = [TensorInstance(
            uid=c["uid"], nbytes=c["nbytes"], birth=c["birth"],
            death=c["death"], site=c["site"], layer=c["layer"],
            dtype_code=c["dtype_code"], shape=tuple(c["shape"]),
            producer_token=c.get("producer_token", 0))
            for c in self.candidates]
        return _ProfileStub(cands, self.n_ops)

    # ------------------------------------------------------ serialization
    def to_json(self) -> dict:
        return {
            "schema": SCHEMA_VERSION,
            "key": self.key,
            "fingerprint": self.fingerprint.to_dict(),
            "prepare_fingerprint": self.prepare_fingerprint.to_dict(),
            "entries": self.entries,
            "policy_kind": self.policy_kind,
            "policy_meta": self.policy_meta,
            "candidates": self.candidates,
            "n_ops": self.n_ops,
            "knob": self.knob,
            "measured_t": self.measured_t,
            "budget": self.budget,
            "bw_constant_gbps": self.bw_constant_gbps,
            "bw_curve": [[s, t] for s, t in self.bw_curve],
            "created": self.created,
            "uses": self.uses,
        }

    @classmethod
    def from_json(cls, d: dict) -> "PolicyRecord":
        if d.get("schema") != SCHEMA_VERSION:
            raise ValueError(f"schema {d.get('schema')!r} != {SCHEMA_VERSION}")
        return cls(key=d["key"],
                   fingerprint=Fingerprint.from_dict(d["fingerprint"]),
                   prepare_fingerprint=Fingerprint.from_dict(
                       d["prepare_fingerprint"]),
                   entries=list(d.get("entries", [])),
                   policy_kind=str(d.get("policy_kind", "swap")),
                   policy_meta=dict(d.get("policy_meta", {})),
                   candidates=list(d.get("candidates", [])),
                   n_ops=int(d.get("n_ops", 0)),
                   knob=float(d.get("knob", 1.0)),
                   measured_t=float(d.get("measured_t", 0.0)),
                   budget=int(d.get("budget", 0)),
                   bw_constant_gbps=float(d.get("bw_constant_gbps", 0.0)),
                   bw_curve=[(int(s), float(t))
                             for s, t in d.get("bw_curve", [])],
                   created=float(d.get("created", 0.0)),
                   uses=int(d.get("uses", 0)))


class PolicyStore:
    """In-memory LRU over :class:`PolicyRecord`, optionally mirrored to a
    directory of JSON files (one per record, named by key)."""

    def __init__(self, cfg, readonly: bool = False):
        self.cfg = cfg
        self.dir: Optional[str] = cfg.dir or None
        # read-only attach (e.g. a serving process inspecting a trainer's
        # store): never writes, never deletes — in particular a shared dir
        # holding more than max_records must not lose records to this
        # reader's load-time eviction
        self.readonly = readonly
        self.max_records = max(int(cfg.max_records), 1)
        self._records: "collections.OrderedDict[str, PolicyRecord]" = \
            collections.OrderedDict()
        self.n_lookups = self.n_exact_hits = self.n_sim_hits = 0
        self.n_misses = self.n_evictions = 0
        self.n_loaded = self.n_corrupt = 0
        self.n_sim_evals = self.n_index_rebuilds = 0
        self.n_io_errors = 0
        self.index = LSHIndex(int(getattr(cfg, "minhash_perms", 64)),
                              int(getattr(cfg, "lsh_bands", 16)))
        self._rows_dirty = True
        self._index_dirty_puts = 0
        # training thread + adaptation worker (repro_torch.adapt) share the
        # store; re-entrant because classify->nearest and the runtime's
        # touch can nest through the same thread's call chain
        self._lock = threading.RLock()
        if self.dir:
            self._load_dir()
            self._attach_index()

    # ----------------------------------------------------------- loading
    def _load_dir(self) -> None:
        try:
            os.makedirs(self.dir, exist_ok=True)
            names = [n for n in os.listdir(self.dir) if n.endswith(".json")]
        except OSError:
            self.n_corrupt += 1
            return
        paths = [os.path.join(self.dir, n) for n in names]
        # oldest-modified first, so insertion order doubles as LRU order
        paths.sort(key=lambda p: (os.path.getmtime(p)
                                  if os.path.exists(p) else 0.0))
        for path in paths:
            try:
                if faults.inject("store.load",
                                 key=os.path.basename(path)) is not None:
                    raise ValueError("injected corrupt record at load")
                with open(path) as f:
                    rec = PolicyRecord.from_json(json.load(f))
            except (OSError, ValueError, KeyError, TypeError,
                    json.JSONDecodeError):
                self.n_corrupt += 1
                continue
            self._records[rec.key] = rec
            self.n_loaded += 1
        self._evict_over_capacity()

    # ----------------------------------------------------------- lsh index
    def _index_path(self) -> str:
        # not *.json: record loading globs that suffix
        return os.path.join(self.dir, "lsh.index")

    def _attach_index(self) -> None:
        """Load the persisted band index; rebuild from the records when it
        is missing, corrupt, parameter-mismatched, or out of sync with the
        loaded record set (e.g. another writer evicted since)."""
        try:
            with open(self._index_path()) as f:
                idx = LSHIndex.from_json(json.load(f))
            if (idx.n_perms == self.index.n_perms
                    and idx.n_bands == self.index.n_bands
                    and idx.keys() == set(self._records)):
                self.index = idx
                return
        except (OSError, ValueError, KeyError, TypeError,
                json.JSONDecodeError):
            pass
        self._rebuild_index()

    def _rebuild_index(self) -> None:
        self.index.clear()
        for key, rec in self._records.items():
            self.index.add(key, (rec.prepare_fingerprint.minhash,
                                 rec.fingerprint.minhash))
        self.n_index_rebuilds += 1
        self._persist_index()

    def _persist_index(self) -> None:
        if not self.dir or self.readonly:
            return
        try:
            os.makedirs(self.dir, exist_ok=True)
            tmp = self._index_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.index.to_json(), f)
            os.replace(tmp, self._index_path())
            self._index_dirty_puts = 0
        except OSError as e:
            # a lost index write is self-healing (rebuilt at next attach
            # by the key-set check) — never worth failing a put over
            self.n_io_errors += 1
            obs.audit().event("store.io_error", op="persist_index",
                              error=str(e))
            obs.metrics().counter("store_io_errors")

    # the index file serializes every record's band digests, so writing it
    # per put would make N inserts O(N^2) disk work at the ~1k-record scale
    # the index exists for.  Small stores flush every put (restart never
    # rebuilds); large ones amortize — a stale on-disk index is detected at
    # load by the key-set check in _attach_index and rebuilt, so deferral
    # trades a cheap rebuild-on-restart for O(1) amortized writes.
    _INDEX_FLUSH_SMALL = 128
    _INDEX_FLUSH_EVERY = 16

    def _persist_index_amortized(self) -> None:
        self._index_dirty_puts += 1
        if (len(self._records) <= self._INDEX_FLUSH_SMALL
                or self._index_dirty_puts >= self._INDEX_FLUSH_EVERY):
            self._persist_index()

    # ------------------------------------------------------------ writes
    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.json")

    def _persist(self, rec: PolicyRecord) -> None:
        if not self.dir or self.readonly:
            return
        os.makedirs(self.dir, exist_ok=True)
        tmp = self._path(rec.key) + ".tmp"
        payload = json.dumps(rec.to_json())
        with open(tmp, "w") as f:
            if faults.inject("store.put", key=rec.key) is not None:
                # model a mid-write crash: half the payload lands, then
                # the writer dies — the *.tmp file is left behind and the
                # record file is never replaced (atomicity under test)
                f.write(payload[: len(payload) // 2])
                raise OSError("injected mid-write failure persisting record")
            f.write(payload)
        os.replace(tmp, self._path(rec.key))

    def _persist_safe(self, rec: PolicyRecord) -> bool:
        """Mirror a record to disk without ever raising into the caller:
        a full disk or injected write fault costs durability of this one
        record (the in-memory copy keeps serving), never the train loop."""
        try:
            self._persist(rec)
            return True
        except OSError as e:
            self.n_io_errors += 1
            obs.audit().event("store.io_error", op="persist",
                              key=rec.key, error=str(e))
            obs.metrics().counter("store_io_errors")
            return False

    def _evict_over_capacity(self) -> None:
        while len(self._records) > self.max_records:
            key, _ = self._records.popitem(last=False)
            self.index.remove(key)
            self._rows_dirty = True
            self.n_evictions += 1
            if self.dir and not self.readonly:
                try:
                    os.remove(self._path(key))
                except OSError:
                    pass

    def put(self, rec: PolicyRecord) -> None:
        with self._lock:
            self._records[rec.key] = rec
            self._records.move_to_end(rec.key)
            self.index.add(rec.key, (rec.prepare_fingerprint.minhash,
                                     rec.fingerprint.minhash))
            self._rows_dirty = True
            self._evict_over_capacity()
            self._persist_safe(rec)
            self._persist_index_amortized()

    def touch(self, rec: PolicyRecord) -> None:
        """Record a use: bumps LRU recency and the use counter.  The disk
        side only needs its mtime refreshed (restart LRU order follows
        mtime) — rewriting the whole record per hit would serialize every
        candidate on every reuse; the ``uses`` counter is informational
        and flushed whenever the record is next ``put``."""
        with self._lock:
            rec.uses += 1
            if rec.key in self._records:
                self._records.move_to_end(rec.key)
            if self.dir and not self.readonly:
                try:
                    os.utime(self._path(rec.key), None)
                except OSError:
                    self._persist_safe(rec)  # file vanished: restore it

    def refresh(self) -> int:
        """Pick up records another writer added to the directory since
        load — a readonly attach in a serving process keeps seeing the
        trainer's newly cached policies without a restart.  Returns the
        number of newly loaded records."""
        if not self.dir:
            return 0
        with self._lock:
            try:
                names = [n for n in os.listdir(self.dir)
                         if n.endswith(".json")]
            except OSError:
                return 0
            new = 0
            for name in names:
                if name[:-5] in self._records:
                    continue
                try:
                    with open(os.path.join(self.dir, name)) as f:
                        rec = PolicyRecord.from_json(json.load(f))
                except (OSError, ValueError, KeyError, TypeError,
                        json.JSONDecodeError):
                    self.n_corrupt += 1
                    continue
                self._records[rec.key] = rec
                self.index.add(rec.key, (rec.prepare_fingerprint.minhash,
                                         rec.fingerprint.minhash))
                self._rows_dirty = True
                self.n_loaded += 1
                new += 1
            if new and not self.readonly:
                self._evict_over_capacity()
            return new

    # ------------------------------------------------------------ lookup
    def get_exact(self, key: str) -> Optional[PolicyRecord]:
        with self._lock:
            return self._records.get(key)

    # the token-histogram vocabulary across all rows is bounded (interned
    # op tokens), but a pathological store could still blow the dense
    # matrix up — rows beyond the cap keep the optimistic constant bound
    _HIST_VOCAB_CAP = 8192

    # ---- flat row views for the vectorized fallback (2 rows per record:
    # prepare + iteration fingerprint), rebuilt lazily after mutations
    def _ensure_rows(self) -> None:
        if not self._rows_dirty:
            return
        w = self.index.n_perms
        keys: List[str] = []
        sigs: List[np.ndarray] = []
        lens: List[int] = []
        has_site: List[bool] = []
        sig_ok: List[bool] = []
        fps: List[Fingerprint] = []
        for key, rec in self._records.items():
            for f in (rec.prepare_fingerprint, rec.fingerprint):
                keys.append(key)
                fps.append(f)
                lens.append(int(f.length))
                has_site.append(bool(f.site_bytes))
                if f.minhash.size == w:
                    sigs.append(f.minhash)
                    sig_ok.append(True)
                else:                       # foreign perm count: never prune
                    sigs.append(np.zeros(w, np.int64))
                    sig_ok.append(False)
        self._row_keys = keys
        self._row_sigs = (np.stack(sigs) if sigs
                          else np.zeros((0, w), np.int64))
        self._row_lens = np.asarray(lens, np.float64)
        self._row_site = np.asarray(has_site, bool)
        self._row_ok = np.asarray(sig_ok, bool)
        self._build_cosine_rows(fps)
        self._rows_dirty = False

    def _build_cosine_rows(self, fps: List[Fingerprint]) -> None:
        """Dense unit-normalized histogram/site matrices over the bounded
        vocabularies, so ``_upper_bounds`` evaluates the cosine terms of
        the calibrated similarity *exactly* (a row's support is always a
        subset of the vocab, so the dot over mapped query entries is the
        true dot).  Rows whose histogram would overflow the vocab cap are
        flagged; their bound falls back to the optimistic constant."""
        n = len(fps)
        hist_vocab: Dict[int, int] = {}
        site_vocab: Dict[str, int] = {}
        hist_full = np.ones(n, bool)        # row fully inside the vocab?
        for i, f in enumerate(fps):
            if len(hist_vocab) + len(f.histogram) <= self._HIST_VOCAB_CAP:
                for t in f.histogram:
                    if t not in hist_vocab:
                        hist_vocab[t] = len(hist_vocab)
            if not all(t in hist_vocab for t in f.histogram):
                hist_full[i] = False
            for s in f.site_bytes:
                if s not in site_vocab:
                    site_vocab[s] = len(site_vocab)
        hmat = np.zeros((n, max(len(hist_vocab), 1)), np.float64)
        smat = np.zeros((n, max(len(site_vocab), 1)), np.float64)
        hist_empty = np.zeros(n, bool)
        cand = np.zeros(n, np.float64)
        for i, f in enumerate(fps):
            hist_empty[i] = not f.histogram
            cand[i] = float(f.cand_bytes)
            if hist_full[i]:
                for t, c in f.histogram.items():
                    hmat[i, hist_vocab[t]] = c
            for s, b in f.site_bytes.items():
                smat[i, site_vocab[s]] = b
        for mat in (hmat, smat):
            norms = np.linalg.norm(mat, axis=1)
            nz = norms > 0
            mat[nz] /= norms[nz, None]
        self._hist_vocab, self._site_vocab = hist_vocab, site_vocab
        self._row_hist, self._row_svec = hmat, smat
        self._row_hist_full, self._row_hist_empty = hist_full, hist_empty
        self._row_cand = cand

    def _query_cos(self, q: Dict, vocab: Dict, mat: np.ndarray,
                   row_empty: np.ndarray) -> np.ndarray:
        """Exact cosine of ``q`` against every (unit-normalized) row.
        Out-of-vocab query entries contribute to the query norm only —
        rows carry no mass there, so the dot is still exact."""
        if not q:
            return np.where(row_empty, 1.0, 0.0)
        qv = np.zeros(mat.shape[1], np.float64)
        qn2 = 0.0
        for k, v in q.items():
            qn2 += float(v) * float(v)
            j = vocab.get(k)
            if j is not None:
                qv[j] = v
        dots = mat @ qv
        cos = dots / max(np.sqrt(qn2), 1e-300)
        return np.where(row_empty, 0.0, cos)

    def _upper_bounds(self, fp: Fingerprint) -> np.ndarray:
        """Per-row upper bound on the calibrated similarity.  With the
        dense cosine rows the bound equals the blended score (every term
        exact) for vocab-covered rows, so a true miss prunes after O(1)
        exact evaluations; overflow rows keep the optimistic constant and
        width-mismatched rows get 1.0 (never prune what we cannot score)."""
        n = len(self._row_keys)
        if fp.minhash.size == self.index.n_perms and n:
            jac = (self._row_sigs == fp.minhash[None, :]).mean(axis=1)
        else:
            jac = np.ones(n)
        fl = float(fp.length)
        lens = self._row_lens
        with np.errstate(divide="ignore", invalid="ignore"):
            lr = np.where((lens <= 0) & (fl <= 0), 1.0,
                          np.where((lens <= 0) | (fl <= 0), 0.0,
                                   np.minimum(lens, fl)
                                   / np.maximum(np.maximum(lens, fl), 1e-12)))
        cos = self._query_cos(fp.histogram, self._hist_vocab,
                              self._row_hist, self._row_hist_empty)
        use_prof = self._row_site & bool(fp.site_bytes)
        sc_token = 0.45 * jac + 0.30 * cos + 0.25 * lr
        sc = sc_token
        if use_prof.any():
            site_cos = self._query_cos(
                fp.site_bytes, self._site_vocab, self._row_svec,
                ~self._row_site)
            qc = float(fp.cand_bytes)
            rc = self._row_cand
            with np.errstate(divide="ignore", invalid="ignore"):
                bytes_r = np.where((rc <= 0) & (qc <= 0), 1.0,
                                   np.where((rc <= 0) | (qc <= 0), 0.0,
                                            np.minimum(rc, qc)
                                            / np.maximum(np.maximum(rc, qc),
                                                         1e-12)))
            sc_prof = (0.40 * jac + 0.20 * cos + 0.20 * lr
                       + 0.10 * site_cos + 0.10 * bytes_r)
            sc = np.where(use_prof, sc_prof, sc_token)
        # overflow rows: histogram cosine unknown -> optimistic constant
        ub_token = 0.45 * jac + 0.25 * lr + 0.30
        ub_prof = 0.40 * jac + 0.20 * lr + 0.40
        ub_loose = np.where(use_prof, ub_prof, ub_token)
        ub = np.where(self._row_hist_full, sc, ub_loose)
        ub = np.where(self._row_ok, ub, 1.0)
        return ub + 1e-9                    # absorb float rounding slack

    def nearest(self, fp: Fingerprint) -> Tuple[Optional[PolicyRecord], float]:
        """Best-matching record and its calibrated similarity: each record
        is reachable through either of its two fingerprints (max taken).
        A best match below the warm-start floor is counted as a miss —
        it cannot influence adaptation, so reporting it as a hit would
        make a never-matching cache look warm.

        Lookup is LSH-first: band-bucket collisions are scored exactly,
        and if a reuse-grade match surfaces the scan stops there (probe
        work ≪ records).  Otherwise the vectorized bounded fallback
        recovers the exact exhaustive-scan result."""
        with self._lock:
            return self._nearest_locked(fp)

    def _nearest_locked(
            self, fp: Fingerprint) -> Tuple[Optional[PolicyRecord], float]:
        self.n_lookups += 1
        hit = self._records.get(fp.exact)   # O(1) fast path (keys are
        if hit is not None:                 # prepare-fingerprint hashes)
            self.n_exact_hits += 1
            return hit, 1.0
        floor = getattr(self.cfg, "warm_threshold", 0.0)
        if not self._records:
            self.n_misses += 1
            return None, 0.0
        reuse_floor = getattr(self.cfg, "reuse_threshold", 1.0)
        scored: Dict[str, float] = {}

        def _score(key: str) -> float:
            rec = self._records[key]
            s = max(similarity(fp, rec.prepare_fingerprint),
                    similarity(fp, rec.fingerprint))
            self.n_sim_evals += 1
            scored[key] = s
            return s

        best: Optional[PolicyRecord] = None
        best_sim = 0.0
        for key in self.index.query(fp.minhash):
            if key not in self._records:
                continue
            s = _score(key)
            if s > best_sim or best is None:
                best, best_sim = self._records[key], s
        if best is None or best_sim < reuse_floor:
            self._ensure_rows()
            ub = self._upper_bounds(fp)
            for ri in np.argsort(-ub):
                if best is not None and ub[ri] <= best_sim:
                    break                   # bounds sorted: nothing beats it
                key = self._row_keys[ri]
                if key in scored:
                    continue
                s = _score(key)
                if s > best_sim or best is None:
                    best, best_sim = self._records[key], s
        if best is None or best_sim < floor:
            self.n_misses += 1
        elif best_sim >= 1.0:
            self.n_exact_hits += 1
        else:
            self.n_sim_hits += 1
        return best, best_sim

    def nearest_exhaustive(
            self, fp: Fingerprint) -> Tuple[Optional[PolicyRecord], float]:
        """Reference O(records) scan — the parity oracle for the LSH path
        (tests/benchmarks).  Does not touch hit counters."""
        best: Optional[PolicyRecord] = None
        best_sim = 0.0
        with self._lock:
            recs = list(self._records.values())
        for rec in recs:
            sim = max(similarity(fp, rec.prepare_fingerprint),
                      similarity(fp, rec.fingerprint))
            if sim > best_sim or best is None:
                best, best_sim = rec, sim
        return best, best_sim

    # ------------------------------------------------------------- misc
    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def records(self) -> List[PolicyRecord]:
        with self._lock:
            return list(self._records.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "records": len(self._records),
                "dir": self.dir or "",
                "lookups": self.n_lookups,
                "exact_hits": self.n_exact_hits,
                "sim_hits": self.n_sim_hits,
                "misses": self.n_misses,
                "evictions": self.n_evictions,
                "loaded": self.n_loaded,
                "corrupt_skipped": self.n_corrupt,
                "io_errors": self.n_io_errors,
                "sim_evals": self.n_sim_evals,
                "index_rebuilds": self.n_index_rebuilds,
                "index": self.index.stats(),
            }
