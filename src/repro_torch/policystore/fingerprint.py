"""Drift-tolerant op-sequence fingerprints (repro_torch.policystore).

A numpy copy of ``repro/policystore/fingerprint.py`` (no JAX in it):
fingerprints, records and decisions equal the reference's for the same
inputs.

A fingerprint is a fixed-size sketch of one tokenized operator stream
(``repro_torch.core.tokenizer``), built from three layers of evidence:

  * an **exact hash** of the token bytes plus the aggregate features —
    identical programs collide deliberately, different-shape variants of
    the same op stream (e.g. seq-len buckets, which tokenize identically
    but carry different per-site byte totals) do not;
  * a **shingled MinHash signature**: the stream's ``shingle``-gram set
    is sketched with ``n_perms`` universal-hash permutations, so the
    Jaccard similarity of two streams' n-gram sets is estimated from the
    fraction of matching signature slots — robust to reordering and to
    local insertions (an interleaved eval block changes a bounded number
    of shingles);
  * **aggregate features**: op count, operator-histogram, and (when a
    profile is available) the per-site candidate-byte histogram plus the
    total candidate bytes — these catch what MinHash deliberately
    ignores, a uniform rescale of the whole program.

``similarity`` combines the layers into one calibrated score in [0, 1];
the tier *gates* (length ratio floors) live in ``drift.py`` where the
reuse/warm-start/regen decision is made.
"""
from __future__ import annotations

import collections
import hashlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

# universal-hash modulus (Mersenne prime 2^31 - 1): with a, b, h < p the
# product a*h + b fits in uint64, so the whole permutation bank runs as one
# vectorized numpy expression.  Fixed seeds make signatures stable across
# processes — a store written by one run must be readable by the next.
_MERSENNE = (1 << 31) - 1
_PERM_SEED = 0x5EED_CAFE
_SHINGLE_BASE = np.uint64(1_000_003)
_CHUNK = 1 << 16                      # windows hashed per vectorized block


_PERM_CACHE: Dict[int, np.ndarray] = {}


def _permutations(n_perms: int) -> np.ndarray:
    """(2, n_perms, 1) uint64 [a; b] for h -> (a*h + b) mod p (memoized —
    the bank is fixed-seed, so one materialization per perm count)."""
    bank = _PERM_CACHE.get(n_perms)
    if bank is None:
        rng = np.random.RandomState(_PERM_SEED)
        a = rng.randint(1, _MERSENNE, size=n_perms).astype(np.uint64)
        b = rng.randint(0, _MERSENNE, size=n_perms).astype(np.uint64)
        bank = np.stack([a, b])[:, :, None]
        _PERM_CACHE[n_perms] = bank
    return bank


def _shingle_hashes(tokens: np.ndarray, shingle: int) -> np.ndarray:
    """Polynomial hash of every length-``shingle`` window (uint64)."""
    t = tokens.astype(np.uint64)
    if t.size == 0:
        return t
    k = min(shingle, t.size)
    w = t.size - k + 1
    h = np.zeros(w, np.uint64)
    for j in range(k):
        h = h * _SHINGLE_BASE + t[j:j + w]
    return h


def minhash_signature(tokens: np.ndarray, n_perms: int = 64,
                      shingle: int = 4) -> np.ndarray:
    """MinHash sketch of the stream's shingle set (int64, ``n_perms``)."""
    hashes = np.unique(_shingle_hashes(np.asarray(tokens), shingle))
    if hashes.size == 0:
        return np.full(n_perms, -1, np.int64)
    a, b = _permutations(n_perms)
    p = np.uint64(_MERSENNE)
    sig = np.full(n_perms, _MERSENNE, np.uint64)
    h = hashes % p
    for lo in range(0, h.size, _CHUNK):
        blk = h[None, lo:lo + _CHUNK]               # (1, chunk)
        vals = ((a * blk + b) % p).min(axis=1)      # (n_perms,)
        sig = np.minimum(sig, vals)
    return sig.astype(np.int64)


@dataclass
class Fingerprint:
    """Sketch of one tokenized op stream (JSON-serializable)."""
    exact: str                         # sha1 over tokens + aggregates
    length: int                        # op count
    minhash: np.ndarray                # (n_perms,) int64
    histogram: Dict[int, int]          # token -> count
    site_bytes: Dict[str, int] = field(default_factory=dict)
    cand_bytes: int = 0                # total candidate bytes (0 = unknown)

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {
            "exact": self.exact,
            "length": int(self.length),
            "minhash": [int(v) for v in self.minhash],
            "histogram": {str(k): int(v) for k, v in self.histogram.items()},
            "site_bytes": {k: int(v) for k, v in self.site_bytes.items()},
            "cand_bytes": int(self.cand_bytes),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Fingerprint":
        return cls(exact=d["exact"], length=int(d["length"]),
                   minhash=np.asarray(d["minhash"], np.int64),
                   histogram={int(k): int(v)
                              for k, v in d["histogram"].items()},
                   site_bytes=dict(d.get("site_bytes", {})),
                   cand_bytes=int(d.get("cand_bytes", 0)))


def _exact_hash(tokens: np.ndarray, site_bytes: Dict[str, int],
                cand_bytes: int, extra: bytes = b"") -> str:
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    for k in sorted(site_bytes):
        h.update(f"{k}={site_bytes[k]};".encode())
    h.update(str(cand_bytes).encode())
    h.update(extra)
    return h.hexdigest()


# sketch memo: the monitoring loop re-fingerprints *recurring* streams
# (train/eval interleaves, seq-len bucket cycling) — the exact hash is
# cheap (one sha1 over the token bytes) and fully determines the sketch,
# so the shingling/MinHash/unique work runs once per distinct stream.
_FP_CACHE: "collections.OrderedDict[tuple, Fingerprint]" = \
    collections.OrderedDict()
_FP_CACHE_MAX = 256


def clear_fingerprint_cache() -> None:
    _FP_CACHE.clear()


def fingerprint_tokens(tokens: np.ndarray,
                       site_bytes: Optional[Dict[str, int]] = None,
                       n_perms: int = 64, shingle: int = 4,
                       cache: bool = True,
                       virtual_len: Optional[int] = None,
                       histogram: Optional[Dict[int, int]] = None
                       ) -> Fingerprint:
    """Sketch one token stream.

    ``virtual_len``/``histogram`` carry the *true* run-length-aware
    accounting when ``tokens`` is a REPEAT_CAP-capped materialization
    (``tokenizer.Signature``): the exact hash, length, and histogram then
    reflect the virtual stream — two deep-scan variants whose capped
    materializations collide (80 vs 96 layers) must not fingerprint
    identically.  When the virtual accounting matches the materialized
    stream the fingerprint is bit-identical to the plain form, so
    iteration fingerprints still exact-hit prepare fingerprints of the
    same program.  MinHash stays on the materialized stream — shingle
    *sets* saturate after one scan repeat, so the cap cannot change them.
    """
    tokens = np.asarray(tokens, np.int32)
    site_bytes = dict(site_bytes or {})
    cand_bytes = sum(site_bytes.values())
    length = int(tokens.size) if virtual_len is None else int(virtual_len)
    extra = b""
    if length != tokens.size:
        # capped materialization: hash the virtual accounting too (the
        # true histogram can only diverge from the stream when it did)
        hist_ser = ",".join(f"{k}:{v}"
                            for k, v in sorted((histogram or {}).items()))
        extra = f"vlen={length};hist={hist_ser}".encode()
    exact = _exact_hash(tokens, site_bytes, cand_bytes, extra)
    key = (exact, n_perms, shingle)
    if cache:
        hit = _FP_CACHE.get(key)
        if hit is not None:
            _FP_CACHE.move_to_end(key)
            return hit
    hist: Dict[int, int] = dict(histogram or {})
    if not hist and tokens.size:
        vals, counts = np.unique(tokens, return_counts=True)
        hist = {int(v): int(c) for v, c in zip(vals, counts)}
    fp = Fingerprint(
        exact=exact,
        length=length,
        minhash=minhash_signature(tokens, n_perms=n_perms, shingle=shingle),
        histogram=hist, site_bytes=site_bytes, cand_bytes=cand_bytes)
    if cache:
        _FP_CACHE[key] = fp
        while len(_FP_CACHE) > _FP_CACHE_MAX:
            _FP_CACHE.popitem(last=False)
    return fp


def fingerprint_signature(sig, n_perms: int = 64, shingle: int = 4,
                          cache: bool = True) -> Fingerprint:
    """Fingerprint an iteration :class:`~repro_torch.core.tokenizer.Signature`:
    the materialized (capped) stream for shingling plus the signature's
    virtual length and true histogram for the exact/length/histogram
    layers."""
    hist = {int(i): int(c) for i, c in enumerate(sig.hist) if c}
    return fingerprint_tokens(sig.materialize(), n_perms=n_perms,
                              shingle=shingle, cache=cache,
                              virtual_len=len(sig), histogram=hist)


def fingerprint_profile(prof, n_perms: int = 64,
                        shingle: int = 4) -> Fingerprint:
    """Fingerprint a Detailed-mode profile: the expanded op stream plus the
    per-site candidate-byte histogram (the shape-sensitive aggregate that
    separates seq-len buckets whose op streams tokenize identically)."""
    site_bytes: Dict[str, int] = {}
    for t in prof.candidates:
        if t.site:
            site_bytes[t.site] = site_bytes.get(t.site, 0) + t.nbytes
    return fingerprint_tokens(prof.op_tokens, site_bytes,
                              n_perms=n_perms, shingle=shingle)


# ------------------------------------------------------------- similarity
def _hist_cosine(a: Dict, b: Dict) -> float:
    if not a or not b:
        return 1.0 if not a and not b else 0.0
    keys = set(a) | set(b)
    va = np.array([a.get(k, 0) for k in keys], np.float64)
    vb = np.array([b.get(k, 0) for k in keys], np.float64)
    denom = np.linalg.norm(va) * np.linalg.norm(vb)
    return float(va @ vb / denom) if denom else 0.0


def _ratio(a: float, b: float) -> float:
    if a <= 0 and b <= 0:
        return 1.0
    if a <= 0 or b <= 0:
        return 0.0
    return min(a, b) / max(a, b)


def length_ratio(a: Fingerprint, b: Fingerprint) -> float:
    return _ratio(a.length, b.length)


def jaccard_estimate(a: Fingerprint, b: Fingerprint) -> float:
    if a.minhash.size == 0 or a.minhash.size != b.minhash.size:
        return 0.0
    return float(np.mean(a.minhash == b.minhash))


# non-identical fingerprints can blend to a perfect component score
# (e.g. a token-only fingerprint vs an identically tokenizing program of
# different shapes); the cap keeps 1.0 the exclusive mark of exact-hash
# equality so callers may use it as an identity test
_NON_EXACT_CAP = 1.0 - 1e-6


def similarity(a: Fingerprint, b: Fingerprint) -> float:
    """Calibrated similarity in [0, 1]; returns exactly 1.0 *only* for
    equal exact hashes.

    Weights (validated by tests/test_policystore.py property sweeps):
    the shingle Jaccard carries sequence *content and order*, the
    histogram cosine carries operator mix, the length ratio penalizes
    growth/shrinkage, and — when both sides carry profile aggregates —
    the per-site byte cosine and total-byte ratio penalize shape drift
    that is invisible to the token stream."""
    if a.exact == b.exact:
        return 1.0
    jac = jaccard_estimate(a, b)
    cos = _hist_cosine(a.histogram, b.histogram)
    lr = length_ratio(a, b)
    if a.site_bytes and b.site_bytes:
        site_cos = _hist_cosine(a.site_bytes, b.site_bytes)
        bytes_r = _ratio(a.cand_bytes, b.cand_bytes)
        score = (0.40 * jac + 0.20 * cos + 0.20 * lr
                 + 0.10 * site_cos + 0.10 * bytes_r)
    else:
        score = 0.45 * jac + 0.30 * cos + 0.25 * lr
    return min(score, _NON_EXACT_CAP)
