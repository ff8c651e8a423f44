"""repro_torch.policystore — persistent policy cache with op-sequence
fingerprinting and tiered drift response.

A numpy copy of ``repro/policystore/__init__.py`` (no JAX in it):
fingerprints, records and decisions equal the reference's for the same
inputs.

Chameleon's stage machine treats every significant sequence change the
same way: WarmUp from scratch, then a fresh five-variant GenPolicy
search.  For *recurring* sequences (train→eval→train interleaves,
seq-len bucket cycling, periodic routing shifts) that adaptation tax is
pure waste — the policy that worked last time still works, it just needs
to be found and re-associated.  This package turns adaptation from
O(regen) into O(lookup):

  * :mod:`fingerprint` — drift-tolerant sketches of tokenized op streams
    (exact hash + shingled MinHash + aggregate features) with a
    calibrated similarity metric;
  * :mod:`store` — a versioned, corruption-safe LRU store (in-memory +
    optional on-disk JSON) mapping fingerprints to serialized policies,
    their measured iteration times, and the bandwidth snapshot they were
    priced under;
  * :mod:`drift` — the three-tier classifier routing an observed
    sequence to reuse / warm-start / regen.

Wired into :class:`~repro_torch.core.runtime.ChameleonRuntime` (see
``docs/policystore.md``); the same store directory can be shared across
processes and restarts.
"""
from __future__ import annotations

from repro_torch.policystore.drift import (DriftClassifier, DriftDecision,
                                           Tier, bandwidth_drift)
from repro_torch.policystore.fingerprint import (
    Fingerprint, clear_fingerprint_cache, fingerprint_profile,
    fingerprint_signature, fingerprint_tokens, jaccard_estimate,
    length_ratio, minhash_signature, similarity)
from repro_torch.policystore.lshindex import LSHIndex
from repro_torch.policystore.store import (SCHEMA_VERSION, PolicyRecord,
                                           PolicyStore)

__all__ = [
    "DriftClassifier", "DriftDecision", "Fingerprint", "LSHIndex",
    "PolicyRecord", "PolicyStore", "SCHEMA_VERSION", "Tier",
    "bandwidth_drift", "clear_fingerprint_cache", "fingerprint_profile",
    "fingerprint_signature", "fingerprint_tokens", "jaccard_estimate",
    "length_ratio", "minhash_signature", "similarity",
]
