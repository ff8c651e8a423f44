"""repro_torch.adapt — the adaptation pipeline and its placement.

Port of ``repro.adapt``: the paper's §5 cycle (Detailed profiling →
GenPolicy variant search → policy application), factored out of
``ChameleonRuntime`` into

  * :class:`AdaptSnapshot` — the immutable inputs one adaptation reads;
  * :class:`AdaptationPipeline` — the cycle itself as deterministic
    computation (a copy of the reference's);
  * :class:`AdaptationService` — the adaptation bookkeeping for the
    ``inline`` placement.  The ``async`` and ``speculative`` placements
    (background worker, mailbox, speculative pre-generation) come with
    ROADMAP.md queue 1 item 8 and raise until then.
"""
from repro_torch.adapt.pipeline import (VARIANT_KNOBS, AdaptResult,
                                        AdaptationPipeline, CachedApply,
                                        PolicyVariant)
from repro_torch.adapt.service import AdaptationService
from repro_torch.adapt.snapshot import AdaptSnapshot, FrozenBacklog

__all__ = [
    "AdaptResult",
    "AdaptSnapshot",
    "AdaptationPipeline",
    "AdaptationService",
    "CachedApply",
    "FrozenBacklog",
    "PolicyVariant",
    "VARIANT_KNOBS",
]
