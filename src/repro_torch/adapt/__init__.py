"""repro_torch.adapt — the adaptation pipeline and its placement.

Port of ``repro.adapt``: the paper's §5 cycle (Detailed profiling →
GenPolicy variant search → policy application), factored out of
``ChameleonRuntime`` into

  * :class:`AdaptSnapshot` — the immutable inputs one adaptation reads;
  * :class:`AdaptationPipeline` — the cycle itself as deterministic
    computation (a copy of the reference's);
  * :class:`AdaptationService` — the placement: the inline bookkeeping,
    and for ``async`` / ``speculative`` a job queue, one worker thread
    (numpy only: it never touches the card), a single-slot mailbox with
    generation-counter staleness, and speculative pre-generation of
    policies for recurring fingerprints (:class:`RecurrencePredictor`).
"""
from repro_torch.adapt.pipeline import (VARIANT_KNOBS, AdaptResult,
                                        AdaptationPipeline, CachedApply,
                                        PolicyVariant)
from repro_torch.adapt.service import (AdaptJob, AdaptationService,
                                       RecurrencePredictor)
from repro_torch.adapt.snapshot import AdaptSnapshot, FrozenBacklog

__all__ = [
    "AdaptJob",
    "AdaptResult",
    "AdaptSnapshot",
    "AdaptationPipeline",
    "AdaptationService",
    "CachedApply",
    "FrozenBacklog",
    "PolicyVariant",
    "RecurrencePredictor",
    "VARIANT_KNOBS",
]
