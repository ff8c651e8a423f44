"""Activation-site tagging.

Port of ``repro/core/sites.py``.  Every offloadable activation of the
model zoo is tagged with a site name; the policy generator selects sites,
the executor (ROADMAP.md queue 1 item 4b, through saved-tensor hooks)
offloads them, and the fuzzy matcher (§6.1) re-associates policy entries
with sites after the program changes.

The reference names a traced variable (``checkpoint_name``).  Eager
PyTorch has no trace to name, so ``tag`` labels the tensor's *storage*
while a detailed profile records (``core.profiler.profile_step``): the
profiler keeps the (site, layer) of the first tag a storage receives.  The
layer is the index of the block ``models/transformer.py::_forward`` is
running (``layer``), -1 outside the stack.  When nothing records, ``tag``
checks the name and returns ``x`` after one flag check.

The state ``tag`` reads (the recording profiler, the layer, the prefix) is
process-wide on purpose, not a ``threading.local`` as the reference's:
on a CUDA device the autograd engine runs the backward on its own thread,
and whatever runs there (the profiler's frees, item 4b's unpack hooks)
must see the state the forward set.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

# The canonical site vocabulary.  Order matters: it is also the one-hot bit
# assignment used by the integer fuzzy matcher (Appendix A adaptation).
OFFLOAD_SITES: Tuple[str, ...] = (
    "embed_out",      # token embedding output
    "ln_in",          # pre-norm input (residual stream snapshot)
    "qkv_proj",       # fused qkv projection output
    "attn_ctx",       # attention context (pre out-proj)
    "attn_out",       # attention block output
    "cross_kv",       # encoder / image KV (enc-dec + VLM)
    "cross_ctx",      # cross-attention context
    "ffn_pre",        # gate/up projection output
    "ffn_act",        # post-activation
    "ffn_out",        # down projection output
    "resid_mid",      # residual after attention
    "resid_post",     # residual after mlp (layer output)
    "router_logits",  # MoE router scores
    "moe_dispatch",   # gathered expert inputs
    "moe_act",        # expert hidden activations
    "moe_out",        # combined expert outputs
    "ssm_in",         # mamba in-projection output
    "ssm_conv",       # post-conv activation
    "ssm_gate",       # gate branch
    "ssm_state",      # SSD chunk states
    "ssm_out",        # mamba block output
    "final_norm",
)
SITE_INDEX = {s: i for i, s in enumerate(OFFLOAD_SITES)}


class _State:
    __slots__ = ("prefix", "layer", "recorder")

    def __init__(self):
        self.prefix = ""
        self.layer = -1
        self.recorder = None      # the recording profile, or None


_STATE = _State()


@contextlib.contextmanager
def site_prefix(prefix: str):
    """Per-layer prefixing for unrolled (fine-grained) mode."""
    prev = _STATE.prefix
    _STATE.prefix = prefix
    try:
        yield
    finally:
        _STATE.prefix = prev


@contextlib.contextmanager
def layer(index: int):
    """The block index that ``tag`` records while the block runs."""
    prev = _STATE.layer
    _STATE.layer = int(index)
    try:
        yield
    finally:
        _STATE.layer = prev


@contextlib.contextmanager
def recording(recorder):
    """Route ``tag`` to ``recorder.note_site(x, name, layer)`` while open."""
    if _STATE.recorder is not None:
        raise RuntimeError("a detailed profile is already recording")
    _STATE.recorder = recorder
    try:
        yield
    finally:
        _STATE.recorder = None


def tag(x, site: str):
    """Check ``site`` against the vocabulary and return ``x``; while a
    detailed profile records, label ``x``'s storage with (site, layer)."""
    if site not in SITE_INDEX:
        raise ValueError(f"unknown site {site!r}")
    rec = _STATE.recorder
    if rec is not None:
        rec.note_site(x, _STATE.prefix + site, _STATE.layer)
    return x


def base_site(name: str) -> str:
    """Strip any l{i}/ prefix back to the canonical site."""
    return name.rsplit("/", 1)[-1]
