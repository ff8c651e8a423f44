"""Activation-site tagging.

Port of ``repro/core/sites.py``.  Every offloadable activation of the
model zoo is tagged with a site name; the policy generator selects sites,
the executor (ROADMAP.md queue 1 item 4b, through saved-tensor hooks)
offloads them, and the fuzzy matcher (§6.1) re-associates policy entries
with sites after the program changes.

The reference names a traced variable (``checkpoint_name``).  Eager
PyTorch has no trace to name, so ``tag`` labels the tensor's *storage*:
while a detailed profile records (``core.profiler.profile_step``), which
keeps the (site, layer) of the first tag a storage receives, and while an
executor runs a step under an applied policy (``core.executor``), which
labels storages the same way and decides, when autograd saves a tensor,
whether its storage is offloaded, recomputed or kept.  The layer is the
index of the block ``models/transformer.py::_forward`` is running
(``layer``; ``models/whisper.py`` numbers its encoder's and its decoder's
blocks from 0 each, as the reference's two scans do), -1 outside the
stack.  When neither is active, ``tag``
checks the name and returns ``x`` after two flag checks.

``tag(x, site, recompute=(fn, args))`` also tells the executor how to
rebuild ``x`` from ``args`` (``fn(*args)`` gives ``x`` bit for bit): what
a site in the applied policy's remat set needs.

The state ``tag`` reads (the recording profiler, the executor, the layer,
the prefix) is process-wide on purpose, not a ``threading.local`` as the
reference's: on a CUDA device the autograd engine runs the backward on
its own thread, and whatever runs there (the profiler's frees, the
executor's unpack hooks) must see the state the forward set.
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
    __slots__ = ("prefix", "layer", "recorder", "executor")

    def __init__(self):
        self.prefix = ""
        self.layer = -1
        self.recorder = None      # the recording profile, or None
        self.executor = None      # the running executor, or None


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


@contextlib.contextmanager
def executing(executor):
    """Route ``tag`` to ``executor.note_site(x, name, layer, recompute)``
    while open."""
    if _STATE.executor is not None:
        raise RuntimeError("an executor is already running a step")
    _STATE.executor = executor
    try:
        yield
    finally:
        _STATE.executor = None


def tag(x, site: str, recompute=None):
    """Check ``site`` against the vocabulary and return ``x``; while a
    detailed profile records or an executor runs, label ``x``'s storage
    with (site, layer).  ``recompute`` is ``(fn, args)`` with
    ``fn(*args)`` equal to ``x``, or None."""
    if site not in SITE_INDEX:
        raise ValueError(f"unknown site {site!r}")
    rec = _STATE.recorder
    if rec is not None:
        rec.note_site(x, _STATE.prefix + site, _STATE.layer)
    ex = _STATE.executor
    if ex is not None:
        ex.note_site(x, _STATE.prefix + site, _STATE.layer, recompute)
    return x


def base_site(name: str) -> str:
    """Strip any l{i}/ prefix back to the canonical site."""
    return name.rsplit("/", 1)[-1]
