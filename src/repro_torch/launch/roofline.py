"""Roofline terms of one eager step.

Port of ``repro/launch/roofline.py``:

  compute    = step_FLOPs_per_chip / peak_FLOP/s
  memory     = step_HBM_bytes_per_chip / HBM_bw
  collective = wire_bytes_per_chip / link_bw

The reference reads a compiled dry-run artifact: it walks the step's
jaxpr with scan multiplicity and parses the HLO's while loops for their
trip counts.  The port runs the step eagerly (on fake tensors in the dry
run) under ``step_cost``, which counts what runs: eager mode runs every
loop iteration and every recomputation, so there is no trip-count walk to
port, and recompute under ``torch.utils.checkpoint`` is visible as it is in
the reference's jaxpr.  Each rank runs its own (local) step, so the counts
are per chip as they are.

  * flops: ``torch.utils.flop_counter.FlopCounterMode``, with formulas for
    K1's two custom ops (``repro_torch::flash_attention_fwd`` / ``_bwd``)
    that count what ``chip_smoke.attention_bound`` counts (4·D flops per
    unmasked (query, key) pair and head forward, 10·D backward), so a
    step's flops do not depend on which attention implementation ran;
  * HBM bytes: the reference's post-fusion traffic proxy — matrix-product
    and convolution operands plus outputs (K1's ops counted the same way),
    gather outputs, and every storage ``core.sites.tag`` labels counted
    twice (store + load);
  * collective bytes per kind from a dispatch mode over the c10d ops, with
    the reference's ``_WIRE_FACTOR`` (an all-reduce moves its bytes twice:
    ring reduce-scatter + all-gather; an all-gather or a reduce-scatter
    counts its result).

Hardware constants come from ``kernels.autotune.device``'s registry
(default ``h100_sxm``): one spec feeds this report and the autotuner.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import sites
from repro_torch.kernels.autotune.device import DeviceSpec, get_device_spec

_DEFAULT_SPEC = get_device_spec()
# module-level aliases kept for existing callers/tests; the spec registry
# is the source of truth
PEAK_FLOPS = _DEFAULT_SPEC.peak_flops
HBM_BW = _DEFAULT_SPEC.hbm_bw
ICI_BW = _DEFAULT_SPEC.ici_bw
HOST_BW = _DEFAULT_SPEC.host_bw

_WIRE_FACTOR = {
    "all-reduce": 2.0,        # ring RS + AG
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# c10d / functional-collective op name -> (kind, which tensors count)
_COLLECTIVES = {
    "allreduce_": ("all-reduce", "in"),
    "allreduce_coalesced_": ("all-reduce", "in"),
    "all_reduce": ("all-reduce", "in"),
    "allgather_": ("all-gather", "out"),
    "_allgather_base_": ("all-gather", "out"),
    "allgather_into_tensor_coalesced_": ("all-gather", "out"),
    "all_gather_into_tensor": ("all-gather", "out"),
    "reduce_scatter_": ("reduce-scatter", "out"),
    "_reduce_scatter_base_": ("reduce-scatter", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "out"),
    "alltoall_": ("all-to-all", "out"),
    "alltoall_base_": ("all-to-all", "out"),
    "all_to_all_single": ("all-to-all", "out"),
    "send": ("collective-permute", "in"),
}

_aten = torch.ops.aten
_MATMULS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm, _aten.matmul,
            _aten.convolution, _aten.convolution_backward,
            _aten._scaled_dot_product_flash_attention,
            _aten._scaled_dot_product_efficient_attention}
_GATHERS = {_aten.index, _aten.gather, _aten.embedding, _aten.index_select,
            _aten.take}


def _bytes(x) -> float:
    if isinstance(x, torch.Tensor):
        return float(x.numel() * x.element_size())
    if isinstance(x, (tuple, list)):
        return sum(_bytes(t) for t in x)
    return 0.0


# ----------------------------------------------------- K1's flop formulas
def _causal_pairs(Sq: int, Sk: int) -> int:
    """Unmasked (query, key) pairs of a causal row block: query q sees keys
    0..q (of Sk)."""
    m = min(Sq, Sk)
    return m * (m + 1) // 2 + (Sq - m) * Sk


def _pairs(q, k, kv_lens, causal) -> int:
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    lens = [Sk] * B
    if kv_lens is not None and not _is_fake(kv_lens) \
            and kv_lens.device.type != "meta":
        lens = [min(max(int(n), 0), Sk) for n in kv_lens.tolist()]
    if causal:
        return sum(_causal_pairs(Sq, n) for n in lens)
    return Sq * sum(lens)


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _register_k1_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula
    from repro_torch.kernels.flash_attention import ops  # noqa: F401

    @register_flop_formula(torch.ops.repro_torch.flash_attention_fwd,
                           get_raw=True)
    def _fwd(q, k, v, kv_lens, causal, sm_scale, with_lse, out_val=None):
        return 4 * q.shape[2] * q.shape[3] * _pairs(q, k, kv_lens, causal)

    @register_flop_formula(torch.ops.repro_torch.flash_attention_bwd,
                           get_raw=True)
    def _bwd(q, k, v, o, lse, do, kv_lens, causal, sm_scale, out_val=None):
        return 10 * q.shape[2] * q.shape[3] * _pairs(q, k, kv_lens, causal)


_register_k1_flops()
_K1 = {torch.ops.repro_torch.flash_attention_fwd,
       torch.ops.repro_torch.flash_attention_bwd}


# ------------------------------------------------------ bytes + collectives
class _CostMode(TorchDispatchMode):
    """HBM-traffic proxy and collective wire bytes of every op dispatched."""

    def __init__(self):
        super().__init__()
        self.hbm = 0.0
        self.collectives: Dict[str, float] = {}
        self.tagged = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        name = packet.__name__
        if packet in _MATMULS or packet in _K1:
            self.hbm += _bytes(list(args)) + _bytes(list(kwargs.values()))
            self.hbm += _bytes(out)
        elif packet in _GATHERS:
            self.hbm += _bytes(out)
        elif name in _COLLECTIVES and func.namespace in ("c10d",
                                                         "_c10d_functional"):
            kind, which = _COLLECTIVES[name]
            # c10d ops take the tensors that count first (the output of a
            # gather or a scatter); functional ones return it
            nb = (_bytes(args[0]) if func.namespace == "c10d"
                  or which == "in" else _bytes(out))
            self.collectives[kind] = (self.collectives.get(kind, 0.0)
                                      + nb * _WIRE_FACTOR[kind])
        return out

    # core.sites recorder: a tagged residual is stored and loaded again
    def note_site(self, x, name: str, layer: int) -> None:
        if isinstance(x, torch.Tensor):
            self.tagged += 2.0 * _bytes(x)


@dataclass
class StepCost:
    """What one eager step did on this chip."""
    flops: float
    hbm_bytes: float
    collectives: Dict[str, float] = field(default_factory=dict)

    @property
    def wire_bytes(self) -> float:
        return float(sum(self.collectives.values()))


def step_cost(fn: Callable[[], object]) -> Tuple[StepCost, object]:
    """Run ``fn()`` once and count its flops, HBM bytes and wire bytes;
    returns (cost, fn's result)."""
    from torch.utils.flop_counter import FlopCounterMode
    cm = _CostMode()
    fc = FlopCounterMode(display=False)
    with fc, cm, _tag_recording(cm):
        out = fn()
    return StepCost(float(fc.get_total_flops()),
                    cm.hbm + cm.tagged,
                    dict(cm.collectives)), out


def _tag_recording(recorder):
    """``core.sites.recording(recorder)``, or nothing when a detailed
    profile already records (its tags then go uncounted)."""
    if sites._STATE.recorder is not None:
        return contextlib.nullcontext()
    return sites.recording(recorder)


# ================================================================== report
@dataclass
class RooflineTerms:
    flops_per_chip: float
    bytes_per_chip: float
    wire_bytes_per_chip: float
    collectives: Dict[str, float]
    chips: int
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0
    useful_flops_ratio: float = 0.0
    step_time_bound_s: float = 0.0
    mfu_bound: float = 0.0
    device_kind: str = ""

    def finalize(self, spec: Optional[DeviceSpec] = None):
        spec = spec or _DEFAULT_SPEC
        self.device_kind = spec.kind
        self.compute_s = self.flops_per_chip / spec.peak_flops
        self.memory_s = self.bytes_per_chip / spec.hbm_bw
        self.collective_s = self.wire_bytes_per_chip / spec.ici_bw
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        self.step_time_bound_s = max(terms.values())
        if self.model_flops and self.step_time_bound_s > 0:
            self.mfu_bound = (self.model_flops
                              / (self.chips * spec.peak_flops
                                 * self.step_time_bound_s))
        if self.flops_per_chip:
            self.useful_flops_ratio = (self.model_flops
                                       / (self.flops_per_chip * self.chips))
        return self

    def to_dict(self):
        return asdict(self)


def analyze(cost: StepCost, chips: int, model_flops: float = 0.0,
            device_kind: Optional[str] = None) -> RooflineTerms:
    """The roofline terms of one chip's ``step_cost``."""
    terms = RooflineTerms(
        flops_per_chip=cost.flops,
        bytes_per_chip=cost.hbm_bytes,
        wire_bytes_per_chip=cost.wire_bytes,
        collectives=dict(cost.collectives),
        chips=chips,
        model_flops=model_flops,
    )
    return terms.finalize(get_device_spec(device_kind)
                          if device_kind else None)


def model_flops_train(param_count: int, tokens: int) -> float:
    return 6.0 * param_count * tokens


def model_flops_decode(param_count: int, batch: int) -> float:
    # one token per sequence: 2·N per token, forward only
    return 2.0 * param_count * batch


def mfu(model_flops: float, chips: int, step_s: float,
        spec: Optional[DeviceSpec] = None) -> float:
    """Model flops over what the chips could do at peak in ``step_s``."""
    spec = spec or _DEFAULT_SPEC
    return model_flops / (chips * spec.peak_flops * step_s) if step_s else \
        math.nan
