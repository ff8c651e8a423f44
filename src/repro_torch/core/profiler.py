"""Online profiler — Detailed mode (§4) over one real eager step.

Port of ``repro/core/profiler.py``.  The reference walks the traced
step's jaxpr; here ``profile_step(fn)`` runs ``fn`` once under a recording
``TorchDispatchMode`` and produces the same ``ProfileData``:

  * the operator stream: one token per dispatched op, as the Lightweight
    recorder (``core.tokenizer``) gives it;
  * tensor instances with liveness, one per **storage** of at least
    ``MIN_TRACK_BYTES`` that an op of the step allocated.  Views, in-place
    updates and ``tag`` alias a storage and add nothing.  Birth is the
    index after the producing op; death is the op count when the storage
    is freed (a weakref callback on the storage), not its last use: in
    eager a storage lives until its last reference goes, and saved
    tensors and Python locals hold it past its last use.  A storage still
    alive when ``fn`` returns lives to the end (``n_ops``);
  * the candidates: storages that ``core.sites.tag`` labelled with (site,
    layer) while recording — the first label a storage receives is kept
    (layer i's ``resid_post`` is layer i+1's ``ln_in``: one buffer, one
    instance, labelled ``resid_post``);
  * one measured iteration time ``t_iter`` (a single wall-clock number —
    the paper's key constraint: **no per-operator timings are collected**).

Static memory is what is allocated when the step starts: on a CUDA device
``torch.cuda.memory_allocated()``, on the CPU the bytes of the storages of
every live tensor.  As in the reference it is a constant base; the
timeline is the dynamic memory the step allocates on top of it.
"""
from __future__ import annotations

import functools
import gc
import time
import warnings
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import sites
from repro_torch.core.sites import base_site
from repro_torch.core.tokenizer import (GLOBAL_VOCAB, CountingMode,
                                        OpTokens, OpVocab, TokenBuffer)

MIN_TRACK_BYTES = 1 << 10

_DTYPE_CODES: Dict[str, int] = {}


def dtype_code(dt) -> int:
    """Small integer per dtype name (``float32``, ``bfloat16``, ...): the
    reference's names, so a torch dtype and its JAX twin share a name."""
    s = str(dt).replace("torch.", "")
    if s not in _DTYPE_CODES:
        _DTYPE_CODES[s] = len(_DTYPE_CODES) + 1
    return _DTYPE_CODES[s]


@dataclass
class TensorInstance:
    uid: int
    nbytes: int
    birth: int                 # op index where allocated
    death: int                 # op index where freed
    site: Optional[str] = None  # canonical site name (tagged storages)
    layer: int = -1             # block index (-1 = outside the stack)
    dtype_code: int = 0
    shape: Tuple[int, ...] = ()
    producer_token: int = 0
    # not a field (the instance's fields are the reference's): the order of
    # the storage's label among its (site, layer)'s labels, -1 when not
    # recorded; the executor numbers the storages it labels the same way
    # to find each one's instance in the profile
    tag_seq = -1

    @property
    def is_candidate(self) -> bool:
        return self.site is not None


@dataclass
class ProfileData:
    op_tokens: np.ndarray               # the step's op stream
    tensors: List[TensorInstance]
    t_iter: float                       # measured iteration wall time (s)
    static_bytes: int                   # resident bytes when the step began
    n_ops: int = 0
    scan_layers: int = 0                # main stack length

    def __post_init__(self):
        self.n_ops = int(len(self.op_tokens))

    def __setattr__(self, name, value):
        # replacing the tensor list must drop the derived candidate/feature
        # caches
        if name == "tensors":
            self.__dict__.pop("_candidates", None)
            self.__dict__.pop("_cand_feat_cache", None)
        object.__setattr__(self, name, value)

    @property
    def candidates(self) -> List[TensorInstance]:
        cached = self.__dict__.get("_candidates")
        if cached is None:
            cached = [t for t in self.tensors if t.is_candidate]
            self.__dict__["_candidates"] = cached
        return cached

    def feature_arrays(self):
        """Packed int64 candidate-feature arrays (see ``core.matching``),
        computed lazily and cached."""
        from repro_torch.core.matching import candidate_feature_arrays
        return candidate_feature_arrays(self)

    @classmethod
    def from_arrays(cls, op_tokens, nbytes, birth, death, *,
                    t_iter: float, static_bytes: int,
                    uids: Optional[Sequence[int]] = None,
                    sites: Optional[Sequence[Optional[str]]] = None,
                    layers: Optional[Sequence[int]] = None,
                    dtype_codes: Optional[Sequence[int]] = None,
                    shapes: Optional[Sequence[Tuple[int, ...]]] = None,
                    producer_tokens: Optional[Sequence[int]] = None,
                    scan_layers: int = 0) -> "ProfileData":
        """A profile from plain numpy arrays and tuples, one entry per
        tensor instance (what a profile of the reference carries across
        packages, as ``models/convert.py`` carries weights)."""
        n = len(nbytes)

        def col(v, default):
            return [default] * n if v is None else list(v)

        tensors = [TensorInstance(int(u), int(b), int(s), int(d), site,
                                  int(l), int(dc), tuple(int(x) for x in sh),
                                  int(pt))
                   for u, b, s, d, site, l, dc, sh, pt in zip(
                       range(n) if uids is None else uids,
                       nbytes, birth, death, col(sites, None),
                       col(layers, -1), col(dtype_codes, 0), col(shapes, ()),
                       col(producer_tokens, 0))]
        return cls(np.asarray(op_tokens, np.int32), tensors, float(t_iter),
                   int(static_bytes), scan_layers=int(scan_layers))


# --------------------------------------------------------------------------
def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):   # sparse and the like
        return None


class _Recording:
    """The state of one detailed profile: tokens, live storages, instances.

    A storage's weakref callback runs on whichever thread frees it (the
    autograd engine's device thread in a CUDA backward); it only pops a
    dict entry and stamps the op count."""

    def __init__(self, vocab: OpVocab, min_track_bytes: int):
        self.tokens = OpTokens(vocab)
        self.buf = TokenBuffer()
        self.min_track_bytes = int(min_track_bytes)
        self.tensors: List[TensorInstance] = []
        self.tag_seqs: Dict[Tuple[str, int], int] = {}
        # storage address -> (instance, weakref to the storage)
        self.live: Dict[int, Tuple[TensorInstance, weakref.ref]] = {}

    def _freed(self, key: int, _ref) -> None:
        entry = self.live.pop(key, None)
        if entry is not None:
            entry[0].death = self.buf.n

    def note_outputs(self, func, tok: int, n: int, out, args, kwargs) -> None:
        returns = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) else (out,)
        inputs = None
        for i, o in enumerate(outs):
            if i < len(returns) and returns[i].alias_info is not None:
                continue                  # a view or an in-place result
            for t in (o if isinstance(o, (tuple, list)) else (o,)):
                if not isinstance(t, torch.Tensor):
                    continue
                st = _storage(t)
                if st is None or st._cdata in self.live:
                    continue
                nb = st.nbytes()
                if nb < self.min_track_bytes:
                    continue
                if inputs is None:        # an unannotated alias of an input
                    inputs = {s._cdata for s in map(_storage, _tensors(
                        args, kwargs)) if s is not None}
                if st._cdata in inputs:
                    continue
                inst = TensorInstance(len(self.tensors), nb, n, -1,
                                      dtype_code=dtype_code(t.dtype),
                                      shape=tuple(t.shape),
                                      producer_token=tok)
                self.tensors.append(inst)
                key = st._cdata
                self.live[key] = (inst, weakref.ref(
                    st, functools.partial(self._freed, key)))

    def note_site(self, x, name: str, layer: int) -> None:
        if not isinstance(x, torch.Tensor):
            return
        st = _storage(x)
        entry = self.live.get(st._cdata) if st is not None else None
        if entry is not None and entry[0].site is None:
            inst = entry[0]
            inst.site = base_site(name)
            inst.layer = layer
            inst.shape = tuple(x.shape)       # the tagged view's shape
            key = (inst.site, layer)
            inst.tag_seq = self.tag_seqs.get(key, 0)
            self.tag_seqs[key] = inst.tag_seq + 1

    def finish(self) -> Tuple[np.ndarray, List[TensorInstance]]:
        n = self.buf.n
        for inst, _ref in self.live.values():
            inst.death = n                # still alive: lives to the end
        self.live.clear()                 # drops the weakrefs and callbacks
        return self.buf.take(), self.tensors


def _tensors(args, kwargs):
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (tuple, list)):
            yield from (x for x in a if isinstance(x, torch.Tensor))


class _DetailedMode(CountingMode):
    def __init__(self, rec: _Recording):
        super().__init__()
        self.rec = rec

    def count(self) -> int:
        return self.rec.buf.n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = self.rec
        tok = rec.tokens(func)
        if not tok:
            return func(*args, **kwargs)
        n = rec.buf.append(tok)
        if n > self.hook_at:
            self.hook(n - 1)
        out = func(*args, **kwargs)
        rec.note_outputs(func, tok, n, out, args, kwargs)
        return out


def _live_tensor_bytes() -> int:
    """Bytes of the distinct storages of every live CPU tensor.  Garbage
    that only a cycle keeps (a finished trainer, say) is collected first,
    so the base does not depend on when the collector last ran."""
    seen: Dict[int, int] = {}
    gc.collect()
    with warnings.catch_warnings():
        # isinstance() on deprecated module-level aliases torch keeps warns
        warnings.simplefilter("ignore", FutureWarning)
        tensors = [o for o in gc.get_objects() if isinstance(o, torch.Tensor)]
    for o in tensors:
        if o.device.type == "cpu":
            st = _storage(o)
            if st is not None:
                seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def profile_step(fn: Callable[[], object], *,
                 device: Union[str, torch.device, None] = None,
                 vocab: OpVocab = GLOBAL_VOCAB,
                 min_track_bytes: int = MIN_TRACK_BYTES,
                 static_bytes: Optional[int] = None) -> ProfileData:
    """Detailed mode: run ``fn()`` once (one training step) and return its
    profile.  ``device`` is where the step runs (default ``cuda``);
    ``t_iter`` is the wall time of this run, from a device synchronisation
    before it to one after it.  ``static_bytes`` overrides the measured
    static base (module doc)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        static = torch.cuda.memory_allocated(dev)
    else:
        static = _live_tensor_bytes()
    if static_bytes is not None:
        static = int(static_bytes)
    rec = _Recording(vocab, min_track_bytes)
    t0 = time.perf_counter()
    with sites.recording(rec), _DetailedMode(rec):
        fn()
        if cuda:
            torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    tokens, tensors = rec.finish()
    layers = [t.layer for t in tensors if t.site is not None]
    return ProfileData(tokens, tensors, wall, static,
                       scan_layers=max(layers, default=-1) + 1)
