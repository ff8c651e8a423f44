"""Operator-sequence tokenization (§4, Lightweight mode) over the aten
dispatch stream.

The paper assigns an integer to each operator name and represents the
iteration's operator sequence as an integer tensor; change detection then
reduces to a length check plus a cosine similarity — no strings at runtime.

Port of ``repro/core/tokenizer.py``.  The reference tokenizes the traced
jaxpr of every jitted function an iteration dispatches.  PyTorch eager has
no jaxpr: here an "operator" is one op of the real dispatch stream, the
paper's own Eager-mode setting.  :class:`OpStreamRecorder` is a
``TorchDispatchMode`` that appends one token per dispatched op, keyed by
the op (``aten::mm``, ``repro_torch::flash_attention_fwd``: the port's
hand-written kernels are custom ops, so each launch is one token with its
real inputs and outputs).  ``with recorder.iteration() as it: ...`` records
one iteration; ``it.stream`` is its :class:`TokenStream`.

Steady-state cost (the Table-1 "always on" constraint): the hot path looks
nothing up by string.  A new op is named and given its token once; after
that each dispatched op costs one dict lookup keyed by the op object and
one integer store into a preallocated buffer, and the histogram is one
``np.bincount`` when the iteration ends.  ``overhead_s`` sums the time
spent in that bookkeeping and in closing iterations (the reference's
``profiling_overhead_s``); the interpreter's own cost of entering a
Python dispatch mode for every op is not in it — the step time with the
recorder on against off measures that.

The dispatch mode travels with PyTorch's thread-local state, so ops the
autograd engine runs on its device thread are recorded too; the
recorder's state lives on the object, not in a ``threading.local``.

What is pure numpy — :class:`OpVocab`, :class:`TokenStream`,
:class:`Signature`, :class:`SignatureAccumulator`, the histograms and the
similarities — is a copy of the reference's.
"""
from __future__ import annotations

import contextlib
import hashlib
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# max materialized copies of a scan-replicated token per equation; virtual
# length and histograms always use the true multiplicity (the reference's
# jaxpr walk caps scan repeats; an eager stream has no scans, so a
# recorded stream is always fully materialized)
REPEAT_CAP = 64

# degenerate-token-id guard: histogram buffers never grow past this many
# bins — ids above (corrupt streams, foreign vocabularies) collapse into
# the last bin instead of sizing a multi-GiB bincount buffer
MAX_DENSE_TOKEN = 1 << 20


class OpVocab:
    """Operator-name -> integer token (grown on demand)."""

    def __init__(self):
        self._ids: Dict[str, int] = {}

    def id(self, name: str) -> int:
        tok = self._ids.get(name)
        if tok is None:
            tok = len(self._ids) + 1  # 0 reserved
            self._ids[name] = tok
        return tok

    def __len__(self):
        return len(self._ids)


GLOBAL_VOCAB = OpVocab()


def _clip_tokens(tokens: np.ndarray) -> np.ndarray:
    """Collapse degenerate huge ids into the last dense bin."""
    if tokens.size and int(tokens.max(initial=0)) > MAX_DENSE_TOKEN:
        return np.minimum(tokens, MAX_DENSE_TOKEN)
    return tokens


def token_histogram(tokens: np.ndarray,
                    minlength: int = 0) -> np.ndarray:
    """Bounded-size int64 operator-count histogram of a token array."""
    if tokens.size == 0:
        return np.zeros(max(minlength, 1), np.int64)
    return np.bincount(_clip_tokens(tokens),
                       minlength=minlength).astype(np.int64)


class TokenStream:
    """One dispatch's tokenized op stream plus its monitoring metadata.

    ``tokens`` is the materialized stream (scan repeats capped at
    :data:`REPEAT_CAP` per equation); ``virtual_len`` and ``hist`` carry
    the *true* run-length-aware op count and per-operator multiplicities,
    which is what similarity/length-diff detection must see.
    ``content_hash`` identifies the true stream (two streams whose capped
    materializations collide but whose virtual multiplicities differ hash
    differently).
    """

    __slots__ = ("tokens", "virtual_len", "hist", "content_hash")

    def __init__(self, tokens: np.ndarray, virtual_len: Optional[int] = None,
                 hist: Optional[np.ndarray] = None):
        self.tokens = np.asarray(tokens, np.int32)
        self.virtual_len = (int(self.tokens.size) if virtual_len is None
                            else int(virtual_len))
        self.hist = (token_histogram(self.tokens) if hist is None
                     else np.asarray(hist, np.int64))
        h = hashlib.blake2b(digest_size=16)
        h.update(self.tokens.tobytes())
        h.update(self.virtual_len.to_bytes(8, "little"))
        h.update(np.ascontiguousarray(self.hist).tobytes())
        self.content_hash = h.digest()

    def __len__(self):
        return self.virtual_len


# ------------------------------------------------------------ the recorder
def op_name(func) -> str:
    """The operator's name without its overload: ``aten::mm``."""
    schema = getattr(func, "_schema", None)
    return schema.name if schema is not None else str(func)


class OpTokens:
    """Op object -> token, naming each new op once; 0 for what is no
    operator of the program (:func:`not_an_op`)."""

    __slots__ = ("vocab", "_tok")

    def __init__(self, vocab: OpVocab):
        self.vocab = vocab
        self._tok: Dict[object, int] = {}

    def __call__(self, func) -> int:
        tok = self._tok.get(func)
        if tok is None:
            tok = self._tok[func] = (0 if not_an_op(func)
                                     else self.vocab.id(op_name(func)))
        return tok


class TokenBuffer:
    """Preallocated int32 token buffer, doubled when full."""

    __slots__ = ("buf", "n")

    def __init__(self, capacity: int = 1 << 14):
        self.buf = np.zeros(max(int(capacity), 16), np.int32)
        self.n = 0

    def append(self, tok: int) -> int:
        """Store ``tok``; returns the count of tokens so far."""
        n = self.n
        if n == self.buf.size:
            self.buf = np.concatenate([self.buf, np.zeros_like(self.buf)])
        self.buf[n] = tok
        self.n = n + 1
        return n + 1

    def take(self) -> np.ndarray:
        """The recorded tokens (a copy); the buffer starts over."""
        out = self.buf[: self.n].copy()
        self.n = 0
        return out


HOOK_NEVER = 1 << 62
# ``detach`` is not an operator of the program: autograd dispatches it
# around saved tensors, and how many depends on whether saved-tensor hooks
# are registered (an executor's are) and on the PyTorch version.  No
# counting mode records it.
DETACH = torch.ops.aten.detach.default


def not_an_op(func) -> bool:
    """``detach`` (above), and the ``profiler`` namespace's ops: a
    ``record_function`` range dispatches its enter and exit through every
    active dispatch mode, with the profiler on or off, so a range opened
    inside a recorded dispatch would add tokens and shift every later op
    index of a swap plan.  No counting mode records either."""
    return func is DETACH or func.namespace == "profiler"


class CountingMode(TorchDispatchMode):
    """A dispatch mode that numbers the ops it records: the recorder's
    Lightweight mode and the profiler's Detailed mode.  The executor
    (``core.executor``) releases and prefetches by op index, in the
    numbering of the profile its plan came from; it hooks into the
    counting mode that is already recording the step instead of stacking
    a second mode: ``hook(i)`` runs before the op of index ``i`` (the
    count of ops recorded before it) once ``i >= hook_at``."""

    def __init__(self):
        super().__init__()
        self.hook = None
        self.hook_at = HOOK_NEVER

    def count(self) -> int:
        """Ops recorded so far."""
        raise NotImplementedError


class _RecordingMode(CountingMode):
    def __init__(self, rec: "OpStreamRecorder"):
        super().__init__()
        self.rec = rec

    def count(self) -> int:
        return self.rec._buf.n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        t0 = time.perf_counter()
        rec = self.rec
        tok = rec._tokens(func)
        if not tok:
            return func(*args, **(kwargs or {}))
        n = rec._buf.append(tok)
        rec.overhead_s += time.perf_counter() - t0
        if n > self.hook_at:
            self.hook(n - 1)
        return func(*args, **(kwargs or {}))


class Iteration:
    """What ``OpStreamRecorder.iteration`` yields; ``stream`` is set when
    the iteration ends."""

    __slots__ = ("stream",)

    def __init__(self):
        self.stream: Optional[TokenStream] = None


class OpStreamRecorder:
    """Lightweight mode: one :class:`TokenStream` per iteration, from the
    ops dispatched while ``iteration()`` is open."""

    def __init__(self, vocab: OpVocab = GLOBAL_VOCAB,
                 capacity: int = 1 << 14):
        self._tokens = OpTokens(vocab)
        self._buf = TokenBuffer(capacity)
        self.overhead_s = 0.0
        self.iterations = 0

    @contextlib.contextmanager
    def iteration(self):
        it = Iteration()
        self._buf.n = 0
        with _RecordingMode(self):
            yield it
        t0 = time.perf_counter()
        it.stream = TokenStream(self._buf.take())
        self.iterations += 1
        self.overhead_s += time.perf_counter() - t0


# --------------------------------------------------------------- signatures
class Signature:
    """One iteration's op-sequence signature in histogram space.

    Carries the (virtual) length and operator-count histogram that Algo 1's
    length-diff + cosine test needs, plus an optional identity ``key`` (the
    tuple of per-dispatch content hashes) that lets an unchanged iteration
    short-circuit to (0, 1) without touching any array.  ``materialize()``
    concatenates the underlying token arrays lazily — only episodic
    consumers (fingerprinting at store time) pay for it.
    """

    __slots__ = ("length", "hist", "key", "_streams", "_tokens", "_norm")

    def __init__(self, length: int, hist: np.ndarray,
                 key: Optional[tuple] = None,
                 streams: Optional[List[TokenStream]] = None):
        self.length = int(length)
        self.hist = hist
        self.key = key
        self._streams = streams
        self._tokens: Optional[np.ndarray] = None
        self._norm: Optional[float] = None

    @classmethod
    def from_tokens(cls, tokens: np.ndarray) -> "Signature":
        tokens = np.asarray(tokens)
        sig = cls(tokens.size, token_histogram(tokens))
        sig._tokens = tokens.astype(np.int32, copy=False)
        return sig

    @property
    def norm(self) -> float:
        if self._norm is None:
            self._norm = float(np.linalg.norm(self.hist.astype(np.float64)))
        return self._norm

    def materialize(self) -> np.ndarray:
        """Concatenated (capped) token stream of the iteration."""
        if self._tokens is None:
            arrs = [s.tokens for s in (self._streams or []) if s.tokens.size]
            self._tokens = (np.concatenate(arrs) if arrs
                            else np.zeros((0,), np.int32))
        return self._tokens

    def __len__(self):
        return self.length


class SignatureAccumulator:
    """Maintains the iteration signature incrementally.

    ``update`` diffs the new dispatch-stream list against the previous one
    by content hash and applies histogram/length deltas only for the slots
    that changed — the steady-state iteration (everything cached upstream)
    does a handful of 16-byte compares and no array work.  The counters
    make the O(changed dispatches) claim testable: ``update_tokens`` grows
    only by the virtual length of streams actually re-accumulated.
    """

    def __init__(self):
        self._prev: List[TokenStream] = []
        self._hist = np.zeros(1, np.int64)
        self._length = 0
        self.iterations = 0
        self.changed_slots = 0
        self.update_tokens = 0

    # ---- delta application
    def _grow(self, n: int) -> None:
        if n > self._hist.size:
            self._hist = np.concatenate(
                [self._hist, np.zeros(n - self._hist.size, np.int64)])

    def _apply(self, stream: TokenStream, sign: int) -> None:
        self._grow(stream.hist.size)
        self._hist[: stream.hist.size] += sign * stream.hist
        self._length += sign * stream.virtual_len
        self.update_tokens += stream.virtual_len

    def update(self, streams: List[TokenStream]) -> Signature:
        self.iterations += 1
        prev = self._prev
        for i in range(max(len(prev), len(streams))):
            old = prev[i] if i < len(prev) else None
            new = streams[i] if i < len(streams) else None
            if (old is not None and new is not None
                    and old.content_hash == new.content_hash):
                continue
            self.changed_slots += 1
            if old is not None:
                self._apply(old, -1)
            if new is not None:
                self._apply(new, +1)
        self._prev = list(streams)
        return Signature(self._length, self._hist.copy(),
                         key=tuple(s.content_hash for s in streams),
                         streams=list(streams))

    def stats(self) -> dict:
        return {"iterations": self.iterations,
                "changed_slots": self.changed_slots,
                "update_tokens": self.update_tokens}


def sequence_signature(token_streams: Iterable) -> np.ndarray:
    """Concatenate per-dispatch token streams (arrays or TokenStreams) of
    one iteration into the materialized array form."""
    arrs = [s.tokens if isinstance(s, TokenStream) else s
            for s in token_streams]
    arrs = [a for a in arrs if a.size]
    if not arrs:
        return np.zeros((0,), np.int32)
    return np.concatenate(arrs)


# --------------------------------------------------------------- similarity
def sig_similarity(a: Signature, b: Signature) -> Tuple[float, float]:
    """(relative length difference, histogram cosine) between two
    iteration signatures.  Identical content keys short-circuit without
    touching any array — the steady-state path."""
    if a.key is not None and a.key == b.key:
        return 0.0, 1.0
    la, lb = a.length, b.length
    if la == 0 and lb == 0:
        return 0.0, 1.0
    if la == 0 or lb == 0:
        return 1.0, 0.0
    len_diff = abs(la - lb) / max(la, lb)
    m = min(a.hist.size, b.hist.size)
    denom = a.norm * b.norm
    cos = float(a.hist[:m] @ b.hist[:m] / denom) if denom else 0.0
    return len_diff, cos


def similarity(a: np.ndarray, b: np.ndarray) -> Tuple[float, float]:
    """(relative length difference, cosine similarity).

    Cosine is computed on the operator-count histogram, which is the
    length-robust form of the paper's tensor cosine (identical when
    lengths match and ops only reorder/extend).  Histogram buffers are
    bounded: token ids above :data:`MAX_DENSE_TOKEN` collapse into one bin
    instead of sizing the bincount by the largest id seen."""
    la, lb = len(a), len(b)
    if la == 0 and lb == 0:
        return 0.0, 1.0
    if la == 0 or lb == 0:
        return 1.0, 0.0
    len_diff = abs(la - lb) / max(la, lb)
    ha, hb = token_histogram(a), token_histogram(b)
    m = min(ha.size, hb.size)
    denom = np.linalg.norm(ha.astype(np.float64)) * \
        np.linalg.norm(hb.astype(np.float64))
    cos = float(ha[:m] @ hb[:m] / denom) if denom else 0.0
    return len_diff, cos
