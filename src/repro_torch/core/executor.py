"""Executor (paper §6): apply a generated SwapPolicy to the training step.

Port of ``repro/core/executor.py``.  ``AppliedPolicy`` and ``Executor``
keep the reference's fields and methods — ``lower``,
``bind_release_points``, ``conservative``, ``baseline``, ``raw``,
``site_universe`` and ``CHEAP_RECOMPUTE_SITES`` — so one profile gives
the reference's ``offload`` / ``save`` / ``remat`` sets, fingerprints and
release plans (``tests/test_torch_executor.py``).

The reference applies a policy at compile time: a
``save_and_offload_only_these_names`` remat policy and a re-``jit``, with
XLA's schedule placing the copies.  Eager PyTorch has no compile step, so
``AppliedPolicy.to_jax()`` becomes :meth:`Executor.execution`: an
:class:`Execution` the grad step runs under (``distributed/steps.py``),
built from ``torch.autograd.graph.saved_tensors_hooks``, the host tier's
``policy_swap`` traffic class and the (site, layer) labels that
``core.sites.tag`` gives each storage while it runs:

  * **Labels.**  ``tag`` labels a storage with the (site, layer) of its
    first tag, as the detailed profiler does, and numbers the storages of
    each (site, layer) in tag order; with the ``tag_seq`` the profiler
    records, that finds each storage's instance in the profile the plan
    came from.  Storages under ``MIN_TRACK_BYTES`` are not candidates and
    are never moved.  Labels are held weakly: a label goes when its
    storage is freed.
  * **Offload** (``applied.offload``, and the policy's entries).  When
    autograd saves a tensor, the pack hook looks its storage up.  A storage
    of an offloaded site — or one that the swap policy names as an entry,
    whatever its site: the simulator's decisions are per tensor, its
    projected peak counts exactly the entries, and the reference's engine
    moves every entry too (its ``_mirror_policy_swaps``), while its XLA
    lowering can only name whole sites — is staged once, whatever number
    of views of it are saved (q, k and v saved by the attention and again
    by a projection, ``attn_ctx`` by K1 and by the output projection): the
    whole storage goes out as bytes
    through ``engine.submit_swap_out`` with the tag the release plan uses
    (``SwapPolicy.entry_tag`` of its profile instance), and the hook
    returns a handle that holds no device reference.  On a CUDA device
    the engine copies on the class's D2H stream, marks the source with
    ``record_stream`` and drops it at issue, so the memory is released
    when the copy is done and the forward's own references are gone
    (``hostmem.engine``'s module doc says why not at the release op).
  * **Release and prefetch by op index.**  The op index is the one the
    profile numbers ops with: the executor hooks into the counting
    dispatch mode that records the step (the Lightweight recorder of
    ``core.tokenizer`` or the profiler's Detailed mode,
    ``tokenizer.CountingMode``) and pushes a bare counting mode only when
    none is active.  Before op ``i`` runs it drives
    ``engine.advance_op(i)`` at the release plan's ops and issues the
    H2D of every staged storage whose swap-in op is ``i``: an entry's
    ``swap_in_op``; for a tensor of an offloaded site that is not an entry
    (a site is offloaded whole once half its tensors are entries), the
    start of the logical layer before the one holding its
    death (its last use in the backward) — where the simulator places a
    swap it could not hide (``Simulator.place_stalled``), so it is back
    one logical layer before it is needed.  A storage whose swap-in op
    comes before it is saved (the last layers', needed right after the
    peak) goes back as soon as it is staged.  On a card, one that is not
    an entry stays on the device instead (``kept``): it would come back at
    once, so staging it frees nothing, while its H2D waits behind every
    D2H queued before it and its copies take link time the simulator never
    planned (the policy's projected stall counts its entries).  On the
    CPU it is staged, as the reference moves every tensor of an offloaded
    site.
  * **Unpack.**  The current stream waits on the H2D's done event
    (``engine.fence``) before the restored bytes are used: the H2D fills
    on the class's stream.  A staged storage whose H2D was not issued by
    then (no profile, or an op index that never came) is fetched on
    demand; such fetches are counted, and so is the host time the
    executor spends waiting on copies (``stats``).
  * **The measured copy stall.**  Each fence records a timing event on the
    current stream just before its wait; once the dispatch has synchronised,
    ``need.elapsed_time(done)`` (0 when the copy was done first) is how long
    the stream waited for that copy, on the device. ``settle`` reads them
    into ``last`` after the run (no host sync is added to the step: a
    completed event's ``synchronize`` returns at once): ``stall_entries``
    holds (tag, bytes, ms) per fence, with the copy's own ms and its lead
    (how long before the need it began) where the copy was timed, and
    ``copy_stall_s`` sums the fences' waits with the host's time issuing
    on-demand swap-ins and waiting for the forced retires of the class
    window.  Two costs that are no copy stall stand beside it:
    ``recompute_s``, the remat recipes' time (CUDA events around each on a
    card, the host clock on the CPU), and ``hook_s``, the host time inside
    the execution's hooks (its host waits and, on the CPU, its
    recomputation included), of which ``release_s`` released swap-outs at
    the release plan's ops, ``prefetch_s`` issued the planned swap-ins and
    ``pack_s`` staged the swap-outs (the rest is the unpack hooks).
    ``host_waits`` / ``host_wait_s`` count the retires inside the dispatch
    that blocked the host on a copy not yet done (on a card; expected 0),
    ``released_late`` the swap-outs not retired at their release op (still
    copying, or queued behind one that is), and
    ``settle_s`` the host time of the books after the step (below).  On
    the CPU, where every copy is synchronous, the copy stall is 0.  While
    ``torch.profiler`` records, the hooks are ranges of its trace:
    ``exec.pack``, ``exec.unpack`` and ``exec.on_op`` (the release ops
    and the swap-ins' issue; ``obs.profiler_range``).
  * **Remat** (``applied.remat``).  A site whose ``tag`` carries a
    recompute recipe (``ffn_act``: ``silu(gate) * up``) is not held
    across the forward: the pack hook keeps the recipe, with its inputs
    packed through the same hooks (so an offloaded ``gate`` stays
    offloaded), and the unpack hook reruns it — the same ops on the same
    bytes, so the result is bit for bit the saved tensor.  PyTorch's
    selective activation checkpointing would hold the region's inputs on
    the device in its recompute closure, which defeats offloading them.
    In eager, ``ln_in`` and ``ssm_gate`` have no storage of their own
    (``ln_in`` is the previous block's ``resid_post``, ``ssm_gate`` a view
    of ``ssm_in``), so they keep nothing to drop.  An entry of a remat
    site is recomputed, not moved: neither holds it across the forward.

The executor's own work — the copies, the byte views, the H2D
allocations and the recomputation — runs with the dispatch modes off, so
the op stream the recorder and the profiler see under any applied policy
is the baseline's, op for op: a policy never shows up as a sequence
change.

``baseline()`` is plain autograd, with no hooks.  ``raw()`` is the same
in eager: without a checkpoint wrapper autograd saves everything either
way.

Class window: the engine force-retires a ``policy_swap`` copy (a host
wait on its event) once more than ``depth`` are queued.  The execution
widens the class's depth to the copies in flight before each submit, so
the forward never waits on a D2H for window room (``forced_retires``
stays 0).  On the CPU copies retire at their release ops, at the H2D
that needs them, or when the step ends, as the reference's do.  On a card
nothing inside the dispatch waits on the host for a copy, as the
reference's compiled step never does: a release op retires only copies
already done, and a swap-in is chained after its swap-out on the device.
The class is
drained, and the ledger, trace, counters and health books closed, by
``Execution.settle`` after the step has synchronised (the trainer calls it
after its finiteness check); an execution on the engine that begins first
settles it.

A copy that fails for good raises out of the step unless the engine's
resilience retains it (``ResilienceConfig.enabled``): then the source
stays on the device, the swap-in reads it back bit-exact, and link health
drives the degradation ladder (``faults.ladder``).
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

import torch
from torch.utils._python_dispatch import (_disable_current_modes,
                                          _get_current_dispatch_mode_stack)

from repro_torch import obs
from repro_torch.common.config import ChameleonConfig
from repro_torch.core import sites
from repro_torch.core.memtrace import build_timeline
from repro_torch.core.policy import SwapPolicy
from repro_torch.core.profiler import MIN_TRACK_BYTES, ProfileData
from repro_torch.core.sites import OFFLOAD_SITES, base_site
from repro_torch.core.tokenizer import HOOK_NEVER, CountingMode, not_an_op

# Sites that are cheap to recompute from their saved neighbors (elementwise):
# the beyond-paper 3-way save/offload/remat decision drops these from the
# saved set when host bandwidth is the binding constraint.
CHEAP_RECOMPUTE_SITES: Set[str] = {"ffn_act", "ssm_gate", "ln_in"}

TC_POLICY_SWAP = "policy_swap"     # the engine's traffic class for swaps


@dataclass
class AppliedPolicy:
    swap: Optional[SwapPolicy]
    offload: Set[str]
    save: Set[str]
    remat: Set[str]
    fingerprint: str
    raw: bool = False    # save *everything* incl. untagged f32 temporaries
    # §5.4.2 feedback: tag -> simulator-promised swap-out completion op.
    # The execution hands this to the transfer engine so HBM is freed
    # at the promised op (engine.advance_op) instead of at first reuse.
    release_plan: Dict[str, int] = field(default_factory=dict)

    @property
    def plain(self) -> bool:
        """Nothing to offload or recompute: plain autograd runs it."""
        return (not self.offload and not self.remat
                and not (self.swap is not None and self.swap.entries))


class Executor:
    def __init__(self, cfg: ChameleonConfig):
        self.cfg = cfg

    def site_universe(self, prof: Optional[ProfileData]) -> Set[str]:
        if prof is None:
            return set(OFFLOAD_SITES)
        sites_ = {t.site for t in prof.candidates if t.site}
        return sites_ or set(OFFLOAD_SITES)

    def lower(self, swap: SwapPolicy, prof: ProfileData,
              remat_fallback: Optional[bool] = None) -> AppliedPolicy:
        """SwapPolicy (per-tensor decisions) -> site-level applied policy."""
        offload = swap.offload_sites(prof)
        universe = self.site_universe(prof)
        save = universe - offload
        remat: Set[str] = set()
        use_remat = (self.cfg.allow_remat_fallback
                     if remat_fallback is None else remat_fallback)
        if use_remat:
            remat = (save & CHEAP_RECOMPUTE_SITES)
            save -= remat
        fp = ("off=" + ",".join(sorted(offload))
              + "|save=" + ",".join(sorted(save)))
        plan = {SwapPolicy.entry_tag(e): e.swap_out_done_op
                for e in swap.entries if e.swap_out_done_op >= 0}
        return AppliedPolicy(swap, offload, save, remat, fp,
                             release_plan=plan)

    def bind_release_points(self, applied: AppliedPolicy, engine) -> int:
        """Hand the applied policy's release plan to the transfer engine
        (superseding any previous policy's): swap-outs tagged with a
        planned tensor carry ``release_op`` and are retired by
        ``engine.advance_op`` at the simulator-promised op."""
        engine.clear_planned_releases()
        for tag, op in applied.release_plan.items():
            engine.plan_release(tag, op)
        return len(applied.release_plan)

    def conservative(self, prof: Optional[ProfileData] = None) -> AppliedPolicy:
        """WarmUp-stage fallback: offload every candidate site (guaranteed
        fit analogue of passive swap; see core.oom for the targeted loop)."""
        universe = self.site_universe(prof)
        return AppliedPolicy(None, set(universe), set(), set(),
                             "warmup-offload-all")

    def baseline(self) -> AppliedPolicy:
        """PyTorch-equivalent no-swap baseline: every named activation site
        is saved in its stored dtype — plain autograd.  This is the program
        the profiler replays and the memory curve the MRL is built from
        (Fig 3)."""
        return AppliedPolicy(None, set(), set(OFFLOAD_SITES), set(),
                             "baseline-save-sites")

    def raw(self) -> AppliedPolicy:
        """Save-everything: in eager the same program as the baseline
        (autograd saves everything either way); kept for the reference's
        surface."""
        return AppliedPolicy(None, set(), set(OFFLOAD_SITES), set(),
                             "raw-save-everything", raw=True)

    def execution(self, applied: AppliedPolicy, engine=None,
                  profile: Optional[ProfileData] = None
                  ) -> Optional["Execution"]:
        """The context a step runs ``applied`` under: None for a plain
        policy (baseline, raw), else an :class:`Execution` planned from
        ``profile`` (the baseline profile of the same grad dispatch; None
        leaves every H2D to the unpack, on demand).  Offloading needs the
        host tier's transfer ``engine``."""
        if applied.plain:
            return None
        if engine is None and (applied.offload or applied.swap is not None):
            raise ValueError(
                f"policy {applied.fingerprint!r} offloads "
                f"{sorted(applied.offload)} (and its swap entries) but no "
                "transfer engine was given (ChameleonConfig.hostmem.enabled "
                "is off)")
        return Execution(applied, engine, profile, self.cfg)


# ------------------------------------------------------------- the plan
def _stream_event():
    """A timing event recorded on the current CUDA stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):   # sparse and the like
        return None


def _prefetch_ops(prof: ProfileData, cfg: ChameleonConfig,
                  offload: Set[str], swap: Optional[SwapPolicy]
                  ) -> Tuple[Dict[Tuple[str, int, int], int],
                             Dict[int, int], Dict[int, str]]:
    """From the profile: (site, layer, tag order) -> instance uid, and for
    every instance of an offloaded site and every policy entry its swap-in
    op and swap-out tag.  Non-entries come back at the start of the
    logical layer before the one holding their death (the simulator's
    layers: ``Simulator``)."""
    from repro_torch.core.simulator import Simulator
    uid_of: Dict[Tuple[str, int, int], int] = {}
    groups: Dict[Tuple[str, int], List] = {}
    for t in prof.candidates:
        groups.setdefault((t.site, t.layer), []).append(t)
    for (site, layer), ts in groups.items():
        ts.sort(key=lambda t: (t.tag_seq if t.tag_seq >= 0 else 1 << 40,
                               t.birth, t.uid))
        for k, t in enumerate(ts):
            uid_of[(site, layer, k)] = t.uid
    entries = {e.uid: e for e in (swap.entries if swap is not None else ())}
    tl = build_timeline(prof)
    sim = Simulator(prof, tl.peak_op, cfg)
    swap_in: Dict[int, int] = {}
    tags: Dict[int, str] = {}
    for t in prof.candidates:
        e = entries.get(t.uid)
        if e is None and t.site not in offload:
            continue
        if e is not None:
            swap_in[t.uid] = int(e.swap_in_op)
            tags[t.uid] = SwapPolicy.entry_tag(e)
        else:
            li = max(sim.layer_of(t.death) - 1, 0)
            op = sim.layers[li].start_op if sim.layers else 0
            # never before the tensor exists
            swap_in[t.uid] = max(int(op), int(t.birth))
            tags[t.uid] = f"{t.site}:{t.layer}:{t.uid}"
    return uid_of, swap_in, tags


@dataclass
class _Label:
    site: str
    layer: int
    seq: int
    uid: int                        # profile instance, -1 when unknown
    recompute: Optional[Tuple[Callable, tuple]]
    ref: weakref.ref                # the storage, weakly


class _Staged:
    """One storage staged out: its D2H, then its H2D and the restored
    bytes while handles to it remain unpacked."""

    __slots__ = ("out", "into", "nbytes", "refs", "dev", "tag")

    def __init__(self, out, nbytes: int, tag: str):
        self.out = out                 # swap-out TransferEvent
        self.into = None               # swap-in TransferEvent
        self.nbytes = nbytes
        self.refs = 0                  # handles not yet unpacked
        self.dev = None                # restored uint8 device tensor
        self.tag = tag


class _Offloaded:
    """What autograd holds for a saved view of a staged storage."""

    __slots__ = ("staged", "dtype", "size", "stride", "offset")

    def __init__(self, staged: _Staged, t: torch.Tensor):
        self.staged = staged
        self.dtype = t.dtype
        self.size = tuple(t.size())
        self.stride = tuple(t.stride())
        self.offset = t.storage_offset()


class _Recompute:
    """What autograd holds for a saved view of a rematerialized tensor."""

    __slots__ = ("fn", "args", "size", "stride", "offset")

    def __init__(self, fn, args, t: torch.Tensor):
        self.fn = fn
        self.args = args               # packed: handles or tensors
        self.size = tuple(t.size())
        self.stride = tuple(t.stride())
        self.offset = t.storage_offset()


class _OpCounter(CountingMode):
    """The bare counting mode an execution pushes when nothing records."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def count(self) -> int:
        return self.n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not_an_op(func):
            return func(*args, **(kwargs or {}))
        n = self.n
        self.n = n + 1
        if n >= self.hook_at:
            self.hook(n)
        return func(*args, **(kwargs or {}))


class Execution:
    """An applied policy planned for one grad dispatch; ``run()`` is the
    context the dispatch runs under, and ``last`` holds its last run's
    counters."""

    def __init__(self, applied: AppliedPolicy, engine,
                 profile: Optional[ProfileData], cfg: ChameleonConfig):
        self.applied = applied
        self.engine = engine
        self.offload = frozenset(applied.offload)
        self.remat = frozenset(applied.remat)
        self.entries = frozenset(
            e.uid for e in (applied.swap.entries if applied.swap else ()))
        self._uid_of: Dict[Tuple[str, int, int], int] = {}
        self._in_op: Dict[int, int] = {}
        self._tags: Dict[int, str] = {}
        if profile is not None and (self.offload or self.entries):
            self._uid_of, self._in_op, self._tags = _prefetch_ops(
                profile, cfg, set(self.offload), applied.swap)
        self._lock = threading.RLock()
        self._last: dict = self._zero()
        self._fences: List[tuple] = []       # (ev, need, done)
        self._recomputes: List[tuple] = []   # (start, end) CUDA events
        self._all: List[_Staged] = []
        self._active = False
        self._card = False                   # the last run's engine is
        self._unsettled = False              # ... on a card; books open

    @staticmethod
    def _zero() -> dict:
        return {"staged": 0, "staged_bytes": 0, "restored": 0,
                "restored_bytes": 0, "prefetched": 0, "on_demand": 0,
                "recomputed": 0, "views": 0, "never_restored": 0,
                "wait_s": 0.0, "forced_retires": 0,
                # the measured copy stall (module doc) and what it sums
                "copy_stall_s": 0.0, "fence_stall_s": 0.0,
                "on_demand_s": 0.0, "forced_wait_s": 0.0,
                "stall_entries": [],
                # costs beside it that are no copy stall, and three parts
                # of hook_s: the release ops, the swap-ins' issue, the pack
                # hooks (staging the swap-outs)
                "recompute_s": 0.0, "hook_s": 0.0, "release_s": 0.0,
                "prefetch_s": 0.0, "pack_s": 0.0,
                # the host's waits on copies inside the dispatch, the
                # release ops that found their copy running, the books
                "host_waits": 0, "host_wait_s": 0.0, "released_late": 0,
                "settle_s": 0.0,
                # storages of offloaded sites left on the device (module
                # doc: their swap-in op came before they were saved)
                "kept": 0, "kept_bytes": 0}

    @property
    def last(self) -> dict:
        """The counters of the last run.  On a card they are whole once
        :meth:`settle` has run."""
        return self._last

    def settle(self) -> None:
        """Close the last run's books, once the step has synchronised.  On
        a card: retire its copies (each done-event has completed, so
        ``synchronize`` returns at once), then read its timing events into
        ``last``.  On the CPU the run closed them itself; a second call,
        or a call while the run is active, does nothing."""
        if self._active or not self._unsettled:
            return
        self._unsettled = False
        eng = self.engine
        if eng is not None and eng.open_execution is self:
            eng.open_execution = None
        st = self._last
        if self._card:
            t0 = time.perf_counter()
            with self._lock, _disable_current_modes():
                self.engine.drain_class(TC_POLICY_SWAP)
                self._free_never_restored()
            st["settle_s"] = time.perf_counter() - t0
        fences, self._fences = self._fences, []
        for ev, need, done in fences:
            need.synchronize()
            done.synchronize()
            ms = max(0.0, float(need.elapsed_time(done)))
            row = [ev.tag, ev.nbytes, ms]
            if ev._cuda is not None:
                # the copy's own time, and how long before the stream
                # needed it the copy began (less than its time: a stall)
                start = ev._cuda[0]
                row += [float(start.elapsed_time(done)),
                        float(start.elapsed_time(need))]
            st["stall_entries"].append(tuple(row))
            st["fence_stall_s"] += ms / 1e3
        recs, self._recomputes = self._recomputes, []
        for start, end in recs:
            end.synchronize()
            st["recompute_s"] += float(start.elapsed_time(end)) / 1e3
        st["copy_stall_s"] = (st["fence_stall_s"] + st["on_demand_s"]
                              + st["forced_wait_s"])

    def _free_never_restored(self) -> None:
        """Return the slabs of storages staged and never needed back (the
        class is drained: their copies are done)."""
        for s in self._all:
            if s.into is None and not s.out.failed:
                if s.out.block is not None and not s.out.block.freed:
                    self.engine.pool.free(s.out.block)
                self._last["never_restored"] += 1
        self._all = []

    # ------------------------------------------------------------ running
    @contextlib.contextmanager
    def run(self):
        """Label, pack, release and prefetch while the dispatch runs; drain
        the ``policy_swap`` copies at the end (on a card, in
        :meth:`settle`)."""
        self._begin()
        try:
            with sites.executing(self), \
                    torch.autograd.graph.saved_tensors_hooks(
                        self._pack_hook, self._unpack_hook), \
                    (self._own_mode or contextlib.nullcontext()):
                yield self
        finally:
            self._end()

    def _begin(self) -> None:
        if self._active:
            raise RuntimeError("this execution is already running a step")
        eng = self.engine
        if eng is not None and eng.open_execution is not None:
            # an unsettled run (this one's or another's) closes its books
            # before this run's copies share the class
            eng.open_execution.settle()
        self._active = True
        self._labels: Dict[int, _Label] = {}
        self._seq: Dict[Tuple[str, int], int] = {}
        self._staged: Dict[int, _Staged] = {}        # storage -> staged
        self._by_uid: Dict[int, _Staged] = {}
        self._due: Set[int] = set()
        self._kept: Set[int] = set()                 # storages kept
        self._all: List[_Staged] = []
        # (op, uid) swap-ins in op order, and the release ops
        self._pf = sorted((op, uid) for uid, op in self._in_op.items())
        self._release_ops = sorted(set(self.applied.release_plan.values()))
        self._pf_i = 0
        self._rel_i = 0
        self._last = self._zero()
        self._fences, self._recomputes = [], []
        # on a card: record timing events and keep the host off the copies
        # (the CPU's copies never wait)
        self._card = eng is not None and eng.device.type == "cuda"
        if eng is not None:
            eng.begin_iteration()
            self._cc0 = self._class_counters()
        # the counting mode that numbers this dispatch's ops
        modes = [m for m in _get_current_dispatch_mode_stack()
                 if isinstance(m, CountingMode)]
        self._own_mode = None
        if modes:
            self._mode = modes[-1]
        else:
            self._mode = self._own_mode = _OpCounter()
        self._saved_hook = (self._mode.hook, self._mode.hook_at)
        self._base = self._mode.count()
        self._mode.hook = self._on_op
        self._arm()

    def _class_counters(self) -> tuple:
        cc = self.engine.by_class[TC_POLICY_SWAP]
        return (cc.forced_retires, cc.forced_wait_s, cc.host_waits,
                cc.host_wait_s, cc.released_late)

    def _end(self) -> None:
        mode = self._mode
        mode.hook, mode.hook_at = self._saved_hook
        for s in self._all:
            s.dev = None
        eng = self.engine
        if eng is not None:
            st = self._last
            if not self._card:               # a card's books wait (above)
                t0 = time.perf_counter()
                with self._lock, _disable_current_modes():
                    eng.drain_class(TC_POLICY_SWAP)
                    self._free_never_restored()
                st["wait_s"] += time.perf_counter() - t0
            got = [a - b for a, b in zip(self._class_counters(), self._cc0)]
            st["forced_retires"] = got[0]
            if self._card:
                (st["forced_wait_s"], st["host_waits"], st["host_wait_s"],
                 st["released_late"]) = got[1:]
            st["copy_stall_s"] = st["on_demand_s"] + st["forced_wait_s"]
        self._labels.clear()
        self._staged.clear()
        self._by_uid.clear()
        self._due.clear()
        self._kept.clear()
        self._active = False
        self._unsettled = True
        if eng is not None and self._card:
            eng.open_execution = self
        else:
            self.settle()

    # --------------------------------------------------------- op index
    def _arm(self) -> None:
        nxt = HOOK_NEVER
        if self._rel_i < len(self._release_ops):
            nxt = self._release_ops[self._rel_i]
        if self._pf_i < len(self._pf):
            nxt = min(nxt, self._pf[self._pf_i][0])
        self._mode.hook_at = (self._base + nxt if nxt < HOOK_NEVER
                              else HOOK_NEVER)

    def _on_op(self, n: int) -> None:
        """Runs before op ``n`` (the mode's count): releases and swap-ins
        whose op has come."""
        i = n - self._base
        t0 = time.perf_counter()
        st = self._last
        with obs.profiler_range("exec.on_op"), self._lock, \
                _disable_current_modes():
            rel = self._release_ops
            if self._rel_i < len(rel) and rel[self._rel_i] <= i:
                while self._rel_i < len(rel) and rel[self._rel_i] <= i:
                    self._rel_i += 1
                self.engine.advance_op(i)
                st["release_s"] += time.perf_counter() - t0
            t1 = time.perf_counter()
            pf = self._pf
            while self._pf_i < len(pf) and pf[self._pf_i][0] <= i:
                uid = pf[self._pf_i][1]
                s = self._by_uid.get(uid)
                self._pf_i += 1
                if s is None:
                    self._due.add(uid)   # not staged yet (module doc)
                elif s.into is None:
                    self._swap_in(s)
                    st["prefetched"] += 1
            self._arm()
        t2 = time.perf_counter()
        st["prefetch_s"] += t2 - t1
        st["wait_s"] += t2 - t0
        st["hook_s"] += t2 - t0

    # ------------------------------------------------------------ labels
    def note_site(self, x, name: str, layer: int, recompute) -> None:
        if not isinstance(x, torch.Tensor):
            return
        st = _storage(x)
        if st is None:
            return
        key = st._cdata
        if key in self._labels or st.nbytes() < MIN_TRACK_BYTES:
            return
        site = base_site(name)
        k = self._seq.get((site, layer), 0)
        self._seq[(site, layer)] = k + 1
        self._labels[key] = _Label(
            site, layer, k, self._uid_of.get((site, layer, k), -1),
            recompute if site in self.remat else None,
            weakref.ref(st, functools.partial(self._freed, key)))

    def _freed(self, key: int, _ref) -> None:
        """A labelled storage was freed: its address may be reused."""
        self._labels.pop(key, None)
        self._staged.pop(key, None)
        self._kept.discard(key)

    # ------------------------------------------------------ pack / unpack
    def _pack_hook(self, t: torch.Tensor):
        t0 = time.perf_counter()
        with obs.profiler_range("exec.pack"):
            out = self._pack(t)
        dt = time.perf_counter() - t0
        self._last["hook_s"] += dt
        self._last["pack_s"] += dt
        return out

    def _unpack_hook(self, h):
        t0 = time.perf_counter()
        with obs.profiler_range("exec.unpack"):
            out = self._unpack(h)
        self._last["hook_s"] += time.perf_counter() - t0
        return out

    def _pack(self, t: torch.Tensor):
        st = _storage(t)
        if st is None:
            return t
        lab = self._labels.get(st._cdata)
        if lab is None:
            return t
        if lab.site in self.offload:
            if (self._card and lab.uid in self._due
                    and lab.uid not in self.entries):
                return self._keep(t, st)
            return self._offload(t, st, lab)
        if lab.recompute is not None:
            fn, args = lab.recompute
            lab.recompute = None       # the recipe's inputs go in handles
            packed = tuple(self._pack(a) for a in args)
            lab.recompute = (fn, packed)
            return _Recompute(fn, packed, t)
        if lab.uid in self.entries:
            return self._offload(t, st, lab)
        return t

    def _keep(self, t: torch.Tensor, st) -> torch.Tensor:
        if st._cdata not in self._kept:
            self._kept.add(st._cdata)
            self._last["kept"] += 1
            self._last["kept_bytes"] += st.nbytes()
        return t

    def _offload(self, t: torch.Tensor, st, lab: _Label) -> _Offloaded:
        with self._lock, _disable_current_modes():
            s = self._stage(t, st, lab)
            s.refs += 1
            self._last["views"] += 1
        return _Offloaded(s, t)

    def _stage(self, t: torch.Tensor, st, lab: _Label) -> _Staged:
        key = st._cdata
        s = self._staged.get(key)
        if s is not None:
            return s
        eng = self.engine
        nb = st.nbytes()
        tag = self._tags.get(lab.uid, f"{lab.site}:{lab.layer}:?{lab.seq}")
        src = torch.empty((0,), dtype=torch.uint8, device=t.device)
        src.set_(st, 0, (nb,), (1,))
        # keep retires off the forward: room in the window for this copy
        eng.set_class_depth(TC_POLICY_SWAP,
                            eng.class_in_flight(TC_POLICY_SWAP) + 2)
        ev = eng.submit_swap_out(src, tag)
        del src
        s = _Staged(ev, nb, tag)
        self._staged[key] = s
        self._all.append(s)
        self._last["staged"] += 1
        self._last["staged_bytes"] += nb
        if lab.uid >= 0:
            self._by_uid[lab.uid] = s
            if lab.uid in self._due:
                # its swap-in op came before it was saved (module doc)
                self._swap_in(s)
                self._last["prefetched"] += 1
        return s

    def _swap_in(self, s: _Staged) -> None:
        eng = self.engine
        eng.set_class_depth(TC_POLICY_SWAP,
                            eng.class_in_flight(TC_POLICY_SWAP) + 2)
        s.into = eng.submit_swap_in(s.out, s.tag)
        self._last["restored"] += 1
        self._last["restored_bytes"] += s.nbytes

    def _restore(self, s: _Staged) -> torch.Tensor:
        with self._lock, _disable_current_modes():
            if s.dev is None:
                if s.into is None:
                    t0 = time.perf_counter()
                    self._swap_in(s)
                    self._last["on_demand"] += 1
                    dt = time.perf_counter() - t0
                    self._last["wait_s"] += dt
                    if self._card:
                        self._last["on_demand_s"] += dt
                pair = self.engine.fence(s.into, timed=self._card)
                if pair is not None:
                    self._fences.append((s.into,) + pair)
                # the event lets go of the restored bytes: the current
                # stream is ordered after the H2D now, so their memory may
                # be reused as soon as the backward is done with them
                s.dev, s.into.result = s.into.result, None
            dev = s.dev
            s.refs -= 1
            if s.refs <= 0:
                s.dev = None           # autograd holds what it unpacked
        return dev

    def _unpack(self, h):
        if isinstance(h, _Offloaded):
            dev = self._restore(h.staged)
            with _disable_current_modes():
                return dev.view(h.dtype).as_strided(h.size, h.stride,
                                                    h.offset)
        if isinstance(h, _Recompute):
            args = [self._unpack(a) for a in h.args]
            with torch.no_grad(), _disable_current_modes():
                if args and args[0].is_cuda:
                    start = _stream_event()
                    out = h.fn(*args)
                    self._recomputes.append((start, _stream_event()))
                else:
                    t0 = time.perf_counter()
                    out = h.fn(*args)
                    self._last["recompute_s"] += time.perf_counter() - t0
                self._last["recomputed"] += 1
                return out.as_strided(h.size, h.stride, h.offset)
        return h
