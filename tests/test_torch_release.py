"""The policy's copies take no host wait inside the grad dispatch (ROADMAP
P4): on a card a release op retires only copies already done, a swap-in
of an unretired swap-out is chained on the device, and the books close
after the step (``hostmem.engine``'s and ``core.executor``'s module
docs).

No card is here.  The card-side cases run an engine on the CPU whose
device is set to ``cuda``, with fake CUDA events and streams in the
pattern of ``tests/test_torch_contention.py``: an event completes only
when the test says so (``_Card.sync`` is the trainer's synchronisation),
and a ``synchronize()`` on one not yet complete is a host wait, recorded.
They never reach a CUDA call.  On the CPU, where every copy is
synchronous, the engine under a policy step's own calls retires as the
reference's does, note for note.
"""
import contextlib
from collections import Counter

import numpy as np
import pytest
import torch

import repro.hostmem as RH
from repro import obs as robs
from repro_torch import obs
from repro_torch.common.config import ChameleonConfig
from repro_torch.core import executor as pexec
from repro_torch.core import sites
from repro_torch.hostmem import engine as E
import repro_torch.configs as PC
from repro_torch.common.config import TrainConfig
from repro_torch.core.profiler import profile_step
from repro_torch.distributed import steps as S
from repro_torch.models import transformer as T
from tests.test_torch_executor import _bit_equal, _engine, _lowered, _run

torch.set_num_threads(1)

P = E.TC_POLICY_SWAP
KIB = 1 << 10


@pytest.fixture(scope="module")
def step():
    """The executor tests' step (reduced llama2-paper, one batch from a
    numpy seed, the baseline's loss and gradients, the detailed profile),
    profiled with a static base of the step's own tensors: the profiler's
    CPU default counts every live tensor of the process, which grows with
    what ran before in it, and moves the policies' budgets."""
    cfg = PC.get_reduced("llama2_paper")
    model = T.init_model(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    tok = torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 64)))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    grad = S.make_grad_step(cfg, TrainConfig())
    loss, grads, _ = grad(model, batch, 1.0)
    own = [*model.parameters(), *model.buffers(), *batch.values(), loss,
           *grads.values()]
    static = sum({t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                  for t in own}.values())
    prof = profile_step(lambda: grad(model, batch, 1.0), device="cpu",
                        static_bytes=static)
    return dict(cfg=cfg, model=model, batch=batch, loss=loss, grads=grads,
                prof=prof)


# ------------------------------------------------------ the fake card
class _Stream:
    def __init__(self, name):
        self.name, self.log = name, []

    def wait_event(self, ev):
        self.log.append(("wait", ev))


class _Event:
    def __init__(self, card):
        card.events.append(self)
        self.card, self.done, self.t = card, False, float(len(card.events))

    def record(self, stream=None):
        (stream or self.card.current).log.append(("record", self))

    def query(self):
        return self.done

    def synchronize(self):
        if not self.done:                # the host would block here
            self.card.host_waits.append(self)
        self.done = True

    def elapsed_time(self, other):
        return other.t - self.t


class _Card:
    """The events and streams of one fake card."""

    def __init__(self):
        self.events, self.host_waits = [], []
        self.current = _Stream("current")
        self.streams = {}

    def sync(self):
        for ev in self.events:
            ev.done = True


def _card_engine(monkeypatch, eng=None):
    """An engine on the CPU that takes the card's paths: its CUDA events,
    streams and H2D allocation are fakes; copies run on the CPU at once."""
    card = _Card()
    eng = eng if eng is not None else _engine()
    eng.device = torch.device("cuda")

    def stream(cls, kind):
        return card.streams.setdefault((cls, kind), _Stream(f"{cls}/{kind}"))

    def record_current(timing=False):
        ev = _Event(card)
        ev.record(card.current)
        return ev

    def h2d(ev, host):                   # _h2d's order, a CPU result
        st = stream(ev.cls, E.SWAP_IN)
        st.wait_event(record_current())
        start, done = _Event(card), _Event(card)
        start.record(st)
        done.record(st)
        ev._cuda = (start, done)
        return host.clone()

    eng._stream, eng._current_stream = stream, lambda: card.current
    eng._record_current, eng._h2d = record_current, h2d
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda enable_timing=False: _Event(card))
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    return eng, card


def _notes(monkeypatch, ledger):
    """Record every transfer note ``ledger`` takes: (dir, class, tag,
    bytes, release_op, failed)."""
    got, note = [], ledger.note_transfer

    def rec(kind, cls, tag, nbytes, **kw):
        got.append((kind, cls, tag, nbytes, kw.get("release_op", -1),
                    kw.get("failed", False)))
        return note(kind, cls, tag, nbytes, **kw)
    monkeypatch.setattr(ledger, "note_transfer", rec)
    return got


def _payload(i, n=4 * KIB):
    return torch.full((n,), i, dtype=torch.uint8)


# ------------------------------------------------- the engine on a card
def test_release_op_retires_only_done_copies_in_fifo_order(monkeypatch):
    eng, card = _card_engine(monkeypatch)
    notes = _notes(monkeypatch, obs.ledger())
    eng.set_class_depth(P, 8)            # as the executor widens it
    for i, tag in enumerate("abc"):
        eng.plan_release(tag, 2 * i + 2)
    src = {t: _payload(i) for i, t in enumerate("abc")}
    ev = {t: eng.submit_swap_out(src[t], t) for t in "abc"}
    # every source was dropped at issue (the allocator holds it for the
    # copy's stream)
    assert all(e._source is None and not e.done for e in ev.values())
    # a's copy is running at its op: it stays queued, with no wait on the
    # host or on the device
    assert eng.advance_op(2) == 1
    a, b, c = ev["a"], ev["b"], ev["c"]
    assert not a.done and eng.class_in_flight(P) == 3
    assert ("wait", a._cuda[1]) not in card.current.log
    # b's copy is done but queued behind a's (FIFO)
    b._cuda[1].done = True
    assert eng.advance_op(4) == 1 and not b.done
    # a done: the next op retires a, then b, in submission order
    a._cuda[1].done = True
    assert eng.advance_op(5) == 0
    assert a.done and b.done and not c.done
    # c done at its op retires there
    c._cuda[1].done = True
    assert eng.advance_op(6) == 1 and c.done
    cc = eng.by_class[P]
    assert (cc.released_at_op, cc.released_late) == (3, 2)
    assert card.host_waits == [] and cc.host_waits == 0
    assert not [x for x in card.current.log if x[0] == "wait"]
    assert [n[2] for n in notes] == ["a", "b", "c"]
    assert [n[4] for n in notes] == [2, 4, 6]
    for t in "abc":
        assert torch.equal(ev[t].block.typed(), src[t])


def test_swap_in_of_an_unretired_swap_out_is_chained_on_the_device(
        monkeypatch):
    eng, card = _card_engine(monkeypatch)
    eng.set_class_depth(P, 8)
    src = _payload(7)
    out = eng.submit_swap_out(src, "x")
    into = eng.submit_swap_in(out, "x")
    h2d = card.streams[(P, E.SWAP_IN)].log
    # the H2D stream waits on the D2H's done event before its copy starts
    assert h2d.index(("wait", out._cuda[1])) < h2d.index(
        ("record", into._cuda[0]))
    assert not out.done and not into.done and card.host_waits == []
    assert torch.equal(into.result, src)
    assert eng.pool.bytes_in_use == src.numel()
    card.sync()
    eng.drain_class(P)
    assert out.done and into.done and eng.pool.bytes_in_use == 0
    assert card.host_waits == [] and eng.by_class[P].host_waits == 0


def test_waiting_on_a_chained_swap_in_retires_its_swap_out_first(
        monkeypatch):
    """The KV spill's restore waits on its swap-in: the books still see
    the bytes leave before they come back."""
    eng, card = _card_engine(monkeypatch)
    notes = _notes(monkeypatch, obs.ledger())
    eng.set_class_depth(P, 8)
    first = eng.submit_swap_out(_payload(1), "first")
    out = eng.submit_swap_out(_payload(2), "x")
    into = eng.submit_swap_in(out, "x")
    card.sync()
    eng.wait(into)
    assert first.done and out.done and into.done
    assert [(n[0], n[2]) for n in notes] == [("out", "first"), ("out", "x"),
                                             ("in", "x")]
    # only the first's slab is held: it was never swapped back
    assert eng.class_in_flight(P) == 0
    assert eng.pool.bytes_in_use == first.nbytes


def test_a_retire_before_the_copy_is_done_counts_a_host_wait(monkeypatch):
    """What the executor keeps out of the dispatch: the class window's
    forced retire blocks the host on a copy still running."""
    eng, card = _card_engine(monkeypatch)
    for i in range(3):                   # depth 2: the third forces one
        eng.submit_swap_out(_payload(i), f"t{i}")
    cc = eng.by_class[P]
    assert cc.forced_retires == cc.host_waits == len(card.host_waits) == 1


# ------------------------------------------- the executor on a card
POLICIES = ("conservative", "lowered")


def _policy(step, which, eng):
    x = pexec.Executor(ChameleonConfig())
    ap = (x.conservative(step["prof"]) if which == "conservative"
          else _lowered(step, 0.9))
    x.bind_release_points(ap, eng)
    return ap, x.execution(ap, eng, step["prof"])


COUNTERS = ("n_out", "n_in", "bytes_out", "bytes_in", "released_at_op",
            "forced_retires", "failures", "retries")


def _at_once(calls) -> set:
    """Tags of the storages swapped back in as soon as they were staged:
    the swap-in issued right after its own swap-out, with no release op
    and no other copy between them."""
    seq = [c for c in calls if c[0] in ("submit_swap_out", "submit_swap_in",
                                        "advance_op")]
    return {a[1] for (n0, _, o0), (n1, a, _) in zip(seq, seq[1:])
            if n0 == "submit_swap_out" and n1 == "submit_swap_in"
            and a[0] is o0}


@pytest.mark.parametrize("which", POLICIES)
def test_settled_books_equal_the_host_retires(step, which, monkeypatch):
    """The same policy step with the CPU engine (copies retired on the
    host inside the dispatch) and on the fake card (nothing retired
    before the step's synchronisation): bit-equal losses and gradients and
    no host wait inside the dispatch.  Once settled after the sync, the
    card's counters and ledger notes (bytes and release op) equal those
    its own submissions give with the CPU engine's host retires, and they
    differ from the CPU step's only by the storages the card kept: those
    the CPU step staged and swapped back in at once, none an entry."""
    notes = _notes(monkeypatch, obs.ledger())
    host = _engine()
    host_calls = _Calls(host)
    _, ex = _policy(step, which, host)
    loss, grads, _ = _run(step, ex)
    _bit_equal(step, loss, grads)
    cpu_notes, cpu_last = list(notes), ex.last
    notes.clear()

    eng, card = _card_engine(monkeypatch)
    calls = _Calls(eng)
    ap, ex = _policy(step, which, eng)
    loss, grads, _ = _run(step, ex)
    _bit_equal(step, loss, grads)
    # the dispatch has returned: nothing retired, no book closed yet
    assert notes == [] and eng.class_in_flight(P) > 0
    assert card.host_waits == [] and eng.pool.bytes_in_use > 0
    last = ex.last                       # a plain read closes nothing
    assert notes == [] and last["settle_s"] == 0.0
    card.sync()
    ex.settle()
    assert card.host_waits == [] and last["host_waits"] == 0
    assert eng.class_in_flight(P) == 0 and eng.pool.bytes_in_use == 0
    got_notes, got = list(notes), {k: getattr(eng.by_class[P], k)
                                   for k in COUNTERS}
    # the card's own submissions, retired on the host by the CPU engine
    notes.clear()
    replay = _engine()
    for tag, op in eng.planned_releases().items():
        replay.plan_release(tag, op)
    calls.replay(replay, lambda n: torch.zeros(n, dtype=torch.uint8))
    assert Counter(got_notes) == Counter(notes) and got_notes
    want = {k: getattr(replay.by_class[P], k) for k in COUNTERS}
    assert got == want
    # every release op found its copy running: none retired there
    assert last["released_late"] == want["released_at_op"]
    assert (want["released_at_op"] > 0) == (which == "lowered")
    # what the CPU step moved and the card did not: each kept storage out
    # and back once, swapped in at once on the CPU, not an entry
    extra = Counter(cpu_notes) - Counter(got_notes)
    assert not Counter(got_notes) - Counter(cpu_notes)
    kept = {n[2]: n[3] for n in extra}
    assert sorted(n[:4] for n in extra) == sorted(
        (d, P, t, nb) for t, nb in kept.items() for d in ("in", "out"))
    assert set(kept) <= _at_once(host_calls.calls) - _at_once(calls.calls)
    assert not set(kept) & {pexec.SwapPolicy.entry_tag(e) for e in
                            (ap.swap.entries if ap.swap else ())}
    assert (last["kept"], last["kept_bytes"]) == (len(kept),
                                                  sum(kept.values()))
    for k in ("staged", "restored", "prefetched"):
        assert last[k] == cpu_last[k] - last["kept"], k
    for k in ("staged_bytes", "restored_bytes"):
        assert last[k] == cpu_last[k] - last["kept_bytes"], k
    for k in ("on_demand", "recomputed", "never_restored",
              "forced_retires"):
        assert last[k] == cpu_last[k], k
    assert last["views"] <= cpu_last["views"] - last["kept"]
    # a fence before each restored storage's use, timed
    assert len(last["stall_entries"]) == last["restored"]
    assert all(e[2] >= 0 for e in last["stall_entries"])
    assert last["settle_s"] > 0.0 and cpu_last["settle_s"] == 0.0


def test_an_unread_run_is_settled_when_the_execution_runs_again(
        step, monkeypatch):
    eng, card = _card_engine(monkeypatch)
    _, ex = _policy(step, "lowered", eng)
    _run(step, ex)
    first = eng.class_in_flight(P)
    card.sync()
    _run(step, ex)                       # the first run's books close
    assert first > 0 and eng.open_execution is ex
    card.sync()
    ex.settle()
    last = ex.last
    assert eng.class_in_flight(P) == 0 and eng.open_execution is None
    assert card.host_waits == [] and last["host_waits"] == 0
    c = eng.by_class[P]
    assert c.bytes_out == c.bytes_in == 2 * last["staged_bytes"] > 0


def test_another_execution_settles_the_open_one_before_it_begins(
        step, monkeypatch):
    """Two executions on one engine: the second's copies never share the
    class with the first's open books, so each retire reaches the ledger
    before the next step's copies are issued."""
    eng, card = _card_engine(monkeypatch)
    notes = _notes(monkeypatch, obs.ledger())
    _, first = _policy(step, "lowered", eng)
    _, second = _policy(step, "conservative", eng)
    _run(step, first)
    assert eng.open_execution is first and notes == []
    card.sync()
    _run(step, second)
    assert eng.open_execution is second
    a = first.last
    assert a["settle_s"] > 0.0 and a["host_waits"] == 0
    assert len(notes) == a["staged"] + a["restored"]
    card.sync()
    second.settle()
    b = second.last
    assert eng.class_in_flight(P) == 0 and card.host_waits == []
    assert len(notes) == a["staged"] + a["restored"] + b["staged"] + b[
        "restored"]


@pytest.mark.parametrize("where", ["card", "cpu"])
@pytest.mark.parametrize("entry", [False, True])
def test_a_storage_due_before_it_is_saved_stays_unless_an_entry(
        entry, where, monkeypatch):
    """A storage of an offloaded site whose swap-in op comes before it is
    saved would come back at once: on a card it stays on the device unless
    the policy names it as an entry, which is staged and swapped in at
    once.  On the CPU it is staged and swapped in at once either way, as
    the reference moves every tensor of an offloaded site."""
    eng = _engine()
    if where == "card":
        eng, card = _card_engine(monkeypatch, eng)
    ap = pexec.AppliedPolicy(None, {"ffn_pre"}, set(), set(), "t")
    ex = pexec.Executor(ChameleonConfig()).execution(ap, eng)
    ex._uid_of = {("ffn_pre", sites._STATE.layer, 0): 7}
    ex._in_op, ex._tags = {7: 0}, {7: "ffn_pre:0:7"}
    if entry:
        ex.entries = frozenset({7})
    w = torch.randn(64, 64, requires_grad=True)
    with ex.run():
        h = sites.tag(w @ w, "ffn_pre")      # its swap-in op (0) has come
        (h * h).sum().backward()
    if where == "card":
        card.sync()
        ex.settle()
    ref = w.detach().clone().requires_grad_(True)
    h2 = ref @ ref
    (h2 * h2).sum().backward()
    assert torch.equal(w.grad, ref.grad)
    last, nb = ex.last, 64 * 64 * 4
    stays = where == "card" and not entry
    assert (last["staged"], last["prefetched"], last["kept"]) == (
        (0, 0, 1) if stays else (1, 1, 0))
    assert last["kept_bytes"] == (nb if stays else 0)
    assert eng.by_class[P].bytes_out == eng.by_class[P].bytes_in == (
        0 if stays else nb)


# --------------------------------------------------------- the CPU
class _Calls:
    """The engine calls an execution makes, for replay on the reference."""

    NAMES = ("submit_swap_out", "submit_swap_in", "advance_op",
             "drain_class", "set_class_depth", "begin_iteration")

    def __init__(self, eng):
        self.calls = []
        for name in self.NAMES:
            setattr(eng, name, self._wrap(name, getattr(eng, name)))

    def _wrap(self, name, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            self.calls.append((name, a, out))
            return out
        return call

    def replay(self, ref, payload=lambda n: np.zeros(n, np.uint8)):
        evs = {}
        for name, a, out in self.calls:
            if name == "submit_swap_out":
                evs[out.eid] = ref.submit_swap_out(payload(out.nbytes), a[1])
            elif name == "submit_swap_in":
                evs[out.eid] = ref.submit_swap_in(evs[a[0].eid], a[1])
            elif name == "advance_op":
                assert a[1:] in ((), (None,))    # no fences on the CPU
                ref.advance_op(a[0])
            else:
                getattr(ref, name)(*a)


@pytest.mark.parametrize("which", POLICIES)
def test_cpu_policy_step_retires_as_the_reference(step, which, monkeypatch):
    """On the CPU the engine under a policy step's own calls (its
    submissions, release ops, window and drain) retires the reference's
    copies in the reference's order, and the step stays bit-exact."""
    eng = _engine()
    calls = _Calls(eng)
    got = _notes(monkeypatch, obs.ledger())
    ap, ex = _policy(step, which, eng)
    loss, grads, _ = _run(step, ex)
    _bit_equal(step, loss, grads)
    last = ex.last
    assert last["host_waits"] == last["released_late"] == 0
    assert last["settle_s"] == 0.0 and last["copy_stall_s"] == 0.0
    assert eng.class_in_flight(P) == 0     # drained at the dispatch's end
    ref = RH.TransferEngine(RH.PinnedSlabPool())
    for tag, op in eng.planned_releases().items():
        ref.plan_release(tag, op)
    want = _notes(monkeypatch, robs.ledger())
    calls.replay(ref)
    assert [n[:5] for n in got] == [n[:5] for n in want] and got
    keys = COUNTERS + ("stall_transfers", "preemptions", "hwm_queued_bytes")
    mine, theirs = (e.by_class[P].as_dict() for e in (eng, ref))
    assert {k: mine[k] for k in keys} == {k: theirs[k] for k in keys}
