"""The transfer engine's link-contention signals, which the simulator
prices (``core/simulator.py``: ``queued_delay`` and
``sustained_contention``).

On the CPU the port prices them as the reference does, bit for bit: the
same submissions on both engines, under a host clock that stands still,
give equal numbers (``==``).  On a CUDA device the engine measures the link: a copy
whose done-event has completed is no backlog, and bytes are priced with
the direction's calibrated curve, else the engine's own measured rate,
else ``LINK_GBPS``.  No card is here, so the CUDA half runs an engine on
the CPU whose device is set to ``cuda`` and whose queued copies carry fake
CUDA events; it never reaches a CUDA call.
"""
import time

import numpy as np
import pytest
import torch

import repro.hostmem as RH
import repro_torch.hostmem as PH
from repro_torch.hostmem import engine as E
from repro_torch.hostmem.bwmodel import BandwidthModel

torch.set_num_threads(1)

MIB = 1 << 20
# (class, bytes) submitted in order: every class, both ends of the sizes
SUBMITS = [(PH.TC_CHECKPOINT, 64 * MIB), (PH.TC_KV_SPILL, 8 * MIB),
           (PH.TC_CHECKPOINT, 32 * MIB), (PH.TC_POLICY_SWAP, 1 * MIB),
           (PH.TC_KV_SPILL, 16 * MIB), (PH.TC_POLICY_SWAP, 4 * MIB)]


def _clock():
    """A host clock that stands still: both engines read the same time
    however often they read it."""
    return 100.0


def _signals(eng, classes):
    out = {}
    for c in classes:
        out[c] = (eng.queued_delay(c), eng.queued_delay(c, "in"),
                  eng.sustained_contention(c), eng.arrival_rate_bps(c))
    snap = eng.backlog_snapshot()
    out["snapshot"] = {c: (d["queued_delay"], d["occupancy"],
                           d["queued_bytes"]) for c, d in snap.items()}
    return out


# a measured link curve, the same points in both packages' models
CURVE = [(1 << 16, 1e-5), (1 << 22, 1.2e-4), (1 << 26, 1.9e-3)]


def _run(make_engine, arr, calibrated, monkeypatch):
    monkeypatch.setattr(time, "perf_counter", _clock)
    eng = make_engine(CURVE if calibrated else ())
    for c in (PH.TC_POLICY_SWAP, PH.TC_KV_SPILL, PH.TC_CHECKPOINT):
        eng.set_class_depth(c, 8)          # keep every copy queued
    evs = [eng.submit_swap_out(arr(n), f"t{i}", cls=c)
           for i, (c, n) in enumerate(SUBMITS)]
    before = _signals(eng, (PH.TC_POLICY_SWAP, PH.TC_KV_SPILL,
                            PH.TC_CHECKPOINT))
    eng.synchronize()
    after = _signals(eng, (PH.TC_POLICY_SWAP,))
    return before, after, [e.done for e in evs]


@pytest.mark.parametrize("calibrated", [False, True])
def test_cpu_signals_equal_reference(calibrated, monkeypatch):
    def ref_engine(points):
        bw = RH.BandwidthModel(32.0)
        for n, s in points:
            bw.observe(n, s)
        return RH.TransferEngine(RH.PinnedSlabPool(), bwmodel=bw)

    def port_engine(points):
        bw = BandwidthModel(32.0)
        for n, s in points:
            bw.observe(n, s)
        return E.TransferEngine(PH.PinnedSlabPool(), bwmodel=bw,
                                device="cpu")

    got = _run(port_engine, lambda n: torch.zeros(n, dtype=torch.uint8),
               calibrated, monkeypatch)
    want = _run(ref_engine, lambda n: np.zeros(n, np.uint8), calibrated,
                monkeypatch)
    assert got == want
    before, after, done = got
    assert before[PH.TC_CHECKPOINT][0] > before[PH.TC_POLICY_SWAP][0] > 0
    assert after[PH.TC_POLICY_SWAP][0] == 0.0 and all(done)


# ------------------------------------------------------ the CUDA half
class _FakeEvent:
    def __init__(self, done=False, ms=0.0):
        self.done, self.ms = done, ms

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, other):
        return other.ms


def _cuda_engine(**kw):
    eng = E.TransferEngine(PH.PinnedSlabPool(), device="cpu", **kw)
    eng.device = torch.device("cuda")     # the pricing paths of a card
    return eng


def _queue(eng, cls, nbytes, *, done, ms=1.0, kind=E.SWAP_OUT):
    ev = E.TransferEvent(len(eng._pending[(cls, kind)]) + 1, kind, "x",
                         nbytes, cls=cls)
    ev._cuda = (_FakeEvent(True, 0.0), _FakeEvent(done, ms))
    eng._pending[(cls, kind)].append(ev)
    return ev


def test_completed_copy_adds_nothing_to_queued_delay():
    eng = _cuda_engine()
    a = _queue(eng, PH.TC_CHECKPOINT, 256 * MIB, done=True)
    assert eng.queued_delay(PH.TC_CHECKPOINT) == 0.0
    _queue(eng, PH.TC_CHECKPOINT, 256 * MIB, done=False)
    one = 256 * MIB / (E.LINK_GBPS[E.SWAP_OUT] * 1e9)
    assert eng.queued_delay(PH.TC_CHECKPOINT) == one
    # a higher class sees one lower-class copy as head-of-line blocking,
    # and that head is the copy still on the link, not the finished one
    assert eng.queued_delay(PH.TC_POLICY_SWAP) == one
    a._cuda[1].done = False
    assert eng.queued_delay(PH.TC_CHECKPOINT) == 2 * one
    assert eng.backlog_snapshot()[PH.TC_CHECKPOINT]["queued_delay"] == 2 * one


def test_failed_issue_is_no_backlog():
    eng = _cuda_engine()
    ev = E.TransferEvent(1, E.SWAP_OUT, "x", 64 * MIB, cls=PH.TC_KV_SPILL)
    eng._pending[(PH.TC_KV_SPILL, E.SWAP_OUT)].append(ev)   # never issued
    assert eng.queued_delay(PH.TC_KV_SPILL) == 0.0


def test_pricing_measured_rate_then_calibrated_curve():
    eng = _cuda_engine()
    n = 64 * MIB
    assert eng._est_seconds(n, E.SWAP_IN) == n / (E.LINK_GBPS[E.SWAP_IN] * 1e9)
    # retiring copies measures the link: 128 MiB out in 4 ms
    for _ in range(2):
        ev = _queue(eng, PH.TC_POLICY_SWAP, n, done=False, ms=2.0)
        eng._execute(eng._pending[(PH.TC_POLICY_SWAP, E.SWAP_OUT)].popleft())
        assert ev.done and ev.seconds == 2e-3
    assert eng._est_seconds(n) == pytest.approx(2e-3, rel=1e-12)
    # a calibrated curve of the direction wins over the measured rate
    curve = BandwidthModel(1.0)
    curve.observe(1 << 20, 1e-4)
    curve.observe(1 << 26, 5e-3)
    eng.link_models = {E.SWAP_OUT: curve}
    assert eng._est_seconds(n) == curve.transfer_time(n)
    assert eng._est_seconds(n, E.SWAP_IN) == \
        n / (E.LINK_GBPS[E.SWAP_IN] * 1e9)


def test_sustained_contention_priced_by_measured_rate():
    eng = _cuda_engine()
    eng._note_arrival(PH.TC_CHECKPOINT, 256 * MIB, time.perf_counter())
    at_constant = eng.sustained_contention(PH.TC_POLICY_SWAP)
    eng._retired_link[E.SWAP_OUT] = [256 * MIB, 256 * MIB / 20e9]
    at_20 = eng.sustained_contention(PH.TC_POLICY_SWAP)
    assert at_20 == pytest.approx(at_constant * E.LINK_GBPS[E.SWAP_OUT] / 20,
                                  rel=1e-3)
    assert eng.sustained_contention(PH.TC_CHECKPOINT) == 0.0


def test_calibrate_sets_each_directions_curve():
    tier = PH.HostMemTier(device="cpu")
    tier.calibrate(sizes=(1 << 16, 1 << 18), iters=1)
    models = tier.engine.link_models
    assert set(models) == {E.SWAP_OUT, E.SWAP_IN}
    for size, (d2h, h2d) in tier.link_curve.items():
        assert models[E.SWAP_OUT].transfer_time(size) == d2h
        assert models[E.SWAP_IN].transfer_time(size) == h2d


def test_no_tpu_figure_in_the_config_or_engine():
    """The defaults name the card (NVIDIA H100 80GB HBM3): the data sheet's
    989 TFLOP/s and 3.35 TB/s, the calibrated link."""
    from repro_torch.common.config import ChameleonConfig
    c = ChameleonConfig()
    assert (c.peak_flops, c.hbm_gbps, c.host_link_gbps) == (989e12, 3350.0,
                                                            40.2)
    assert c.hbm_budget_bytes > 64 * 1024 ** 3
    assert E._EST_FALLBACK_GBPS == E.LINK_GBPS[E.SWAP_OUT] == 37.8
