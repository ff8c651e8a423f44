"""The traffic generator: the same seed gives the same batches, another
seed other ones, and every seed the same schedule."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import feed

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


@pytest.mark.parametrize("mix", sorted(p.stem for p in TRAFFIC.glob("*.json")))
def test_same_seed_same_batches(mix):
    sched = feed.Schedule(json.loads((TRAFFIC / f"{mix}.json").read_text()))
    big = 2 ** 31 + 12345
    for step in (0, 1, sched.period, 5 * sched.period + 3):
        a = feed.batch(sched, 1000, big, step)
        b = feed.batch(sched, 1000, big, step)
        c = feed.batch(sched, 1000, big + 1, step)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert not np.array_equal(a[0], c[0])
        assert a[0].shape == (sched.batch, sched.seq(step))
        assert np.array_equal(a[0][:, 1:], a[1][:, :-1])


def test_rows_and_steps_differ():
    sched = feed.Schedule({"batch": 2, "buckets": [16, 24], "period": 3})
    seen = {feed.batch(sched, 50000, 7, k)[0].tobytes() for k in range(12)}
    assert len(seen) == 12
    t, _ = feed.batch(sched, 50000, 7, 0)
    assert not np.array_equal(t[0], t[1])


def test_schedule_alternates_buckets():
    sched = feed.Schedule({"batch": 2, "buckets": [2048, 3072], "period": 12})
    assert [sched.seq(k) for k in (0, 11, 12, 23, 24)] == [
        2048, 2048, 3072, 3072, 2048]


def test_feed_serves_the_step_it_is_set_to():
    sched = feed.Schedule({"batch": 2, "buckets": [8], "period": 4})
    fd = feed.Feed(sched, 100, 3)
    fd.step = 5
    got = fd.get()
    assert np.array_equal(got["tokens"], feed.batch(sched, 100, 3, 5)[0])
    assert fd.get() is got
