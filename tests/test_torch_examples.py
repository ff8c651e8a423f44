"""The reference's five examples ported to ``repro_torch``
(``examples_torch/``), each run on ``--device cpu`` in a fresh process,
with the reference example's own assertions (each ``main`` makes them; a
failed one exits non-zero) and the returned record checked here too.

Each runs in a child so no trainer, server or metrics provider of one
example outlives it into another test; each takes 5-20 s on one worker.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def run_example(name: str, argv, tmp_path) -> dict:
    """``examples_torch.<name>.main(argv)`` in a child on the CPU: its
    returned record (JSON), after it printed ``OK``."""
    code = textwrap.dedent(f'''
        import json, sys
        sys.path.insert(0, {ROOT!r})
        from examples_torch import {name} as ex
        out = ex.main({list(argv)!r})
        print(json.dumps(out, default=str))
    ''')
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=240, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1]), r.stdout


def test_quickstart(tmp_path):
    """18 steps under the 30 MiB budget: the loss falls and the stages go
    WarmUp -> GenPolicy -> Stable."""
    out, text = run_example("quickstart", ["--device", "cpu", "--steps",
                                           "18"], tmp_path)
    assert "OK" in text
    first = [out["stages"].index(s) for s in ("WarmUp", "GenPolicy",
                                              "Stable")]
    assert first == sorted(first)
    assert out["losses"][-1] < out["losses"][0]


def test_adaptive_swap_demo(tmp_path):
    """45 steps with an eval every 15: a ``seq-change`` transition and no
    failures."""
    out, text = run_example("adaptive_swap_demo", ["--device", "cpu"],
                            tmp_path)
    assert "OK" in text and out["failures"] == []
    assert any(t[1] == "seq-change" for t in out["transitions"])
    assert out["evals"] == [15, 30]


def test_elastic_restart(tmp_path):
    """A crash at step 17, the emergency checkpoint, a fresh trainer's
    resume: the losses after it equal the uninterrupted run's (rtol 1e-5),
    single-process as in the reference."""
    out, text = run_example("elastic_restart", ["--device", "cpu"], tmp_path)
    assert "crashed as injected" in text and "OK" in text
    n = len(out["resumed"])
    # past the last periodic checkpoint (10): the emergency one
    assert out["resumed_at"] > 10 and n == 30 - out["resumed_at"]
    np.testing.assert_allclose(out["reference"][-n:], out["resumed"],
                               rtol=1e-5)


def test_serve_batched(tmp_path):
    """10 requests over 4 slots: every request finishes with its 8
    tokens."""
    out, text = run_example("serve_batched", ["--device", "cpu"], tmp_path)
    assert "OK" in text
    assert len(out["results"]) == 10
    assert all(len(v) == 8 for v in out["results"].values())


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_train_e2e(tmp_path, preset):
    """A preset's run with eval, checkpoints, the trace, the metrics and
    the over-subscribed serving burst; then ``--resume`` continues from
    its last checkpoint."""
    trace, metrics = tmp_path / "trace.json", tmp_path / "m.jsonl"
    common = ["--device", "cpu", "--preset", preset, "--seq", "32",
              "--batch", "2", "--eval-every", "3", "--checkpoint-every", "3"]
    out, text = run_example(
        "train_e2e", common + ["--steps", "6", "--with-serve",
                               "--trace-out", str(trace),
                               "--metrics-out", str(metrics)], tmp_path)
    assert out["start_step"] == 0 and out["step"] == 6
    assert len(out["losses"]) == 6 and np.isfinite(out["losses"]).all()
    assert sorted(out["evals"]) == ["3"]
    assert len(out["checkpoints"]) == 2
    assert out["serve"]["requests"] == 4 and out["serve"]["spills"] > 0
    from repro_torch.obs.validate import (validate_chrome_trace,
                                          validate_metrics_jsonl)
    with open(trace) as f:
        assert validate_chrome_trace(json.load(f))["n_spans"] > 0
    validate_metrics_jsonl(str(metrics))
    again, text = run_example("train_e2e", common + ["--steps", "3",
                                                     "--resume"], tmp_path)
    assert "resumed at step 6" in text and again["start_step"] == 6
    assert again["step"] == 9
