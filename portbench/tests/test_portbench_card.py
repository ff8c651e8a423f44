"""A benchmark run on the card: the contract's result line."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card "
                    "(torch.cuda.is_available() is False)")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "qwen3-moe-30b-a3b.train", "--seed", "4294967311", "--seconds", "3",
         "--trace", "0"], cwd=ROOT, text=True, capture_output=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"tokens_per_s", "step_ms_p90",
                                   "peak_mem_gb", "setup_s"}
    assert list(res)[-1] == "checks"


def test_without_a_card_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "qwen2-7b.swap_drift", "--seed", "1", "--seconds", "1"], cwd=ROOT,
        text=True, capture_output=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
