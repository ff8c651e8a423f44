"""Lightweight monitoring (§4) and Algo 1: the port against the reference,
on the CPU.

The port's op stream is the aten dispatch stream (``OpStreamRecorder``),
the reference's the tokenized jaxprs of the jitted functions an iteration
dispatches, so the streams differ op for op.  Parity is behavioural, as
ROADMAP.md item 4a sets it: the same integer sequences give the same
transitions in both ``StageMachine``s (the drift scenarios of
``tests/test_tokenizer_stages.py``), and the same training schedule gives
the same stage list through either monitor.  Every comparison is exact
(stage names, transition tuples); the similarity functions, copied as
numpy, are compared with ``==`` on their floats.
"""
import shutil
import tempfile

import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as PC
from repro.common.config import ChameleonConfig as RChameleonConfig
from repro.common.config import TrainConfig as RTrainConfig
from repro.core.stages import StageMachine as RStageMachine
from repro.core.tokenizer import sequence_signature as r_sequence_signature
from repro.core.tokenizer import similarity as r_similarity
from repro.data.synthetic import SyntheticTokens as RTokens
from repro.runtime.trainer import Trainer as RTrainer
from repro_torch.common.config import ChameleonConfig, TrainConfig
from repro_torch.core.stages import Stage, StageMachine
from repro_torch.core.tokenizer import (GLOBAL_VOCAB, OpStreamRecorder,
                                        SignatureAccumulator,
                                        sequence_signature, similarity)
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.runtime.trainer import Trainer

torch.set_num_threads(1)      # tier-1 runs several xdist workers

# The stage list of 10 steps of reduced llama2-paper (8 layers) with
# eval_every=6 under the default Algo 1 (m = 2, n = 5): three WarmUp steps,
# GenPolicy from step 3, and the eval dispatch of step 6 lengthens the
# sequence (a seq-change back to WarmUp).  chip_smoke.py's chameleon phase
# holds the full-width run on the card to the same list.
STAGES_10 = ["WarmUp"] * 3 + ["GenPolicy"] * 3 + ["WarmUp"] * 4
TRANSITIONS_10 = [(0, "init", "WarmUp"), (3, "stable", "GenPolicy"),
                  (6, "seq-change", "WarmUp")]


def _names():
    return {tok: name for name, tok in GLOBAL_VOCAB._ids.items()}


def _a(*parts):
    return np.concatenate([np.asarray(p, np.int32) for p in parts])


_BASE = _a([1, 2, 3] * 50)
_LONG = _a([1, 2, 3] * 100)
# (m, n, the sequence fed at each step): tests/test_tokenizer_stages.py's
# scenarios, and a few more drifts of the same kinds
SCENARIOS = {
    "algo1": (2, 3, [_BASE] * 12),
    "resets_on_change": (1, 1, [_BASE] * 6
                         + [_a(_BASE, [7, 8, 9] * 30)]),
    "tolerates_minor_change": (1, 1, [_LONG] * 6
                               + [_a(_LONG, [1, 2])] * 2),
    "eval_every_3": (2, 5, [_a(_BASE, [4, 5] * 40) if i % 3 == 2 else _BASE
                            for i in range(14)]),
    "length_step_then_settle": (2, 2, [_BASE] * 4 + [_LONG] * 8),
    "reorder_only": (1, 2, [_BASE, _BASE, _BASE[::-1], _BASE[::-1], _BASE]),
    "empty_then_ops": (1, 1, [_a([]), _a([]), _BASE, _BASE, _BASE]),
}


def _run(machine_cls, cfg_cls, m, n, seqs):
    sm = machine_cls(cfg_cls(m_warmup_stable=m, n_genpolicy_steps=n))
    stages = [sm.observe(s, i).value for i, s in enumerate(seqs)]
    return stages, [tuple(t) for t in sm.transitions], sm.stable_step


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_stage_machines_agree_on_drift_scenarios(name):
    m, n, seqs = SCENARIOS[name]
    got = _run(StageMachine, ChameleonConfig, m, n, seqs)
    want = _run(RStageMachine, RChameleonConfig, m, n, seqs)
    assert got == want


def test_stage_machine_algo1_positions():
    """tests/test_tokenizer_stages.py::test_stage_machine_algo1 on the port."""
    stages, _, _ = _run(StageMachine, ChameleonConfig, 2, 3, [_BASE] * 12)
    assert stages[0] == "WarmUp"
    assert stages.index("GenPolicy") == 3 and stages.index("Stable") == 7


@pytest.mark.parametrize("seed", range(6))
def test_similarity_equals_reference(seed):
    rng = np.random.RandomState(seed)
    a = rng.randint(1, 20, rng.randint(0, 200)).astype(np.int32)
    b = rng.randint(1, 20, rng.randint(0, 200)).astype(np.int32)
    for x, y in ((a, b), (a, a.copy()), (a, rng.permutation(a))):
        assert similarity(x, y) == r_similarity(x, y)
    parts = [a, np.zeros(0, np.int32), b]
    np.testing.assert_array_equal(sequence_signature(parts),
                                  r_sequence_signature(parts))


def test_signature_of_an_unchanged_stream_short_circuits():
    """Two identical iterations give equal content keys, so Algo 1's test
    costs no array work (the reference's steady-state path)."""
    rec, acc = OpStreamRecorder(), SignatureAccumulator()
    x = torch.randn(8, 8)
    sigs = []
    for _ in range(2):
        with rec.iteration() as it:
            (x @ x).relu().sum()
        sigs.append(acc.update([it.stream]))
    assert len(sigs[0]) == 3 and sigs[0].key == sigs[1].key
    assert acc.stats()["changed_slots"] == 1


def test_recorder_names_ops_and_keeps_their_order():
    rec = OpStreamRecorder()
    x = torch.randn(4, 4)
    with rec.iteration() as it:
        y = torch.mm(x, x)
        y.add_(1.0)
        torch.mm(y, x)
    names = [_names()[t] for t in it.stream.tokens]
    assert names == ["aten::mm", "aten::add_", "aten::mm"]
    assert rec.iterations == 1 and rec.overhead_s > 0


def test_recorder_buffer_grows_past_its_capacity():
    rec = OpStreamRecorder(capacity=16)
    x = torch.ones(2)
    with rec.iteration() as it:
        for _ in range(100):
            x = x + 1
    assert len(it.stream) == 100 and float(x[0]) == 101.0


# ------------------------------------------------- the training schedule
@pytest.fixture(scope="module")
def ten_steps():
    """10 steps of reduced llama2-paper (8 layers, batch 4 x 128,
    eval_every=6) through each package's trainer: the port's monitored by
    its recorder, the reference's by its runtime's jaxpr tokenizer."""
    d = tempfile.mkdtemp()
    try:
        kw = dict(steps=10, eval_every=6, checkpoint_every=0,
                  checkpoint_dir=d, warmup_steps=1, learning_rate=1e-3)
        rcfg = RC.get_reduced("llama2-paper").replace(num_layers=8,
                                                     attn_impl="pallas")
        rtr = RTrainer(rcfg, RTrainConfig(**kw), RChameleonConfig(enabled=False),
                       data=RTokens(rcfg.vocab_size, 128, 4, seed=0))
        ref = rtr.train(10).stages
        ref_transitions = [tuple(t) for t in rtr.rt.machine.transitions]

        pcfg = PC.get_reduced("llama2-paper").replace(num_layers=8,
                                                     attn_impl="flash")
        tr = Trainer(pcfg, TrainConfig(**kw), ChameleonConfig(enabled=False),
                     data=SyntheticTokens(pcfg.vocab_size, 128, 4, seed=0),
                     device="cpu")
        rec, acc = OpStreamRecorder(), SignatureAccumulator()
        sm = StageMachine(ChameleonConfig())
        stages, streams = [], []
        for i in range(10):
            with rec.iteration() as it:
                tr.train(1)
            streams.append(it.stream)
            stages.append(sm.observe(acc.update([it.stream]), i).value)
        yield dict(ref=ref, ref_transitions=ref_transitions, stages=stages,
                   transitions=[tuple(t) for t in sm.transitions],
                   streams=streams, rec=rec, times=tr.report.times)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def test_ten_steps_give_the_reference_stage_list(ten_steps):
    assert ten_steps["ref"] == STAGES_10
    assert ten_steps["stages"] == STAGES_10
    assert ten_steps["transitions"] == ten_steps["ref_transitions"] \
        == TRANSITIONS_10


def test_k1_is_one_token_each_way_in_the_cpu_stream(ten_steps):
    """The custom ops hide the plain versions' aten ops: 8 layers give 8
    forward and 8 backward tokens a step and no batched product (only the
    plain attention computes one)."""
    names = _names()
    for i, s in enumerate(ten_steps["streams"]):
        ops = [names[t] for t in s.tokens]
        evals = 8 if i == 6 else 0
        assert ops.count("repro_torch::flash_attention_fwd") == 8 + evals
        assert ops.count("repro_torch::flash_attention_bwd") == 8
        assert "aten::bmm" not in ops
    assert len(ten_steps["streams"][6]) > len(ten_steps["streams"][5])
    assert (ten_steps["streams"][3].content_hash
            == ten_steps["streams"][4].content_hash)


def test_recorder_overhead_small(ten_steps):
    """tests/test_trainer_integration.py::test_profiling_overhead_small's
    bar: the monitor's bookkeeping under half the steps' time."""
    total = sum(ten_steps["times"][5:])
    assert 0 < ten_steps["rec"].overhead_s < 0.5 * total


def test_stage_enum_matches_reference():
    from repro.core.stages import Stage as RStage
    assert [s.value for s in Stage] == [s.value for s in RStage]


def test_core_modules_import_neither_jax_nor_reference():
    """The slice's modules, imported alone in a fresh interpreter, pull in
    no JAX and nothing of the reference package."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    mods = ["tokenizer", "stages", "sites", "profiler", "memtrace", "mrl",
            "candidates", "simulator", "policy", "oom", "matching"]
    code = ("import sys\n"
            + "".join(f"import repro_torch.core.{m}\n" for m in mods)
            + "print(sorted(n for n in sys.modules if n.split('.')[0] in "
              "('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": src},
                         timeout=120, check=True).stdout
    assert out.strip() == "[]"
