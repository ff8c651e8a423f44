"""Nothing a run loads is JAX or the JAX package, and the reference loads
nothing of the program: top-level module names compared whole (the
port's name begins with the JAX package's)."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
JAX = {"jax", "jaxlib", "flax", "repro"}

RUN = """
import sys
sys.path[:0] = ["src", "."]
from portbench.tests import tiny_cells
out = tiny_cells.run("qwen3-moe-30b-a3b.train", seconds=0.2)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""
REF = """
import sys
sys.path[:0] = ["."]
import torch
from portbench import weights
from portbench.reference import decoder, train
from portbench.tests import tiny_cells
cfg = {"family": "dense", "qkv_bias": True, "rms_norm_eps": 1e-6,
       "rope_theta": 1e6, **tiny_cells.DENSE_CFG}
p = {s.name: v.float() for s, v in weights.values(cfg, 1, "cpu")}
tok = torch.randint(0, cfg["vocab_size"], (2, 8))
train.run(cfg, p, [(tok, tok)], {"grad_clip": 1.0, "weight_decay": 0.1,
                                 "learning_rate": 1e-4, "warmup_steps": 1,
                                 "total_steps": 10})
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _modules(RUN)
    assert "repro_torch" in mods
    assert not mods & JAX


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(REF)
    assert not mods & (JAX | {"repro_torch"})


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_names_jax():
    for path in PKG.rglob("*.py"):
        assert not _imports(path) & JAX, path
    for path in (PKG / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch):
    import types

    import pytest

    from portbench import harness
    from portbench.tests import tiny_cells
    assert harness.forbidden_modules() == []      # repro_torch is no repro
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax"]
    with pytest.raises(SystemExit, match="jax"):
        tiny_cells.run("qwen3-moe-30b-a3b.train", seconds=0.2)
