"""Assigned-architecture configs (public-literature exact configs) plus the
paper's own Llama2 scaling target.  ``get_config(name)`` returns the full
config; ``get_reduced(name)`` a smoke-test-sized config of the same family.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.common.config import ModelConfig, SHAPES, ShapeConfig

ARCH_IDS: List[str] = [
    "whisper_large_v3",
    "qwen2_7b",
    "qwen1_5_0_5b",
    "stablelm_1_6b",
    "llama3_2_1b",
    "qwen3_moe_30b_a3b",
    "granite_moe_1b_a400m",
    "llama3_2_vision_90b",
    "mamba2_780m",
    "zamba2_1_2b",
]
# canonical external ids (with dashes/dots) -> module name
ALIASES = {
    "whisper-large-v3": "whisper_large_v3",
    "qwen2-7b": "qwen2_7b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "stablelm-1.6b": "stablelm_1_6b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "mamba2-780m": "mamba2_780m",
    "zamba2-1.2b": "zamba2_1_2b",
    "llama2-paper": "llama2_paper",
}
ALL_IDS = ARCH_IDS + ["llama2_paper"]


def _module(name: str):
    name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()


def applicable_shapes(cfg: ModelConfig) -> List[ShapeConfig]:
    """Shape cells this arch runs; long_500k needs sub-quadratic decode."""
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue  # full-attention arch: noted skip (DESIGN.md §5)
        out.append(s)
    return out


def cell_matrix() -> Dict[str, List[str]]:
    """arch -> list of runnable shape names (the 40-cell table w/ skips)."""
    return {a: [s.name for s in applicable_shapes(get_config(a))]
            for a in ARCH_IDS}
