"""Small sizes of the benchmark's cells for the CPU tests: the same
families and code paths at widths a test run holds, in float32 as the
program's reduced configurations are (so a sound run's gaps are rounding
of float32, far under the cells' limits, and a fault's stand out)."""
from __future__ import annotations

import time

import torch

DENSE_CFG = {"hidden_size": 128, "num_attention_heads": 4,
             "num_key_value_heads": 2, "head_dim": 32,
             "intermediate_size": 344, "num_hidden_layers": 4,
             "vocab_size": 512}
F32 = {"dtype": "float32", "param_dtype": "float32"}
DENSE_PORT = {"num_layers": 4, "d_model": 128, "num_heads": 4,
              "num_kv_heads": 2, "head_dim": 32, "d_ff": 344,
              "vocab_size": 512, **F32}
MOE_CFG = {"hidden_size": 64, "num_attention_heads": 4,
           "num_key_value_heads": 2, "head_dim": 16,
           "moe_intermediate_size": 32, "num_experts": 8,
           "num_experts_per_tok": 2, "num_hidden_layers": 2,
           "vocab_size": 256}
MOE_PORT = {"num_layers": 2, "d_model": 64, "num_heads": 4,
            "num_kv_heads": 2, "head_dim": 16, "d_ff": 32, "moe_d_ff": 32,
            "num_experts": 8, "experts_per_token": 2, "vocab_size": 256,
            **F32}
TRAFFIC = {"buckets": [64, 96], "period": 6, "trace_steps": 2, "batch": 4}
# the lowest budget a policy meets at the small swap cell's longer bucket
# (portbench.tools.budget_sweep on the CPU) + 1%
SMALL_BUDGET = 22_979_616


def overrides(cell: str) -> dict:
    moe = "moe" in cell
    traffic = dict(TRAFFIC)
    if moe:
        traffic["buckets"] = [64]
    if cell == "qwen2-7b.swap_drift":
        traffic["chameleon"] = {"enabled": True, "placement": "async",
                                "policy_store": "memory",
                                "hbm_budget_bytes": SMALL_BUDGET}
    return {"config_overrides": MOE_CFG if moe else DENSE_CFG,
            "port_overrides": MOE_PORT if moe else DENSE_PORT,
            "traffic_overrides": traffic}


def run(cell: str, seed: int = 20261018, seconds: float = 0.5,
        trace: bool = False, limits=None) -> dict:
    from portbench import harness
    torch.manual_seed(0)
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), limits=limits,
                            **overrides(cell))
