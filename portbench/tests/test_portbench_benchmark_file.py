"""BENCHMARK.json against the benchmark's rules, and every file it names
found by name."""
from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import pytest

from portbench import harness, weights, yardstick

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
WIDTH = re.compile(r"(hidden_size|intermediate|latent|state_size|_proj|"
                   r"_dim$|_rank$|head|expan|per_tok)")
# the configuration file's key -> the port's ModelConfig field
PORT_FIELDS = {"hidden_size": "d_model", "num_attention_heads": "num_heads",
               "num_key_value_heads": "num_kv_heads",
               "num_hidden_layers": "num_layers", "vocab_size": "vocab_size",
               "rope_theta": "rope_theta", "qkv_bias": "qkv_bias",
               "tie_word_embeddings": "tie_embeddings"}
DENSE_FIELDS = {"intermediate_size": "d_ff"}
MOE_FIELDS = {"moe_intermediate_size": "moe_d_ff",
              "num_experts": "num_experts",
              "num_experts_per_tok": "experts_per_token",
              "router_aux_loss_coef": "router_aux_coef",
              "capacity_factor": "moe_capacity_factor"}


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["portbench"]
    assert len(B["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in B["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_units(section):
    names = [e["name"] for e in B[section]]
    assert len(names) == len(set(names))
    for e in B[section]:
        optional = ({"workloads"} if section in ("end_to_end", "per_layer")
                    else set())
        extra = set(e) - KEYS[section] - optional
        assert KEYS[section] <= set(e) and not extra, (e["name"], extra)
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]


def test_run_seconds_fit_a_full_check():
    rs = B["run_seconds"]
    assert 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_cell_files_found_by_name(cell):
    entry, cfgj, traffic, cellj = harness.cell_files(cell, B)
    assert entry["chips"] == 1
    assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
    assert cellj["name"] == cell and set(cellj["limits"]) >= {
        "loss", "grad", "change"}
    e2e = harness.metrics_for(cell, B, "end_to_end")
    layer = harness.metrics_for(cell, B, "per_layer")
    assert {m["name"] for m in e2e} >= {"setup_s"} and len(e2e) >= 2
    assert layer
    for m in e2e + layer:
        assert callable(harness.reader(m["name"]))
    moved = {m["moves"] for m in layer}
    assert moved <= {m["name"] for m in e2e}
    if traffic["chameleon"]["enabled"]:
        assert traffic["chameleon"]["hbm_budget_bytes"] > 0


def test_per_layer_metrics_name_their_cells():
    cells = {w["name"] for w in B["workloads"]}
    for m in B["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        assert m["moves"] in {e["name"] for e in B["end_to_end"]}


@pytest.mark.parametrize("entry", B["configs"], ids=lambda e: e["name"])
def test_configuration_file_is_what_runs(entry):
    path = ROOT / entry["file"]
    assert path.parts[len(ROOT.parts)] == "portbench"
    cfgj = json.loads(path.read_text())
    assert cfgj["name"] == entry["name"] and cfgj["source"] == entry["source"]
    assert sorted(entry["reduced"]) == sorted(cfgj["reduced"])
    assert all(NAME.match(k) and not WIDTH.search(k) for k in entry["reduced"])
    port = harness.port_config(cfgj)
    fields = {**PORT_FIELDS, **(MOE_FIELDS if cfgj["family"] == "moe"
                                else DENSE_FIELDS)}
    for key, field in fields.items():
        assert getattr(port, field) == cfgj.get(key, False), key
    assert port.head_dim == yardstick.head_dim(cfgj)
    assert port.dtype == port.param_dtype == cfgj["torch_dtype"]
    assert port.family == cfgj["family"] and port.attn_impl == "flash"
    n = yardstick.param_count(cfgj)
    assert n == port.param_count()
    assert n == sum(s.numel for s in weights.leaves(cfgj))


def test_metric_readers_are_files_of_their_own():
    for m in B["end_to_end"] + B["per_layer"]:
        mod = importlib.import_module(f"portbench.metrics.{m['name']}")
        assert Path(mod.__file__).name == f"{m['name']}.py"
