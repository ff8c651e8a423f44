"""The port's dry run (``repro_torch.launch.dryrun``), its specs
(``launch.specs``, ``distributed.steps``' spec half) and the kernels'
fake-tensor rules, on the CPU.

The dry run traces one rank's share of a cell in this process on a fake
process group the size of the mesh, with fake tensors: a torch built
without CUDA cannot run a backward on fake ``cuda`` tensors, so the cells
here trace ``cpu`` (the card's path is traced by ``chip_smoke.py``'s
distributed phase).  The specs are held to the reference's
``PartitionSpec``s leaf for leaf: the reference runs in a JAX child with 8
host devices (``tests/conftest.py``'s ``run_child``) and the port on an
8-rank fake group; the stacked ``layers`` axis the reference prepends is
dropped before comparing.  ``param_axes`` is held to the reference's for
every family's reduced config through ``models.convert``.
"""
import json

import jax
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as C
from repro.distributed import steps as RS
from repro_torch.common.config import MeshConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import steps as S
from repro_torch.launch import dryrun
from repro_torch.launch import specs as SP
from repro_torch.models import convert

from conftest import run_child

MESH = MeshConfig((2, 4), ("data", "model"))
TRAIN = ShapeConfig("train_4k", "train", 64, 8)
DECODE = ShapeConfig("decode_32k", "decode", 256, 8)
PREFILL = ShapeConfig("prefill_32k", "prefill", 64, 8)


# --------------------------------------------------------------- axes
def _strip_layers(tree, stacked=False):
    if isinstance(tree, dict):
        return {k: _strip_layers(v, stacked or k in convert.STACKS)
                for k, v in tree.items()}
    assert not stacked or tree[0] == "layers", tree
    return tuple(tree[1:]) if stacked else tuple(tree)


@pytest.mark.parametrize("arch", sorted(set(C.ARCH_IDS) | {"llama2_paper"}))
def test_param_axes_match_reference(arch):
    ours = convert.to_reference_tree(S.param_axes(C.get_reduced(arch)),
                                     stack=lambda leaves: leaves[0])
    ref = RS.param_axes(RC.get_reduced(arch))
    assert ours == _strip_layers(jax.tree.map(
        tuple, ref, is_leaf=lambda x: isinstance(x, tuple)))


# -------------------------------------------------------------- specs
def _norm(spec, ndim=None):
    out = []
    for e in spec:
        if isinstance(e, (list, tuple)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else (e or None)
        out.append(e)
    if ndim is not None:
        out += [None] * (ndim - len(out))
    return tuple(out)


_REF_SPECS = '''
import json
import jax
from jax.sharding import NamedSharding
import repro.configs as C
from repro.common.config import ShapeConfig
from repro.launch import specs as SP
from repro.launch.mesh import make_test_mesh

def flat(tree):
    out = {{}}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name",
                       getattr(p, "idx", p)))) for p in path)
        out[key] = [list(e) if isinstance(e, tuple) else e
                    for e in leaf.spec]
    return out

res = {{}}
for mshape, axes in (((2, 4), ("data", "model")),
                     ((2, 2, 2), ("pod", "data", "model"))):
    mesh = make_test_mesh(mshape, axes)
    m = "x".join(map(str, mshape))
    for arch in ("llama2_paper", "granite_moe_1b_a400m"):
        cfg = C.get_reduced(arch)
        ins, outs = SP.train_shardings(cfg, ShapeConfig("t", "train", 64, 8),
                                       mesh, 2)
        res[f"train/{{m}}/{{arch}}"] = flat(ins)
    for arch in ("qwen2_7b", "mamba2_780m"):
        cfg = C.get_reduced(arch)
        shape = ShapeConfig("d", "decode", 256, 8)
        state = SP.decode_state_specs(cfg, shape)
        ins, outs = SP.serve_shardings(cfg, shape, mesh, state)
        res[f"decode/{{m}}/{{arch}}"] = flat((ins, outs))
    cfg = C.get_reduced("llama2_paper")
    ins, outs = SP.serve_shardings(cfg, ShapeConfig("p", "prefill", 64, 8),
                                   mesh)
    res[f"prefill/{{m}}/llama2_paper"] = flat((ins, outs))
with open("{out}", "w") as f:
    json.dump(res, f)
'''


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "ref.json"
    run_child(_REF_SPECS.format(out=out))
    with open(out) as f:
        return json.load(f)


def _port_flat(tree, prefix=""):
    """NamedShardings of a port spec tree keyed as the reference's flat
    paths (params as the reference's stacked tree, NamedTuple fields by
    name)."""
    out = {}
    if isinstance(tree, shd.NamedSharding):
        out[prefix.rstrip("/")] = tree.spec
    elif isinstance(tree, dict):
        if tree and all("." in k or k in ("tokens", "labels", "memory")
                        or isinstance(v, shd.NamedSharding)
                        for k, v in tree.items()) and any(
                "." in k for k in tree):
            tree = convert.to_reference_tree(
                tree, stack=lambda leaves: leaves[0])
        for k, v in tree.items():
            out.update(_port_flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        for i, v in zip(names, tree):
            if v is not None:
                out.update(_port_flat(v, f"{prefix}{i}/"))
    return out


def _compare(ours, ref):
    assert set(ours) == set(ref), sorted(set(ours) ^ set(ref))[:8]
    for k, spec in ref.items():
        stacked = any(f"/{s}/" in f"/{k}" for s in convert.STACKS)
        want = _norm(spec)
        got = _norm(ours[k])
        if stacked and len(want) == len(got) + 1:
            assert want[0] is None, (k, want)
            want = want[1:]
        n = max(len(want), len(got))
        assert _norm(got, n) == _norm(want, n), (k, got, want)


@pytest.fixture
def fake8():
    with dryrun.fake_world(8):
        yield


def _mesh(m: str):
    from torch.distributed.device_mesh import init_device_mesh
    if m == "2x4":
        return init_device_mesh("cpu", (2, 4), mesh_dim_names=("data",
                                                                "model"))
    return init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))


@pytest.mark.parametrize("m", ["2x4", "2x2x2"])
@pytest.mark.parametrize("arch", ["llama2_paper", "granite_moe_1b_a400m"])
def test_train_shardings_match_reference(ref_specs, fake8, m, arch):
    ins, _ = SP.train_shardings(C.get_reduced(arch), TRAIN, _mesh(m), 2)
    _compare(_port_flat(ins), ref_specs[f"train/{m}/{arch}"])


@pytest.mark.parametrize("m", ["2x4", "2x2x2"])
@pytest.mark.parametrize("arch", ["qwen2_7b", "mamba2_780m"])
def test_decode_shardings_match_reference(ref_specs, fake8, m, arch):
    cfg = C.get_reduced(arch)
    state = SP.decode_state_specs(cfg, DECODE)
    ins, outs = SP.serve_shardings(cfg, DECODE, _mesh(m), state)
    _compare(_port_flat((ins, outs)), ref_specs[f"decode/{m}/{arch}"])


@pytest.mark.parametrize("m", ["2x4", "2x2x2"])
def test_prefill_shardings_match_reference(ref_specs, fake8, m):
    ins, outs = SP.serve_shardings(C.get_reduced("llama2_paper"), PREFILL,
                                   _mesh(m))
    _compare(_port_flat((ins, outs)), ref_specs[f"prefill/{m}/llama2_paper"])


def test_sanitize_drops_undividable_dims(fake8):
    mesh = _mesh("2x4")
    spec = {"w": ("data", "model"), "v": (None, ("data", "model"))}
    sds = {"w": torch.empty(6, 8), "v": torch.empty(3, 12)}
    assert S.sanitize_specs(spec, sds, mesh) == {"w": ("data", "model"),
                                                  "v": (None, None)}


# ------------------------------------------------------------ dry run
@pytest.mark.parametrize("shape", [TRAIN, DECODE, PREFILL],
                         ids=lambda s: s.name)
def test_dryrun_cell_reduced_mesh(shape):
    """The reference's ``test_dryrun_cell_reduced_mesh``: reduced qwen2_7b
    on a (2, 4) fake mesh, status ok with flops and a peak per chip."""
    rec = dryrun.run_cell("qwen2_7b", shape.name, False, "none", None,
                          verbose=False, cfg=C.get_reduced("qwen2_7b"),
                          shape=shape, mesh_shape=MESH, device="cpu")
    assert rec["status"] == "ok", rec
    assert rec["chips"] == 8 and rec["device"] == "cpu"
    assert rec["roofline"]["flops_per_chip"] > 0
    assert rec["memory"]["peak_per_chip"] > rec["memory"]["static_bytes"] > 0
    assert rec["memory"]["hbm_budget_bytes"] == 85_017_493_504
    assert rec["memory"]["fits_hbm"]
    # 2 KV heads under a model dim of 4: each rank computes the KV head of
    # its query head, so attention is split as the rules split it; the
    # vocabulary splits too, so nothing is left whole
    dep = rec["departures"]
    assert dep["computed_whole_over_model"] == [], dep
    assert dep["ssm_bc_whole_bytes"] == 0
    assert dep["comparable_to_reference"]
    if shape.kind == "train":
        # the grads' reduce-scatter and the MLP's sum over `model`
        assert rec["roofline"]["collectives"]["reduce-scatter"] > 0
        assert rec["roofline"]["collectives"]["all-reduce"] > 0


def test_dryrun_chameleon_under_a_tight_budget(tmp_path):
    """Reduced llama2-paper at 512 tokens (activations outweigh the state)
    under a budget 3% of the dynamic peak below it: the Chameleon flow
    generates a swap policy per chip and the analytic device peak falls;
    the record lands in ``out_dir``.  (Lower budgets leave op ranges where
    only untagged temporaries, the plain attention's scores, are live: no
    policy clears them and the flow falls back to offload_all.)"""
    kw = dict(verbose=False, cfg=C.get_reduced("llama2_paper"),
              shape=ShapeConfig("train_4k", "train", 512, 8),
              mesh_shape=MESH, device="cpu")
    base = dryrun.run_cell("llama2_paper", "train_4k", False, "none", **kw)
    static = base["memory"]["static_bytes"]
    peak = base["memory"]["peak_per_chip"]
    budget = static + (peak - static) * 97 // 100
    rec = dryrun.run_cell("llama2_paper", "train_4k", False, "chameleon",
                          str(tmp_path), budget_bytes=budget, **kw)
    info = rec["policy_info"]
    assert info["policy"] == "chameleon", info
    assert info["swapped_bytes_per_chip"] > 0 and info["offload_sites"]
    assert rec["memory"]["device_peak_est"] < peak
    assert rec["memory"]["peak_per_chip"] == peak
    name = "llama2_paper__train_4k__single__chameleon.json"
    with open(tmp_path / name) as f:
        assert json.load(f)["policy_info"]["policy"] == "chameleon"


def test_dryrun_policies_and_rules():
    """remat recomputes (more flops, a lower peak); offload_all moves
    every candidate site; dp_only rules on a (2, 2, 2) mesh shard the
    batch over every dim and take no model-parallel sum."""
    kw = dict(verbose=False, cfg=C.get_reduced("llama2_paper"), shape=TRAIN,
              mesh_shape=MESH, device="cpu")
    none = dryrun.run_cell("llama2_paper", "train_4k", False, "none", **kw)
    remat = dryrun.run_cell("llama2_paper", "train_4k", False, "remat", **kw)
    assert (remat["roofline"]["flops_per_chip"]
            > none["roofline"]["flops_per_chip"])
    assert (remat["memory"]["peak_per_chip"]
            < none["memory"]["peak_per_chip"])
    off = dryrun.run_cell("llama2_paper", "train_4k", False, "offload_all",
                          **kw)
    assert "ffn_act" in off["policy_info"]["offload_sites"]
    kw["mesh_shape"] = MeshConfig((2, 2, 2), ("pod", "data", "model"))
    dp = dryrun.run_cell("llama2_paper", "train_4k", True, "none",
                         rules_name="dp_only", **kw)
    assert dp["status"] == "ok" and dp["zero_stage"] == 0
    # the rules shard the parameters at rest; the step gathers each unit's
    # as it runs it: comparable to the reference's, and never more alive
    # than two blocks' weights
    assert dp["departures"]["comparable_to_reference"]
    block = sum(p.numel() for n, p in S.abstract_params(
        C.get_reduced("llama2_paper")).items() if n.startswith("blocks.0."))
    assert 0 < dp["memory"]["gathered_peak_bytes"] <= 2 * 4 * block
    assert dp["roofline"]["collectives"].get("all-reduce", 0) == 0 or (
        dp["roofline"]["collectives"]["all-gather"] > 0)
    # with the vocabulary split too, TP over 4 of 2 x 4 chips and DP over
    # all 8 divide every product of the step alike
    assert dp["roofline"]["flops_per_chip"] == none["roofline"][
        "flops_per_chip"]


def test_fake_world_refuses_a_live_group():
    with dryrun.fake_world(2):
        with pytest.raises(RuntimeError, match="destroy"):
            with dryrun.fake_world(2):
                pass
    assert not torch.distributed.is_initialized()


# ------------------------------------------------- the fake-tensor rules
def test_kernel_shape_rules_take_fake_tensors_only():
    """K1's fake kernels, K3's and K4's shape rules on fake ``cuda``
    tensors: the outputs' shapes and dtypes, no launch counted; a real
    ``meta`` tensor still raises (``tests/test_torch_flash_*.py``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.ssd_scan import ops as sops
    before = (ops.flash_attention.launches, ops.flash_decode.launches,
              ops.flash_attention_bwd.launches)
    with FakeTensorMode():
        q = torch.empty(2, 16, 4, 64, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(2, 16, 2, 64, device="cuda", dtype=torch.bfloat16)
        o, lse = torch.ops.repro_torch.flash_attention_fwd(
            q, k, k, None, True, 0.125, True)
        assert o.shape == q.shape and o.dtype == q.dtype
        assert lse.shape == (2, 4, 16) and lse.dtype == torch.float32
        dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
            q, k, k, o, lse, o, None, True, 0.125)
        assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
        kc = torch.empty(2, 32, 2, 64, device="cuda", dtype=torch.bfloat16)
        q1 = torch.empty(2, 1, 4, 64, device="cuda", dtype=torch.bfloat16)
        d = ops.flash_decode(q1, kc, kc,
                             torch.ones(2, dtype=torch.int32, device="cuda"))
        assert d.shape == (2, 1, 4, 64) and d.device.type == "cuda"
        y, st = sops.ssd_scan(torch.empty(2, 64, 4, 16, device="cuda"),
                              torch.empty(2, 64, 4, device="cuda"),
                              torch.empty(4, device="cuda"),
                              torch.empty(2, 64, 8, device="cuda"),
                              torch.empty(2, 64, 8, device="cuda"))
        assert y.shape == (2, 64, 4, 16) and st.shape == (2, 4, 16, 8)
    assert (ops.flash_attention.launches, ops.flash_decode.launches,
            ops.flash_attention_bwd.launches) == before
    meta = torch.empty(1, 8, 2, 32, device="meta")
    with pytest.raises(RuntimeError):
        torch.ops.repro_torch.flash_attention_fwd(meta, meta, meta, None,
                                                  True, 0.125, False)


def test_abstract_state_allocates_nothing():
    """Full-width llama2-paper's parameters and AdamW state as fake
    tensors (26 GB if they were real)."""
    from torch._subclasses.fake_tensor import FakeTensor
    params, opt = S.abstract_train_state(C.get_config("llama2_paper"))
    assert all(isinstance(p, FakeTensor) for p in params.values())
    n = sum(p.numel() for p in params.values())
    assert n == C.get_config("llama2_paper").param_count()
    assert opt.master is not None and set(opt.m) == set(params)


@pytest.mark.parametrize("arch,mesh,whole,bc", [
    ("llama2_paper", (2, 4), [], False),
    ("qwen2_7b", (1, 8), [], False),
    ("mamba2_780m", (2, 4), [], True),
])
def test_dryrun_departures_name_what_remains(arch, mesh, whole, bc):
    """Under the default rules no departure remains where the model dim
    divides Mamba-2's 2 x ``ssm_state`` (``bc``: reduced mamba2's 32 over
    4): attention splits by head runs even where the model dim does not
    divide the query heads (reduced qwen2_7b's 4 over 8: ranks 0-3 a head
    each, wq, wo and bq still gathered at use), and the B / C channels split
    and are all-gathered after their convolution."""
    cfg = C.get_reduced(arch)
    rec = dryrun.run_cell(arch, "train_4k", False, "none", None,
                          verbose=False, cfg=cfg, shape=TRAIN,
                          mesh_shape=MeshConfig(mesh, ("data", "model")),
                          device="cpu")
    dep = rec["departures"]
    assert dep["computed_whole_over_model"] == whole
    assert dep["computed_whole_over_model_bytes"] == 0
    assert dep["ssm_bc_whole_bytes"] == 0
    assert dep["comparable_to_reference"]
    if cfg.num_heads % mesh[1]:
        assert rec["memory"]["gathered_peak_bytes"] > 0
    if bc:
        assert rec["roofline"]["collectives"]["all-gather"] > 0


def test_dryrun_departure_remains_where_bc_do_not_split():
    """Reduced mamba2 with ``ssm_state`` 5 on (2, 4): 2 x 5 B / C channels
    do not split over 4, so they stay whole on every rank, and the record
    names their bytes (each layer's in-projection columns and conv
    channels) and is not comparable."""
    cfg = C.get_reduced("mamba2_780m").replace(ssm_state=5)
    rec = dryrun.run_cell("mamba2_780m", "train_4k", False, "none", None,
                          verbose=False, cfg=cfg, shape=TRAIN,
                          mesh_shape=MESH, device="cpu")
    dep = rec["departures"]
    per_layer = 2 * cfg.ssm_state * (cfg.d_model + cfg.ssm_conv_width + 1) * 4
    assert dep["ssm_bc_whole_bytes"] == cfg.num_layers * per_layer
    assert dep["computed_whole_over_model"] == []
    assert not dep["comparable_to_reference"]


def test_dryrun_flops_follow_the_heads_a_rank_computes():
    """Reduced qwen2_7b (4 query over 2 KV heads) on (1, 8): rank 0, the
    rank traced, computes ceil(4 / 8) = 1 query head and the 1 KV head it
    reads, and an eighth of everything else (the MLP, the vocabulary).  Its
    flops equal the unsharded cell's with the work that scales with the
    query heads (a) and with the KV heads (b) taken out, divided by the
    chips, and 1 head of each added back; a and b come from unsharded
    cells with 8 query heads and with 4 KV heads."""
    base = C.get_reduced("qwen2_7b")

    def flops(chips, **over):
        rec = dryrun.run_cell("qwen2_7b", "train_4k", False, "none", None,
                              verbose=False, cfg=base.replace(**over),
                              shape=TRAIN, device="cpu",
                              mesh_shape=MeshConfig((1, chips),
                                                    ("data", "model")))
        return rec["roofline"]["flops_per_chip"]

    H, Kh, tp = base.num_heads, base.num_kv_heads, 8
    one = flops(1)
    a = (flops(1, num_heads=2 * H) - one) / H
    b = (flops(1, num_kv_heads=2 * Kh) - one) / Kh
    assert a > 0 and b > 0
    want = (one - a * H - b * Kh) / tp + a * -(-H // tp) + b * 1
    assert flops(tp) == pytest.approx(want, rel=1e-9)
    # against the model dim dividing the heads' share evenly: rank 0 does
    # ceil(H / tp) * tp / H times its even share of the query heads' work
    assert flops(tp) > (one - b * Kh) / tp


@pytest.mark.parametrize("rules", ["default", "dp_only"])
def test_dryrun_cell_leaves_no_tensor_alive(rules):
    """A cell's sharded model, its hooks (gathering at use, gradients to
    their layout) and its fake tensors are all freed once the cell
    returns: a tensor kept alive would inflate a later CPU profile's
    static base (``core.profiler``), as one did before the hooks held the
    model weakly."""
    import gc
    from torch._subclasses.fake_tensor import FakeTensor

    def fakes():
        gc.collect()
        return sum(isinstance(o, FakeTensor) for o in gc.get_objects())

    before = fakes()
    rec = dryrun.run_cell("llama2_paper", "train_4k", False, "none", None,
                          verbose=False, cfg=C.get_reduced("llama2_paper"),
                          shape=TRAIN, mesh_shape=MESH, device="cpu",
                          rules_name=rules)
    assert rec["status"] == "ok"
    assert fakes() == before
