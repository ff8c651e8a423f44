"""The port's distributed slice (``repro_torch.distributed``, ``launch.mesh``,
the checkpoint manager's sharded save and elastic restore, the train CLI's
``--multihost``) against the reference, on the CPU.

Every multi-rank case runs in gloo child processes, one per rank, that meet
through a ``FileStore`` in the test's ``tmp_path`` (no port is fixed, so
xdist workers never collide); each child has its own timeout (``run_ranks``)
and rank 0 writes what the test reads back.  The reference runs in the
test process on one device, or in a JAX child with host devices where it
needs a mesh (``tests/conftest.py``'s ``run_child``).

Bars: the sharded train step against the port's unsharded step, loss rtol
1e-5 and every parameter rtol 2e-3 / atol 2e-4 (the reference's
``test_sharded_train_step_matches_single_device``); against the reference's
jitted single-device step from the same weights, the loss rtol 1e-5 and
every parameter within ``tests/test_torch_training.py``'s trainer bar
(rtol 2e-4, atol 2e-4); the compressed sync within 5% of the true mean
(the reference's bound) and within 1e-6 relative of the reference's sync
on the same inputs (its residuals relative to the rows they quantize);
``apply_moe_ep`` within 1e-5 of the reference's (f32).
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as RC
from repro.common.config import TrainConfig as RTrainConfig
from repro.distributed import steps as RS
from repro.models.registry import get_api as ref_get_api
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.models import convert

from conftest import run_child

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CHILD_TIMEOUT = 240
# the ranks' own limit on the group's rendezvous (and each collective),
# inside the parent's CHILD_TIMEOUT: a rank that cannot meet the others
# under a loaded host fails with gloo's own timeout and message instead of
# being killed from outside with the rest
RENDEZVOUS_TIMEOUT = 180

_PRELUDE = '''
import datetime, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK = int(os.environ["RANK"])
WORLD = int(os.environ["WORLD_SIZE"])
OUT = os.environ["OUT"]
dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                        rank=RANK, world_size=WORLD,
                        timeout=datetime.timedelta(
                            seconds=float(os.environ["RENDEZVOUS_TIMEOUT"])))
'''
# every rank leaves the group together: a rank that closes its sockets
# while a slower peer is still inside the last collective makes gloo
# reset that peer's connection, which aborts the peer's process
_EPILOGUE = """
dist.barrier()
dist.destroy_process_group()
"""


def run_ranks(code: str, world: int, tmp_path, timeout: int = CHILD_TIMEOUT
              ) -> list:
    """Run ``code`` in ``world`` gloo ranks (the prelude joins the group;
    ``OUT`` is ``tmp_path``); returns every rank's stdout.  A rank that
    fails or outlives ``timeout`` fails the test, and every rank is
    stopped."""
    store = os.path.join(str(tmp_path), "store")
    if os.path.exists(store):
        os.remove(store)
    body = _PRELUDE + textwrap.dedent(code) + _EPILOGUE
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   STORE=store, OUT=str(tmp_path), PYTHONPATH=SRC,
                   OMP_NUM_THREADS="1",
                   RENDEZVOUS_TIMEOUT=str(RENDEZVOUS_TIMEOUT))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", body], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}\n"
                                 f"STDOUT:\n{o}\nSTDERR:\n{e[-4000:]}")
    return [o for o, _ in outs]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------ the sharded step
_STEP = '''
import repro_torch.configs as C
from repro_torch.common.config import TrainConfig
from repro_torch.distributed import sharding as shd, steps as S
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import convert
from repro_torch.optim.adamw import adamw_init
cfg = C.get_reduced(ARCH).replace(**OVER)
ref = dict(np.load(os.path.join(OUT, "ref.npz")))
params = {k[2:]: v for k, v in ref.items() if k.startswith("p/")}
batch = {k[2:]: torch.as_tensor(v, dtype=torch.int64 if k != "b/memory"
                                else torch.float32)
         for k, v in ref.items() if k.startswith("b/")}
tcfg = TrainConfig(warmup_steps=0)

def fresh():
    m = convert.params_from_reference(cfg, convert_tree(params),
                                      device="cpu")
    return m, adamw_init(m)

def convert_tree(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree

m1, o1 = fresh()
m1, o1, r1 = S.make_train_step(cfg, tcfg)(m1, o1, batch, 1.0)
mesh = make_test_mesh(SHAPE, AXES)
rules = RULES
m2, o2 = fresh()
sm, so = S.shard_model(cfg, m2, mesh, o2, zero_stage=ZERO, rules=rules)
gsh = S.to_shardings({n: lay.opt for n, lay in sm.layouts.items()}, mesh)
step = S.make_train_step(cfg, tcfg, grad_shardings=gsh)
sm, so, r2 = step(sm, so, S.shard_batch(batch, mesh, rules), 1.0)
full = {n: t.full_tensor().numpy() for n, t in sm.params().items()}
sharded_dims = sorted({n for n, lay in sm.layouts.items()
                       if lay.dp_param is not None or lay.dp_opt is not None
                       or lay.tp_dim is not None})
name_of = {id(p): n for n, p in sm.module.named_parameters()}
unit_bytes = [sum(p.numel() * p.element_size() for p in ps
                  if name_of[id(p)] in sm.shards)
              for _, ps in S._units(sm.module)]
attrs = lambda pred: sorted({n.rpartition(".")[2]
                             for n, lay in sm.layouts.items() if pred(lay)})
if RANK == 0:
    np.savez(os.path.join(OUT, "out.npz"),
             **{"full/" + n: v for n, v in full.items()},
             **{"unsharded/" + n: p.detach().numpy()
                for n, p in m1.named_parameters()})
    with open(os.path.join(OUT, "out.json"), "w") as f:
        json.dump({"loss": float(r2["loss"]), "loss1": float(r1["loss"]),
                   "gnorm": float(r2["grad_norm"]),
                   "gnorm1": float(r1["grad_norm"]),
                   "blocks": sorted(sm.plan.blocks),
                   "tp_sum": sorted(n for n, lay in sm.layouts.items()
                                    if lay.tp_sum),
                   "sharded": sharded_dims,
                   "dp_rest": sum(lay.dp_param is not None
                                  for n, lay in sm.layouts.items()
                                  if n in sm.shards),
                   "gather_tp": attrs(lambda lay: lay.gather_tp),
                   "runs": attrs(lambda lay: lay.runs is not None),
                   "split_model": attrs(lambda lay: lay.tp_dim is not None),
                   "local_shapes": {n: list(p.shape) for n, p in
                                    sm.module.named_parameters()},
                   "q_run": sm.plan.q,
                   "kv_run": sm.plan.kv,
                   "local_heads": [sm.local_cfg.num_heads,
                                   sm.local_cfg.num_kv_heads],
                   "peak_gathered": sm.peak_gathered_bytes,
                   "gathered_now": sm.gathered_bytes,
                   "unit_max": max(unit_bytes),
                   "rest_total": sum(unit_bytes)}, f)
'''

# case -> (arch, mesh, axes, ZeRO stage, rules, global batch, tokens a
# row[, config fields replaced in both packages]); "kv_slice": reduced
# qwen2_7b's 2 KV heads (and their biases) under a model dim of 4, each rank
# computing the one KV head its query head uses; "vocab": llama2_paper's
# 512 rows of ``tok`` and columns of ``unembed``, 128 a rank; "ssm_tp":
# reduced mamba2_780m (tied) with its 8 SSM heads 2 a rank and its 2 x 16
# B / C channels 8 a rank, at 8 tokens (F5: the reference's scan has NaN
# gradients from 16); "ssm_bc_whole": 6 SSM heads 2 a rank on (1, 3), where
# 2 x 4 B / C channels do not split over 3 and stay whole; "router":
# reduced granite-moe on (1, 4), its router split at rest over ``model``
# and gathered at use (one data rank: the expert-parallel layer routes,
# drops and balances over the local tokens, as the reference's does, so
# only there is it the single-device step); "heads_whole": reduced qwen2_7b
# on (1, 8), where 4 query heads do not divide 8 but the fused q_dim (64)
# does: ranks 0-3 a head each, 4-7 none; "heads_straddle": 6 query heads
# over 2 KV heads on (1, 4), runs of 2, 2, 1, 1 (rank 1's two heads read
# both KV heads); "heads_repeat": 9 over 3 on (2, 2) under ZeRO 3, runs of
# 5 and 4 whose KV heads repeat (0, 0, 0, 1, 1 and 1, 2, 2, 2); "whisper":
# reduced whisper with 6 heads on (1, 4) (encoder, decoder and
# cross-attention; every xgate open)
_MESHES = {
    "zero2": ("llama2_paper", (2, 4), ("data", "model"), 2, None, 4, 32),
    "kv_slice": ("qwen2_7b", (2, 4), ("data", "model"), 2, None, 4, 32),
    "zero3": ("llama2_paper", (2, 4), ("data", "model"), 3, None, 4, 32),
    "dp_only": ("llama2_paper", (2, 4), ("data", "model"), 0,
                "DP_ONLY_RULES", 8, 32),
    "pod_mesh": ("llama2_paper", (2, 2, 2), ("pod", "data", "model"), 2,
                 None, 4, 32),
    "vocab": ("llama2_paper", (2, 4), ("data", "model"), 1, None, 4, 32),
    "ssm_tp": ("mamba2_780m", (2, 4), ("data", "model"), 2, None, 4, 8),
    "router": ("granite_moe_1b_a400m", (1, 4), ("data", "model"), 2, None,
               4, 32),
    "heads_whole": ("qwen2_7b", (1, 8), ("data", "model"), 2, None, 2, 32),
    "heads_straddle": ("qwen2_7b", (1, 4), ("data", "model"), 2, None, 2,
                       32, {"num_heads": 6, "num_kv_heads": 2}),
    "heads_repeat": ("qwen2_7b", (2, 2), ("data", "model"), 3, None, 4, 32,
                     {"num_heads": 9, "num_kv_heads": 3}),
    "whisper": ("whisper_large_v3", (1, 4), ("data", "model"), 2, None, 2,
                16, {"num_heads": 6, "num_kv_heads": 6}),
    "ssm_bc_whole": ("mamba2_780m", (1, 3), ("data", "model"), 2, None, 3,
                     8, {"d_model": 48, "ssm_state": 4}),
}
_QKV = ["bk", "bq", "bv", "wk", "wo", "wq", "wv"]
_Q_GATHERED = ["bq", "wo", "wq"]
# what each case's layouts split over ``model``: (TP blocks, attributes
# gathered at use, attributes with whole runs, attributes summed over it)
_SPLITS = {
    "kv_slice": (["attn", "mlp", "vocab"], [], [], ["bk", "bv", "wk", "wv"]),
    "ssm_tp": (["ssm", "ssm_bc", "vocab"], [],
               ["conv_b", "conv_w", "in_proj"], []),
    "ssm_bc_whole": (["ssm"], [], ["conv_b", "conv_w", "in_proj"], []),
    "router": (["attn", "mlp", "moe", "vocab"], ["router"], [],
               ["wk", "wv"]),
    "heads_whole": (["attn", "mlp", "vocab"], _Q_GATHERED, [], _QKV),
    "heads_straddle": (["attn", "mlp", "vocab"], _Q_GATHERED, [], _QKV),
    "heads_repeat": (["attn", "mlp", "vocab"], _Q_GATHERED, [], _QKV),
    "whisper": (["attn", "mlp", "vocab"], _Q_GATHERED, [], _QKV),
}


def _open_gates(params):
    """The reference's parameter tree with every ``xgate`` set off its init
    (0 shuts the cross-attention out of the output and its gradients)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.full_like(a, 0.6)
                         if getattr(path[-1], "key", None) == "xgate"
                         else a), params)


def _reference_step(arch: str, batch_size: int, seq: int = 32,
                    over: dict = None):
    """The reference's jitted single-device step on the reduced ``arch``
    with ``over`` replaced: (initial params, batch, new params, loss, grad
    norm).  An encdec batch carries ``memory`` and its gates are open."""
    cfg = RC.get_reduced(arch).replace(**(over or {}))
    params = _open_gates(ref_get_api(cfg).init(cfg, jax.random.PRNGKey(0))[0])
    opt = ref_adamw_init(params)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1), 3)
    batch = {"tokens": jax.random.randint(k1, (batch_size, seq), 0,
                                          cfg.vocab_size),
             "labels": jax.random.randint(k2, (batch_size, seq), 0,
                                          cfg.vocab_size)}
    if cfg.family == "encdec":
        batch["memory"] = jax.random.normal(
            k3, (batch_size, cfg.encoder_seq, cfg.d_model), jnp.float32)
    step = RS.make_train_step(cfg, RTrainConfig(warmup_steps=0))
    p1, _, m1 = jax.jit(step)(params, opt, batch, jnp.float32(1.0))
    return (_np(params), _np(batch), _np(p1), float(m1["loss"]),
            float(m1["grad_norm"]))


@pytest.mark.parametrize("case", sorted(_MESHES))
def test_sharded_train_step_matches_unsharded_and_reference(tmp_path, case):
    arch, shape, axes, zero, rules, B, seq = _MESHES[case][:7]
    over = _MESHES[case][7] if len(_MESHES[case]) > 7 else {}
    params, batch, ref_new, ref_loss, ref_gnorm = _reference_step(
        arch, B, seq, over)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"p/{prefix}{k}"] = v
    walk(params, "")
    np.savez(tmp_path / "ref.npz", **flat,
             **{f"b/{k}": v for k, v in batch.items()})
    code = (_STEP.replace("SHAPE", repr(shape)).replace("AXES", repr(axes))
            .replace("ZERO", str(zero)).replace("ARCH", repr(arch))
            .replace("OVER", repr(over))
            .replace("RULES", f"shd.{rules}" if rules else "None"))
    run_ranks(code, int(np.prod(shape)), tmp_path)
    with open(tmp_path / "out.json") as f:
        info = json.load(f)
    out = dict(np.load(tmp_path / "out.npz"))
    np.testing.assert_allclose(info["loss"], info["loss1"], rtol=1e-5)
    np.testing.assert_allclose(info["loss"], ref_loss, rtol=1e-5)
    # Adam's first update is about lr * sign(g): the norm is what sees a
    # gradient scaled wrong (a missing mean, a sum counted twice)
    np.testing.assert_allclose(info["gnorm"], info["gnorm1"], rtol=1e-5)
    np.testing.assert_allclose(info["gnorm"], ref_gnorm, rtol=1e-5)
    ref_named = convert.from_reference_tree(ref_new)
    for n, v in ref_named.items():
        full = out["full/" + n]
        np.testing.assert_allclose(full, out["unsharded/" + n], rtol=2e-3,
                                   atol=2e-4, err_msg=n)
        np.testing.assert_allclose(full, np.asarray(v), rtol=2e-4,
                                   atol=2e-4, err_msg=n)
    # the layouts really split something: TP under the default rules (the
    # vocabulary too), parameters at rest under ZeRO 3 and dp_only
    assert info["sharded"]
    blocks, gather, runs, summed = _SPLITS.get(
        case, (["attn", "mlp", "vocab"] if rules is None else [], [], [], []))
    assert info["blocks"] == blocks
    assert info["gather_tp"] == gather and info["runs"] == runs
    assert sorted({n.rpartition(".")[2] for n in info["tp_sum"]}) == summed
    cfg = RC.get_reduced(arch).replace(**over)
    tp = shape[-1]
    if "vocab" in blocks:
        assert {"tok", "unembed"} & set(info["split_model"])
        assert info["local_shapes"]["embed.tok"][0] == cfg.vocab_size // tp
    if "ssm" in blocks:
        # each rank its heads' x channels, and its slice of B / C where
        # the model dim divides them
        ch = cfg.ssm_expand * cfg.d_model // tp
        bc = 2 * cfg.ssm_state // (tp if "ssm_bc" in blocks else 1)
        assert info["local_shapes"]["blocks.0.ssm.conv_w"][1] == ch + bc
        assert info["local_shapes"]["blocks.0.ssm.A_log"] == [
            cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim // tp]
    if info["q_run"] is not None:
        # rank 0 computes the longest run of query heads and the KV heads
        # they read: ceil(H / tp) of the model's H, where the model dim does
        # not divide them
        H, Kh = cfg.num_heads, cfg.num_kv_heads
        assert H % tp
        assert info["q_run"] == [0, -(-H // tp)]
        assert info["local_heads"] == [-(-H // tp), len(info["kv_run"])]
        assert info["kv_run"] == sorted(info["kv_run"])
    # ZeRO 3 gathers at use, a unit at a time: never more alive than the
    # largest unit's weights and one more unit's, and none after the step
    assert (info["dp_rest"] > 0) == (zero >= 3 or rules is not None)
    assert info["gathered_now"] == 0
    if info["dp_rest"] or gather:
        assert 0 < info["peak_gathered"] <= 2 * info["unit_max"], info
        assert info["peak_gathered"] < info["rest_total"], info
    else:
        assert info["peak_gathered"] == 0


@pytest.mark.parametrize("mode", ["plain", "remat", "policy"])
def test_zero3_gather_at_use_is_bit_exact(tmp_path, mode):
    """ZeRO 3 over two data ranks that both see the whole batch (so every
    reduction is exact: x + x, then / 2) against the unsharded step, two
    steps, no clipping: the losses and every parameter bit for bit.  Each
    unit's weights are gathered into their own freed storage and freed
    again, in the forward and (regathered) in the backward; with every
    block recomputed in the backward (``remat``), and with both steps
    under the executor's conservative policy (``policy``: the weights are
    no swap candidates, every staged byte comes back).  Between steps no
    weight is gathered and every parameter's storage is empty."""
    run_ranks(f'''
import contextlib
import repro_torch.configs as C
from repro_torch.common.config import ChameleonConfig, TrainConfig
from repro_torch.core.executor import Executor
from repro_torch.distributed import steps as S
from repro_torch.hostmem import HostMemTier
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import adamw_init
cfg = C.get_reduced("llama2_paper")
tcfg = TrainConfig(warmup_steps=0, grad_clip=1e30)
g = torch.Generator().manual_seed(0)
batch = {{k: torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
         for k in ("tokens", "labels")}}
ctx = dryrun._full_remat if "{mode}" == "remat" else contextlib.nullcontext
pol = None
if "{mode}" == "policy":
    eng = HostMemTier(device="cpu").engine
    x = Executor(ChameleonConfig())
    pol = x.execution(x.conservative(None), eng, None)

def fresh():
    m = get_api(cfg).init(cfg, seed=0, device="cpu")
    return m, adamw_init(m)

m1, o1 = fresh()
step1 = S.make_train_step(cfg, tcfg, pol)
mesh = make_test_mesh((2,), ("data",))
m2, o2 = fresh()
sm, so = S.shard_model(cfg, m2, mesh, o2, zero_stage=3)
gsh = S.to_shardings({{n: l.opt for n, l in sm.layouts.items()}}, mesh)
step2 = S.make_train_step(cfg, tcfg, pol, grad_shardings=gsh)
assert sm.shards and len(sm.shards) == len(sm.layouts) - sum(
    l.dp_param is None for l in sm.layouts.values())
for _ in range(2):
    with ctx():
        m1, o1, r1 = step1(m1, o1, batch, 1.0)
        sm, so, r2 = step2(sm, so, batch, 1.0)
    assert torch.equal(r1["loss"], r2["loss"]), (r1["loss"], r2["loss"])
    assert sm.gathered_bytes == 0 and sm.peak_gathered_bytes > 0
    assert all(p.untyped_storage().nbytes() == 0
               for n, p in sm.module.named_parameters() if n in sm.shards)
full = {{n: t.full_tensor() for n, t in sm.params().items()}}
for n, p in m1.named_parameters():
    assert torch.equal(full[n], p.detach()), n
if pol is not None:
    c = eng.by_class["policy_swap"]
    assert c.bytes_out == c.bytes_in > 0 and eng.pool.bytes_in_use == 0
''', 2, tmp_path)


def test_conservative_policy_on_mesh_keeps_losses(tmp_path):
    """The executor's conservative execution under the sharded step (2, 4):
    the losses of two steps equal those without it, and every byte staged
    out comes back."""
    run_ranks('''
import repro_torch.configs as C
from repro_torch.common.config import ChameleonConfig, TrainConfig
from repro_torch.core.executor import Executor
from repro_torch.distributed import steps as S
from repro_torch.hostmem import HostMemTier
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import adamw_init
cfg = C.get_reduced("llama2_paper")
mesh = make_test_mesh((2, 4))
g = torch.Generator().manual_seed(0)
batch = {k: torch.randint(0, cfg.vocab_size, (4, 32), generator=g)
         for k in ("tokens", "labels")}
local = S.shard_batch(batch, mesh)

def run(policy):
    m = get_api(cfg).init(cfg, seed=0, device="cpu")
    sm, so = S.shard_model(cfg, m, mesh, adamw_init(m), zero_stage=2)
    gsh = S.to_shardings({n: l.opt for n, l in sm.layouts.items()}, mesh)
    step = S.make_train_step(cfg, TrainConfig(), policy, grad_shardings=gsh)
    losses = []
    for _ in range(2):
        sm, so, r = step(sm, so, local, 1.0)
        losses.append(float(r["loss"]))
    return losses

eng = HostMemTier(device="cpu").engine
x = Executor(ChameleonConfig())
pol = x.execution(x.conservative(None), eng, None)
c0 = eng.by_class["policy_swap"].as_dict()
with_policy = run(pol)
c1 = eng.by_class["policy_swap"].as_dict()
without = run(None)
out = c1["bytes_out"] - c0["bytes_out"]
back = c1["bytes_in"] - c0["bytes_in"]
assert with_policy == without, (with_policy, without)
assert out == back > 0, (out, back)
assert eng.pool.bytes_in_use == 0
''', 8, tmp_path)


# ---------------------------------------------------- compressed sync
_REF_SYNC = '''
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed.compression import make_compressed_grad_sync
from repro.distributed.sharding import shard_map
from repro.launch.mesh import make_test_mesh
mesh = make_test_mesh((4, 2), ('pod', 'model'))
sync = make_compressed_grad_sync(mesh, 'pod')
d = np.load('{path}')
sm = shard_map(lambda g, e: sync({{'w': g}}, {{'w': e}}), mesh=mesh,
               in_specs=(P('pod', None), P('pod', None)),
               out_specs=(P('pod', None), P('pod', None)))
s, e = jax.jit(sm)(jnp.asarray(d['g']), jnp.asarray(d['e']))
np.savez('{out}', synced=np.asarray(s['w']), err=np.asarray(e['w']))
'''


@pytest.mark.parametrize("feedback", ["zero", "carried"])
def test_compressed_sync_int8_on_wire_matches_reference(tmp_path, feedback):
    """(4, 2) ("pod", "model"): each pod's rows quantized to int8, the
    payload all-gathered as int8, the mean within 5% of the true mean and
    within 1e-6 of the reference's sync on the same g and e."""
    rs = np.random.RandomState(0)
    g = rs.randn(8, 64).astype(np.float32)
    e = (np.zeros_like(g) if feedback == "zero"
         else (0.01 * rs.randn(8, 64)).astype(np.float32))
    np.savez(tmp_path / "in.npz", g=g, e=e)
    run_child(_REF_SYNC.format(path=tmp_path / "in.npz",
                               out=tmp_path / "ref.npz"))
    run_ranks('''
from repro_torch.distributed import compression
from repro_torch.launch.mesh import make_test_mesh
mesh = make_test_mesh((4, 2), ("pod", "model"))
pod = mesh.get_coordinate()[0]
d = np.load(os.path.join(OUT, "in.npz"))
g = torch.from_numpy(d["g"][2 * pod:2 * pod + 2])
e = torch.from_numpy(d["e"][2 * pod:2 * pod + 2])
sync = compression.make_compressed_grad_sync(mesh, "pod")
s, ne = sync({"w": g}, {"w": e})
assert compression.stats["payload_dtype"] == torch.int8
assert compression.stats["payload_bytes"] == 4 * g.numel()
total = compression.compressed_psum_tree({"w": g}, "pod", mesh)["w"]
np.save(os.path.join(OUT, f"r{RANK}.npy"),
        np.stack([s["w"].numpy(), ne["w"].numpy(), total.numpy()]))
''', 8, tmp_path)
    ref = np.load(tmp_path / "ref.npz")
    true_mean = g.reshape(4, 2, 64).mean(axis=0)
    for r in range(8):
        pod = r // 2
        s, ne, total = np.load(tmp_path / f"r{r}.npy")
        rows = slice(2 * pod, 2 * pod + 2)
        if feedback == "zero":
            rel = np.abs(s - true_mean).max() / np.abs(true_mean).max()
            assert rel < 0.05, rel
            np.testing.assert_allclose(total / 4, s, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(s, ref["synced"][rows], rtol=1e-6,
                                   atol=1e-6 * np.abs(ref["synced"]).max())
        # the residual x - q * s is a difference of nearly equal numbers
        # (XLA rounds it once, fused): relative to the rows it quantizes
        np.testing.assert_allclose(ne, ref["err"][rows], rtol=1e-6,
                                   atol=1e-6 * np.abs(g + e).max())


# ---------------------------------------------------- elastic restore
def test_elastic_restore_new_mesh(tmp_path):
    """Saved under (4, 2), restored under (2, 2): equal values, the new
    mesh's placements; and the reference restores the sharded save on one
    device."""
    ck = tmp_path / "ckpt"
    run_ranks(f'''
from torch.distributed.tensor import DTensor
from repro_torch.checkpointing.manager import CheckpointManager
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_test_mesh
mesh = make_test_mesh((4, 2))
w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
pl = shd.NamedSharding(mesh, ("data", "model")).placements
t = DTensor.from_local(shd.local_chunk(w, mesh, pl).clone(), mesh, pl,
                       run_check=False)
mgr = CheckpointManager("{ck}", keep=2)
mgr.save(1, {{"params": {{"w": t}}}}, extra={{"step": 1}}, block=True)
''', 8, tmp_path)
    # the global array written once, by process 0
    assert sorted(os.listdir(ck / "step_00000001")) == [
        "manifest.p0.json", "params.p0.npz"]
    run_ranks(f'''
from torch.distributed.tensor import DTensor
from repro_torch.checkpointing.manager import CheckpointManager
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_test_mesh
mesh = make_test_mesh((2, 2))         # a smaller cluster after a failure
sh = shd.NamedSharding(mesh, ("data", "model"))
w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
mgr = CheckpointManager("{ck}", keep=2)
out, extra = mgr.restore(1, {{"params": {{"w": w}}}},
                         shardings={{"params": {{"w": sh}}}})
t = out["params"]["w"]
assert isinstance(t, DTensor) and t.device_mesh is mesh
assert list(t.placements) == sh.placements
assert tuple(t.to_local().shape) == (4, 4)
assert torch.equal(t.full_tensor(), w) and extra == {{"step": 1}}
''', 4, tmp_path)
    from repro.checkpointing.manager import CheckpointManager as RMgr
    tmpl = {"w": jnp.zeros((8, 8), jnp.float32)}
    out, _ = RMgr(str(ck), keep=2, process_index=0).restore(
        1, {"params": tmpl})
    want = np.arange(64, dtype=np.float32).reshape(8, 8)
    np.testing.assert_array_equal(np.asarray(out["params"]["w"]), want)


# ------------------------------------------------------- apply_moe_ep
_REF_MOE = '''
import jax, jax.numpy as jnp, numpy as np
import repro.configs as C
from repro.distributed import sharding as shd
from repro.launch.mesh import make_test_mesh
from repro.models.moe import apply_moe_ep
d = np.load('{path}')
cfg = C.get_reduced('granite_moe_1b_a400m')
p = {{k: jnp.asarray(d[k]) for k in ('router', 'wi_gate', 'wi_up', 'wo')}}
mesh = make_test_mesh((2, 2))
with shd.use_mesh(mesh):
    out, aux = jax.jit(lambda p, x: apply_moe_ep(cfg, p, x))(
        p, jnp.asarray(d['x']))
np.savez('{out}', out=np.asarray(out), aux=np.asarray(aux))
'''


def test_apply_moe_ep_matches_reference(tmp_path):
    """(2, 2) mesh: each (data) rank routes its half of the batch, each
    model rank runs 4 of the 8 experts; out and aux within 1e-5 of the
    reference's expert-parallel layer on the same weights and input."""
    cfg = RC.get_reduced("granite_moe_1b_a400m")
    rs = np.random.RandomState(0)
    E, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    w = {"router": rs.randn(d, E) / np.sqrt(d),
         "wi_gate": rs.randn(E, d, f) / np.sqrt(d),
         "wi_up": rs.randn(E, d, f) / np.sqrt(d),
         "wo": rs.randn(E, f, d) / np.sqrt(f),
         "x": rs.randn(4, 8, d)}
    np.savez(tmp_path / "in.npz",
             **{k: v.astype(np.float32) for k, v in w.items()})
    run_child(_REF_MOE.format(path=tmp_path / "in.npz",
                              out=tmp_path / "ref.npz"), devices=4)
    run_ranks('''
import repro_torch.configs as C
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import moe
cfg = C.get_reduced("granite_moe_1b_a400m")
d = np.load(os.path.join(OUT, "in.npz"))
mesh = make_test_mesh((2, 2))
dp, tp = mesh.get_coordinate()
layer = moe.Moe(cfg, generator=None, device=torch.device("cpu"))
E_loc = cfg.num_experts // 2
with torch.no_grad():
    layer.router.copy_(torch.from_numpy(d["router"]))
    for k in ("wi_gate", "wi_up", "wo"):
        setattr(layer, k, torch.nn.Parameter(torch.from_numpy(
            d[k][tp * E_loc:(tp + 1) * E_loc].copy())))
    x = torch.from_numpy(d["x"][2 * dp:2 * dp + 2])
    with shd.use_mesh(mesh):
        out, aux = moe.apply_moe_auto(cfg, layer, x)
np.save(os.path.join(OUT, f"r{RANK}.npy"), out.numpy())
np.save(os.path.join(OUT, f"aux{RANK}.npy"), aux.numpy())
''', 4, tmp_path)
    ref = np.load(tmp_path / "ref.npz")
    for r in range(4):
        dp = r // 2
        np.testing.assert_allclose(np.load(tmp_path / f"r{r}.npy"),
                                   ref["out"][2 * dp:2 * dp + 2],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.load(tmp_path / f"aux{r}.npy"),
                                   ref["aux"], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the CLI
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_multihost_two_ranks(tmp_path):
    """``--multihost`` on two gloo ranks from torchrun's environment:
    reduced llama2-paper, 3 steps, each host drawing its own slice of the
    global batch."""
    port = _free_port()
    code = textwrap.dedent(f'''
        import json, sys
        from repro_torch.launch import train
        out = train.main(["--reduced", "--device", "cpu", "--no-chameleon",
                          "--steps", "3", "--seq", "32", "--global-batch",
                          "4", "--multihost", "--ckpt-dir",
                          "{tmp_path}/ck" + sys.argv[1]])
        print(json.dumps({{"host": out["host"], "losses": out["losses"]}}))
    ''')
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(r)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    runs = []
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-3000:]
        runs.append(json.loads(o.strip().splitlines()[-1]))
    assert [r["host"] for r in runs] == [[0, 2], [1, 2]]
    assert all(len(r["losses"]) == 3 and np.isfinite(r["losses"]).all()
               for r in runs)
    # each host trained on its own half of the batch
    assert runs[0]["losses"] != runs[1]["losses"]


def test_train_cli_mesh_single_needs_256_ranks(tmp_path):
    """``--mesh single`` in a world of one (``--multihost``, one gloo rank)
    raises, naming the 256 ranks the production mesh needs, and leaves the
    process group."""
    code = textwrap.dedent(f'''
        import torch.distributed as dist
        from repro_torch.launch import train
        try:
            train.main(["--reduced", "--device", "cpu", "--no-chameleon",
                        "--multihost", "--mesh", "single", "--ckpt-dir",
                        "{tmp_path}/ck"])
        except RuntimeError as e:
            assert "256" in str(e), e
            assert not dist.is_initialized()
            print("RAISED")
    ''')
    env = dict(os.environ, RANK="0", WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=CHILD_TIMEOUT)
    assert r.returncode == 0 and "RAISED" in r.stdout, r.stderr[-3000:]


# ------------------------------------------------ the vocab-parallel loss
@pytest.mark.parametrize("tied,softcap", [(False, 0.0), (True, 30.0)])
def test_vocab_parallel_loss_matches_cross_entropy(tmp_path, tied, softcap):
    """Four model ranks, each holding 8 of 32 vocabulary rows: the
    embedding (local rows, summed), the unembedding (local columns,
    soft-capped) and the vocab-parallel loss, labels on every rank's range
    edges and a mask, against ``embed_tokens`` / ``unembed`` /
    ``cross_entropy`` on the whole vocabulary: the loss within 1e-6, the
    gradients of x and of this rank's rows within 1e-5."""
    run_ranks(f'''
import repro_torch.configs as C
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
cfg = C.get_reduced("llama2_paper").replace(
    vocab_size=32, tie_embeddings={tied}, logits_softcap={softcap})
g = torch.Generator().manual_seed(0)
full = L.Embedding(cfg, generator=g, device=torch.device("cpu"))
x0 = torch.randn(2, 8, cfg.d_model, generator=g)
edges = torch.tensor([0, 7, 8, 15, 16, 23, 24, 31])
labels = torch.stack([edges, edges.flip(0)])
tokens = labels.roll(1, 1)
mask = torch.ones(2, 8)
mask[1, :3] = 0

def run(p, plan):
    x = x0.clone().requires_grad_(True)
    with shd.local_tp(plan):
        h = L.embed_tokens(cfg, p, tokens)
        logits = L.unembed(cfg, p, x + h)
        loss = L.cross_entropy(logits, labels, mask)
    loss.backward()
    return loss.detach(), x.grad, {{n: q.grad for n, q in p.named_parameters()}}

want, gx, gp = run(full, None)
local = L.Embedding(cfg, generator=None, device=torch.device("cpu"))
lo, hi = 8 * RANK, 8 * (RANK + 1)
with torch.no_grad():
    local.tok = torch.nn.Parameter(full.tok[lo:hi].clone())
    if not {tied}:
        local.unembed = torch.nn.Parameter(full.unembed[:, lo:hi].clone())
plan = shd.TpPlan(dist.group.WORLD, 4, RANK, frozenset({{"vocab"}}))
got, lx, lp = run(local, plan)
assert local.tok.shape[0] == 8
np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
np.testing.assert_allclose(lx.numpy(), gx.numpy(), rtol=1e-5, atol=1e-6)
np.testing.assert_allclose(lp["tok"].numpy(), gp["tok"][lo:hi].numpy(),
                           rtol=1e-5, atol=1e-6)
if not {tied}:
    np.testing.assert_allclose(lp["unembed"].numpy(),
                               gp["unembed"][:, lo:hi].numpy(),
                               rtol=1e-5, atol=1e-6)
''', 4, tmp_path)


# ----------------------------------------------- the kv_seq decode cache
_REF_DECODE = '''
import jax, jax.numpy as jnp, numpy as np
import repro.configs as C
from repro.distributed import sharding as shd
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as T, whisper as W
d = np.load('{path}')
cfg = C.get_reduced('{arch}').replace(**{over})
params = {{}}
for k in d.files:
    if k.startswith('p/'):
        node = params
        parts = k[2:].split('/')
        for q in parts[:-1]:
            node = node.setdefault(q, {{}})
        node[parts[-1]] = jnp.asarray(d[k])
tokens = jnp.asarray(d['tokens'])
mesh = make_test_mesh((1, 4))
with shd.use_mesh(mesh):
    if cfg.family == 'encdec':    # no batched prefill: the prompt by steps
        dec = jax.jit(lambda p, t, s: W.decode_step(cfg, p, t, s))
        state = jax.jit(lambda p, m: W.init_decode_state(
            cfg, tokens.shape[0], {max_len}, memory=m, params=p))(
                params, jnp.asarray(d['memory']))
        for t in range(tokens.shape[1]):
            logits, state = dec(params, tokens[:, t:t + 1], state)
    else:
        pre = jax.jit(lambda p, t: T.prefill(cfg, p, t, {max_len}))
        dec = jax.jit(lambda p, t, s: T.decode_step(cfg, p, t, s))
        logits, state = pre(params, tokens)
    toks = []
    for _ in range({steps}):
        tok = jnp.argmax(logits[:, -1], -1)
        toks.append(np.asarray(tok))
        logits, state = dec(params, tok[:, None], state)
np.save('{out}', np.stack(toks, 1))
'''

_PORT_DECODE = '''
import repro_torch.configs as C
from repro_torch.distributed import steps as S
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import convert, transformer as T, whisper as W
d = np.load(os.path.join(OUT, "in.npz"))
cfg = C.get_reduced(ARCH).replace(**OVER)
tree = {}
for k in d.files:
    if k.startswith("p/"):
        node = tree
        parts = k[2:].split("/")
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = d[k]
model = convert.params_from_reference(cfg, tree, device="cpu")
mesh = make_test_mesh((1, 4))
sm, _ = S.shard_model(cfg, model, mesh, zero_stage=0)
tokens = S.shard_batch({"t": torch.as_tensor(d["tokens"])}, mesh)["t"]
with torch.no_grad(), sm.context():
    if cfg.family == "encdec":
        logits, state = W.prefill(sm.local_cfg, sm.module, tokens, MAXLEN,
                                  memory=torch.as_tensor(d["memory"]))
    else:
        logits, state = T.prefill(sm.local_cfg, sm.module, tokens, MAXLEN)
logits = S._whole_logits(sm, logits)
if state.attn_k is not None:
    assert tuple(state.attn_k.shape[2:4]) == (MAXLEN // 4, cfg.num_kv_heads)
else:                                   # Mamba-2: this rank's heads
    assert state.ssm_ssd.shape[2] == cfg.ssm_heads // 4
    bc = 2 * cfg.ssm_state
    assert state.ssm_conv.shape[3] == (cfg.ssm_d_inner // 4
                                       + (bc // 4 if bc % 4 == 0 else bc))
step = S.make_decode_step(cfg)
toks, lgs = [], []
for _ in range(STEPS):
    tok = logits[:, -1].argmax(-1)
    toks.append(tok)
    lgs.append(logits[:, -1])
    logits, state = step(sm, tok[:, None], state)
if mesh.get_coordinate()[1] == 0:
    np.savez(os.path.join(OUT, f"dp{mesh.get_coordinate()[0]}.npz"),
             toks=torch.stack(toks, 1).numpy(),
             logits=torch.stack(lgs, 1).numpy(),
             heads=np.array([sm.local_cfg.num_heads]))
'''

# case -> (reduced arch, config fields replaced in both packages)
_DECODES = {
    "llama2_paper": ("llama2_paper", {}),
    "qwen2_7b": ("qwen2_7b", {}),
    "mamba2_780m": ("mamba2_780m", {}),
    "qwen2_7b_6_heads": ("qwen2_7b", {"num_heads": 6, "num_kv_heads": 2}),
    "whisper_6_heads": ("whisper_large_v3", {"num_heads": 6,
                                             "num_kv_heads": 6}),
    "mamba2_bc_whole": ("mamba2_780m", {"ssm_state": 5}),
}


@pytest.mark.parametrize("arch", list(_DECODES))
def test_kv_seq_decode_matches_unsharded_and_reference(tmp_path, arch):
    """Greedy decode on (1, 4) under the default rules, the cache split by
    positions over ``model`` (4 of 32 a rank's 8, every KV head; qwen2_7b's
    2 KV heads are each computed by one rank of two): a 12-token prompt
    and 8 steps, so positions reach the third rank's slice and the fourth
    holds none.  Query heads the model dim does not divide: qwen2_7b with 6
    over 2 KV heads (runs of 2, 2, 1, 1; rank 1's read both KV heads) and
    whisper with 6 (its prompt fed step by step, as the reference serves
    it; the encoder and every cross-attention on the rank's heads, the
    gates open).  Reduced mamba2_780m decodes its 8 SSM heads 2 a rank (its
    conv state this rank's x channels and its 8 of the 32 B / C channels,
    gathered after the conv); with ``ssm_state`` 5 the 10 B / C channels
    stay whole.  The tokens equal the unsharded port's and the reference's
    decode under its own mesh; the logits are within 1e-4 of the unsharded
    port's."""
    name, over = arch, _DECODES[arch][1]
    arch = _DECODES[name][0]
    cfg = RC.get_reduced(arch).replace(**over)
    params = _open_gates(ref_get_api(cfg).init(cfg, jax.random.PRNGKey(0))[0])
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"p/{prefix}{k}"] = np.asarray(v)
    walk(params, "")
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, cfg.vocab_size, (2, 12)).astype(np.int64)
    memory = rs.randn(2, cfg.encoder_seq, cfg.d_model).astype(np.float32)
    np.savez(tmp_path / "in.npz", tokens=tokens, memory=memory, **flat)
    run_child(_REF_DECODE.format(path=tmp_path / "in.npz", arch=arch,
                                 over=repr(over), max_len=32, steps=8,
                                 out=tmp_path / "ref.npy"), devices=4)
    run_ranks(_PORT_DECODE.replace("ARCH", repr(arch))
              .replace("OVER", repr(over))
              .replace("MAXLEN", "32").replace("STEPS", "8"), 4, tmp_path)
    import torch
    import repro_torch.configs as C
    from repro_torch.models import convert as conv, whisper as W
    from repro_torch.models.registry import get_api
    tcfg = C.get_reduced(arch).replace(**over)
    model = conv.params_from_reference(tcfg, _np(params), device="cpu")
    api = get_api(tcfg)
    with torch.no_grad():
        if tcfg.family == "encdec":
            logits, state = W.prefill(tcfg, model, torch.as_tensor(tokens),
                                      32, memory=torch.as_tensor(memory))
        else:
            from repro_torch.models import transformer as T
            logits, state = T.prefill(tcfg, model, torch.as_tensor(tokens),
                                      32)
        toks, lgs = [], []
        for _ in range(8):
            tok = logits[:, -1].argmax(-1)
            toks.append(tok)
            lgs.append(logits[:, -1])
            logits, state = api.decode_step(tcfg, model, tok[:, None], state)
    want = torch.stack(toks, 1).numpy()
    got = [np.load(tmp_path / "dp0.npz")]
    if cfg.num_heads:
        # rank 0 computes the longest run of query heads
        assert int(got[0]["heads"][0]) == -(-cfg.num_heads // 4)
    np.testing.assert_array_equal(np.concatenate([g["toks"] for g in got]),
                                  want)
    np.testing.assert_array_equal(np.load(tmp_path / "ref.npy"), want)
    np.testing.assert_allclose(
        np.concatenate([g["logits"] for g in got]),
        torch.stack(lgs, 1).numpy(), rtol=1e-4, atol=1e-4)
