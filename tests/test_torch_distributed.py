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

_PRELUDE = '''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK = int(os.environ["RANK"])
WORLD = int(os.environ["WORLD_SIZE"])
OUT = os.environ["OUT"]
dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                        rank=RANK, world_size=WORLD)
'''


def run_ranks(code: str, world: int, tmp_path, timeout: int = CHILD_TIMEOUT
              ) -> list:
    """Run ``code`` in ``world`` gloo ranks (the prelude joins the group;
    ``OUT`` is ``tmp_path``); returns every rank's stdout.  A rank that
    fails or outlives ``timeout`` fails the test, and every rank is
    stopped."""
    store = os.path.join(str(tmp_path), "store")
    if os.path.exists(store):
        os.remove(store)
    body = (_PRELUDE + textwrap.dedent(code)
            + "\ndist.destroy_process_group()\n")
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   STORE=store, OUT=str(tmp_path), PYTHONPATH=SRC,
                   OMP_NUM_THREADS="1")
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
cfg = C.get_reduced(ARCH)
ref = dict(np.load(os.path.join(OUT, "ref.npz")))
params = {k[2:]: v for k, v in ref.items() if k.startswith("p/")}
batch = {k: torch.as_tensor(ref["b/" + k], dtype=torch.int64)
         for k in ("tokens", "labels")}
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
                   "zero3_shards": len(sm.shards)}, f)
'''

# case -> (arch, mesh, axes, ZeRO stage, rules, global batch); "kv_slice":
# reduced qwen2_7b's 2 KV heads (and their biases) under a model dim of 4,
# each rank computing the one KV head its query head uses
_MESHES = {
    "zero2": ("llama2_paper", (2, 4), ("data", "model"), 2, None, 4),
    "kv_slice": ("qwen2_7b", (2, 4), ("data", "model"), 2, None, 4),
    "zero3": ("llama2_paper", (2, 4), ("data", "model"), 3, None, 4),
    "dp_only": ("llama2_paper", (2, 4), ("data", "model"), 0,
                "DP_ONLY_RULES", 8),
    "pod_mesh": ("llama2_paper", (2, 2, 2), ("pod", "data", "model"), 2,
                 None, 4),
}


def _reference_step(arch: str, batch_size: int):
    """The reference's jitted single-device step: (initial params, batch,
    new params, loss, grad norm)."""
    cfg = RC.get_reduced(arch)
    params, _ = ref_get_api(cfg).init(cfg, jax.random.PRNGKey(0))
    opt = ref_adamw_init(params)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    batch = {"tokens": jax.random.randint(k1, (batch_size, 32), 0,
                                          cfg.vocab_size),
             "labels": jax.random.randint(k2, (batch_size, 32), 0,
                                          cfg.vocab_size)}
    step = RS.make_train_step(cfg, RTrainConfig(warmup_steps=0))
    p1, _, m1 = jax.jit(step)(params, opt, batch, jnp.float32(1.0))
    return (_np(params), _np(batch), _np(p1), float(m1["loss"]),
            float(m1["grad_norm"]))


@pytest.mark.parametrize("case", sorted(_MESHES))
def test_sharded_train_step_matches_unsharded_and_reference(tmp_path, case):
    arch, shape, axes, zero, rules, B = _MESHES[case]
    params, batch, ref_new, ref_loss, ref_gnorm = _reference_step(arch, B)
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
    # the layouts really split something: TP under the default rules,
    # parameters at rest under ZeRO 3 and dp_only
    assert info["sharded"]
    if rules is None:
        assert info["blocks"] == ["attn", "mlp"]
    if case == "kv_slice":
        assert {n.rpartition(".")[2] for n in info["tp_sum"]} == {
            "wk", "wv", "bk", "bv"}, info["tp_sum"]
    else:
        assert info["tp_sum"] == []
    if case in ("zero3", "dp_only"):
        assert info["zero3_shards"] > 0
    else:
        assert info["zero3_shards"] == 0


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
