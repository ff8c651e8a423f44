"""The port's serving slice against the reference, on the CPU.

Reduced ``llama2-paper`` in f32: the reference draws the weights, the
tests pass them to the port through numpy (``params_from_reference``),
and both packages run the same token streams.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as PC
from repro.models import transformer as RT
from repro.models.registry import get_api as ref_get_api
from repro.runtime.server import Server as RefServer
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_reference
from repro_torch.runtime.server import Server

torch.set_num_threads(1)      # tier-1 runs several xdist workers

TOL = dict(rtol=2e-3, atol=2e-3)
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference params, port cfg, port model)."""
    rcfg = RC.get_reduced("llama2_paper")
    rparams, _ = ref_get_api(rcfg).init(rcfg, jax.random.PRNGKey(0))
    pcfg = PC.get_reduced("llama2_paper")
    model = params_from_reference(pcfg, jax.tree.map(np.asarray, rparams),
                                  device="cpu")
    return rcfg, rparams, pcfg, model


def _tokens(seed, B, S, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, S)
                                               ).astype(np.int32)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.int64)


@pytest.mark.parametrize("impl", ["chunked", "dense", "flash"])
def test_forward_logits_match_reference(pair, impl):
    rcfg, rparams, pcfg, model = pair
    toks = _tokens(0, 2, 37, rcfg.vocab_size)
    ref, _ = RT.forward(rcfg, rparams, jnp.asarray(toks))
    with torch.no_grad():
        out, aux = PT.forward(pcfg.replace(attn_impl=impl), model, _t(toks))
    assert out.shape == (2, 37, rcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_prefill_and_decode_match_reference(pair, impl):
    """prefill logits and KV cache, then token-by-token decode_step."""
    rcfg, rparams, pcfg, model = pair
    pcfg = pcfg.replace(attn_impl=impl)
    toks = _tokens(1, 2, 21, rcfg.vocab_size)
    rlog, rstate = RT.prefill(rcfg, rparams, jnp.asarray(toks), 32)
    with torch.no_grad():
        plog, pstate = PT.prefill(pcfg, model, _t(toks), 32)
    np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **TOL)
    np.testing.assert_allclose(pstate.attn_k.numpy(),
                               np.asarray(rstate.attn_k), **TOL)
    np.testing.assert_allclose(pstate.attn_v.numpy(),
                               np.asarray(rstate.attn_v), **TOL)
    np.testing.assert_array_equal(pstate.pos.numpy(), np.asarray(rstate.pos))
    nxt = np.asarray(jnp.argmax(rlog[:, -1], axis=-1))[:, None]
    for _ in range(4):
        rlog, rstate = RT.decode_step(rcfg, rparams,
                                      jnp.asarray(nxt, jnp.int32), rstate)
        with torch.no_grad():
            plog, pstate = PT.decode_step(pcfg, model, _t(nxt), pstate)
        np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **TOL)
        np.testing.assert_allclose(pstate.attn_k.numpy(),
                                   np.asarray(rstate.attn_k), **TOL)
        np.testing.assert_array_equal(pstate.pos.numpy(),
                                      np.asarray(rstate.pos))
        nxt = np.asarray(jnp.argmax(rlog[:, -1], axis=-1))[:, None]


def _serve(server_cls, cfg, params, max_batch, prompts, new_tokens,
           max_len=32):
    srv = server_cls(cfg, params, max_batch=max_batch, max_len=max_len)
    rids = [srv.submit(p, max_new_tokens=n) for p, n in zip(prompts, new_tokens)]
    out = srv.run_until_done()
    return [out[r] for r in rids]


def test_server_matches_reference_single_and_batched(pair):
    """The prompts of test_server_matches_single_request, both servers."""
    rcfg, rparams, pcfg, model = pair
    prompt = np.arange(6, dtype=np.int32) % rcfg.vocab_size
    other = (np.arange(9) * 3) % rcfg.vocab_size
    ref1 = _serve(RefServer, rcfg, rparams, 1, [prompt], [5])
    got1 = _serve(Server, pcfg, model, 1, [prompt], [5])
    assert got1 == ref1
    ref3 = _serve(RefServer, rcfg, rparams, 3, [prompt, other], [5, 4])
    got3 = _serve(Server, pcfg, model, 3, [prompt, other], [5, 4])
    assert got3 == ref3
    assert got3[0] == got1[0] and len(got3[1]) == 4


def test_server_flash_matches_reference_pallas(pair):
    """3 requests over 2 slots: the port's ``flash`` against the
    reference's ``pallas`` (its Pallas kernel in interpret mode)."""
    rcfg, rparams, pcfg, model = pair
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, rcfg.vocab_size, size=n) for n in (5, 9, 7)]
    ref = _serve(RefServer, rcfg.replace(attn_impl="pallas"), rparams, 2,
                 prompts, [4, 4, 4])
    got = _serve(Server, pcfg.replace(attn_impl="flash"), model, 2,
                 prompts, [4, 4, 4])
    assert got == ref


def test_server_refuses_unported_options(pair, tmpdir):
    """The options the server once refused now work: a read-only policy
    store reported in ``stats()`` and re-scanned in the background every
    ``_refresh_every_ticks`` ticks under ``adapt_mode="async"`` (records a
    trainer writes meanwhile become visible), and over-subscription
    (tests/test_torch_kvspill.py).  An unknown placement raises."""
    from repro_torch.common.config import PolicyStoreConfig
    from repro_torch.policystore import PolicyStore, fingerprint_tokens
    from tests.test_torch_adapt_service import _record
    _, _, pcfg, model = pair
    d = str(tmpdir)
    fp = lambda k: fingerprint_tokens(np.arange(64, dtype=np.int32) % k + 1,
                                      cache=False)
    writer = PolicyStore(PolicyStoreConfig(dir=d))
    writer.put(_record(fp(7)))
    store = PolicyStore(PolicyStoreConfig(dir=d), readonly=True)
    srv = Server(pcfg, model, max_batch=2, policystore=store,
                 adapt_mode="async")
    srv._refresh_every_ticks = 2
    writer.put(_record(fp(9)))           # a trainer's record, after attach
    srv.submit(np.arange(1, 6), max_new_tokens=4)
    srv.run_until_done()
    srv.close()
    st = srv.stats()
    assert st["adapt"] == {"mode": "async", "store_refreshes": 1,
                           "store_records_refreshed": 1}
    assert st["policystore"]["records"] == 2 and st["policystore"]["dir"] == d
    inline = Server(pcfg, model, max_batch=2, policystore=store)
    inline._refresh_every_ticks = 1
    inline.submit(np.arange(1, 6), max_new_tokens=3)
    inline.run_until_done()
    assert inline.stats()["adapt"]["store_refreshes"] == 0  # inline: none
    with pytest.raises(ValueError, match="mode"):
        Server(pcfg, model, max_batch=2, adapt_mode="eager")
    srv = Server(pcfg, model, max_batch=2, max_active=4)
    assert srv.hostmem is not None and srv.hostmem.device.type == "cpu"


@pytest.mark.parametrize("rotate_every", [1, 3])
def test_rotate_every_matches_reference(pair, rotate_every):
    """Over-subscribed (4 admitted over 2 slots): with a rotation quantum of
    k ticks the port rotates, spills, restores and emits tokens exactly as
    the reference's server does."""
    from repro.hostmem import HostMemTier as RHostMemTier
    from repro_torch.hostmem import HostMemTier
    rcfg, rparams, pcfg, model = pair
    prompts = [p for p in _tokens(5, 4, 9, rcfg.vocab_size)]
    srv = Server(pcfg, model, max_batch=2, max_len=48, max_active=4,
                 hostmem=HostMemTier(device="cpu"), rotate_every=rotate_every)
    rsrv = RefServer(rcfg, rparams, max_batch=2, max_len=48, max_active=4,
                     hostmem=RHostMemTier(), rotate_every=rotate_every)
    assert srv.rotate_every == rsrv.rotate_every == rotate_every
    ids = [srv.submit(p, max_new_tokens=7) for p in prompts]
    rids = [rsrv.submit(p, max_new_tokens=7) for p in prompts]
    out, rout = srv.run_until_done(max_ticks=300), rsrv.run_until_done(
        max_ticks=300)
    assert srv.n_preemptions > 0
    assert srv.n_preemptions == rsrv.n_preemptions
    assert srv.ticks == rsrv.ticks
    ks = srv.stats()["hostmem"]["kvspill"]
    assert ks == rsrv.stats()["hostmem"]["kvspill"]
    assert ks["n_spills"] == ks["n_restores"] == srv.n_preemptions
    for a, b in zip(ids, rids):
        assert out[a] == rout[b]


def test_serve_cli_on_cpu():
    from repro_torch.launch import serve
    stats = serve.main(["--arch", "llama2-paper", "--reduced", "--device",
                        "cpu", "--attn-impl", "flash", "--requests", "3",
                        "--max-batch", "2", "--new-tokens", "3",
                        "--max-len", "32"])
    assert stats["completed"] == 3 and stats["attn_impl"] == "flash"
    assert all(len(v) == 3 for v in stats["results"].values())
    assert stats["latency"]["prefill_ms"]["n"] == 3
    assert stats["policystore"] is None and stats["adapt"]["mode"] == "inline"


def test_serve_cli_with_a_policy_store(tmp_path, capsys):
    """``--policy-store-dir D --adapt-mode async``: the store attaches
    read-only with the records a trainer wrote, and the server re-scans it
    in the background once 256 ticks have passed."""
    from repro_torch.common.config import PolicyStoreConfig
    from repro_torch.launch import serve
    from repro_torch.policystore import PolicyStore, fingerprint_tokens
    from tests.test_torch_adapt_service import _record
    d = str(tmp_path / "store")
    PolicyStore(PolicyStoreConfig(dir=d)).put(_record(fingerprint_tokens(
        np.arange(64, dtype=np.int32) % 7 + 1, cache=False)))
    stats = serve.main(["--arch", "llama2-paper", "--reduced", "--device",
                        "cpu", "--requests", "1", "--max-batch", "1",
                        "--new-tokens", "258", "--max-len", "272",
                        "--policy-store-dir", d, "--adapt-mode", "async"])
    assert stats["ticks"] >= 256
    assert stats["adapt"] == {"mode": "async", "store_refreshes": 1,
                              "store_records_refreshed": 0}
    assert stats["policystore"]["records"] == 1
    out = capsys.readouterr().out
    assert "policystore: {'records': 1" in out
    assert "adapt[async]: store_refreshes=1" in out


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """With no card and no ``device='cpu'`` the entry points raise."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PC.get_reduced("llama2_paper")
    with pytest.raises(RuntimeError, match="cuda"):
        PT.init_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "llama2-paper", "--reduced", "--requests", "1"])


def test_unported_family_raises():
    """The vlm and encdec families initialise and decode through the model
    API (``init_decode_state(memory=, params=)``, ``decode_step``), as the
    reference serves them; the server refuses them and the hybrid family,
    whose prefill the reference's server does not cover either."""
    from repro_torch.models.registry import get_api
    for arch in ("llama-3.2-vision-90b", "whisper-large-v3"):
        cfg = PC.get_reduced(arch).replace(attn_impl="flash")
        api = get_api(cfg)
        model = api.init(cfg, device="cpu")
        T = cfg.image_tokens if cfg.family == "vlm" else cfg.encoder_seq
        memory = torch.randn(2, T, cfg.d_model,
                             generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            state = api.init_decode_state(cfg, 2, 8, params=model,
                                          memory=memory)
            logits, state = api.decode_step(
                cfg, model, torch.zeros((2, 1), dtype=torch.int64), state)
        assert logits.shape == (2, 1, cfg.vocab_size)
        assert torch.isfinite(logits).all() and state.pos.tolist() == [1, 1]
        with pytest.raises(NotImplementedError, match="decode-only"):
            Server(cfg, model, memory=memory)
    cfg = PC.get_reduced("zamba2-1.2b")
    with pytest.raises(NotImplementedError, match="decode_step"):
        Server(cfg, PT.init_model(cfg, device="cpu"))


@pytest.mark.parametrize("name", RC.ALL_IDS)
def test_configs_match_reference(name):
    import dataclasses
    ref, port = RC.get_config(name), PC.get_config(name)
    rd, pd = dataclasses.asdict(ref), dataclasses.asdict(port)
    assert rd.pop("attn_impl") == pd.pop("attn_impl")   # both "chunked"
    assert rd == pd and port.param_count() == ref.param_count()
    assert (dataclasses.asdict(PC.get_reduced(name))
            == dataclasses.asdict(RC.get_reduced(name)))


def test_config_takes_flash_not_pallas():
    cfg = PC.get_reduced("llama2_paper")
    assert cfg.replace(attn_impl="flash").attn_impl == "flash"
    with pytest.raises(ValueError):
        cfg.replace(attn_impl="pallas")


def test_chrome_trace_passes_reference_validator(tmp_path):
    from repro.obs.validate import validate_chrome_trace
    from repro_torch import obs
    tr = obs.SpanTracer()
    with tr.span(obs.LANE_COMPUTE, "prefill", arg=(1, 6)):
        pass
    path = obs.export_chrome_trace(str(tmp_path / "t.json"), tr)
    with open(path) as f:
        summary = validate_chrome_trace(json.load(f),
                                        require_lanes=[obs.LANE_COMPUTE])
    assert summary["n_spans"] == 1


def test_port_imports_neither_jax_nor_reference():
    """Every module of ``repro_torch`` and ``examples_torch``, imported in a
    fresh process, brings in neither JAX nor the reference."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"sys.path.insert(0, {str(SRC.parent)!r})\n"
        "import examples_torch\n"
        "for m in pkgutil.iter_modules(examples_torch.__path__,\n"
        "                              'examples_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "need = ['optim.adamw', 'optim.loss_scale', 'optim.schedules',\n"
        "        'data.synthetic', 'distributed.steps',\n"
        "        'checkpointing.manager', 'runtime.trainer',\n"
        "        'runtime.straggler', 'launch.train', 'launch.serve',\n"
        "        'core.executor', 'core.runtime', 'obs.overlap',\n"
        "        'faults.ladder', 'policystore.fingerprint',\n"
        "        'policystore.lshindex', 'policystore.store',\n"
        "        'policystore.drift', 'adapt.snapshot', 'adapt.pipeline',\n"
        "        'adapt.service', 'models.moe', 'models.whisper',\n"
        "        'obs.validate', 'obs.report', 'kernels.autotune.device',\n"
        "        'kernels.autotune.table', 'kernels.autotune.cache',\n"
        "        'kernels.autotune.space', 'kernels.autotune.tuner',\n"
        "        'kernels.autotune.advisor', 'distributed.sharding',\n"
        "        'distributed.compression', 'launch.mesh', 'launch.specs',\n"
        "        'launch.roofline', 'launch.dryrun']\n"
        "bad += ['missing ' + n for n in need\n"
        "        if 'repro_torch.' + n not in sys.modules]\n"
        "bad += ['missing ' + n for n in ('quickstart', 'train_e2e',\n"
        "        'serve_batched', 'adaptive_swap_demo', 'elastic_restart')\n"
        "        if 'examples_torch.' + n not in sys.modules]\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(SRC)},
                         timeout=120, check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 20, out
    assert out[1].strip() == "[]", out
