"""The five shipped configurations the card had not run, against the
reference on the CPU.

llama3.2-1b (tied embeddings), qwen1.5-0.5b (MHA, QKV bias),
stablelm-1.6b (LayerNorm), qwen2-7b (GQA, QKV bias) and qwen3-moe-30b-a3b
(128 experts at full width) at their reduced sizes, plus two variants that
carry the full configurations' attention shapes into the reduced ones:
qwen3-moe with ``head_dim`` 32, so heads x head_dim (128) differs from
d_model (64), as at full width (4096 against 2048); and qwen2-7b with 7
query heads over 1 KV head, the full configuration's GQA group of 7.
Each variant is the same ``.replace`` on the reference's config and the
port's.  The reference draws the weights and the port takes them through
``params_from_reference``; prefill, decode, the server's greedy tokens and
(for the variants) the grad step's gradients are held to the reference's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as PC
from repro.common.config import TrainConfig as RTrainConfig
from repro.distributed import steps as RS
from repro.models import transformer as RT
from repro.models.registry import get_api as ref_get_api
from repro.runtime.server import Server as RefServer
from repro_torch.common.config import TrainConfig
from repro_torch.distributed import steps as S
from repro_torch.models import convert
from repro_torch.models import transformer as PT
from repro_torch.runtime.server import Server
from tests.test_torch_training import GRAD_REL, _batch, _np, _rel

torch.set_num_threads(1)      # tier-1 runs several xdist workers

TOL = dict(rtol=2e-3, atol=2e-3)      # tests/test_torch_serving.py's
# case -> (arch, fields replaced on both packages' reduced configs)
CASES = {
    "llama3.2-1b": ("llama3.2-1b", {}),
    "qwen1.5-0.5b": ("qwen1.5-0.5b", {}),
    "stablelm-1.6b": ("stablelm-1.6b", {}),
    "qwen2-7b": ("qwen2-7b", {}),
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}),
    "qwen3-moe-hd32": ("qwen3-moe-30b-a3b", {"head_dim": 32}),
    "qwen2-7b-g7": ("qwen2-7b", {"num_heads": 7, "num_kv_heads": 1}),
}
VARIANTS = ["qwen3-moe-hd32", "qwen2-7b-g7"]
DECODE_TICKS = 4


@functools.lru_cache(maxsize=None)
def _pair(case):
    """(reference cfg, reference params, port cfg, port model) of ``case``."""
    arch, kw = CASES[case]
    rcfg = RC.get_reduced(arch).replace(**kw)
    pcfg = PC.get_reduced(arch).replace(**kw)
    rparams, _ = ref_get_api(rcfg).init(rcfg, jax.random.PRNGKey(0))
    model = convert.params_from_reference(pcfg, _np(rparams), device="cpu")
    return rcfg, rparams, pcfg, model


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.int64)


@functools.lru_cache(maxsize=None)
def _ref_decode(case):
    """The reference's prefill of two 13-token prompts and DECODE_TICKS
    greedy ticks: (tokens, [logits of the prefill, then of each tick],
    the tokens fed to each tick)."""
    rcfg, rparams, _, _ = _pair(case)
    toks = np.random.RandomState(1).randint(0, rcfg.vocab_size, size=(2, 13)
                                            ).astype(np.int32)
    logits, state = RT.prefill(rcfg, rparams, jnp.asarray(toks), 24)
    out, fed = [np.asarray(logits)], []
    for _ in range(DECODE_TICKS):
        nxt = np.asarray(jnp.argmax(logits[:, -1], axis=-1))[:, None]
        fed.append(nxt)
        logits, state = RT.decode_step(rcfg, rparams,
                                       jnp.asarray(nxt, jnp.int32), state)
        out.append(np.asarray(logits))
    return toks, out, fed


@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference(case, impl):
    """Prefill logits, then DECODE_TICKS decode ticks fed the reference's
    greedy tokens; ``flash`` is the card's path (its plain versions on
    the CPU), both against the reference's chunked attention."""
    toks, want, fed = _ref_decode(case)
    _, _, pcfg, model = _pair(case)
    pcfg = pcfg.replace(attn_impl=impl)
    with torch.no_grad():
        logits, state = PT.prefill(pcfg, model, _t(toks), 24)
        got = [logits.numpy()]
        for nxt in fed:
            logits, state = PT.decode_step(pcfg, model, _t(nxt), state)
            got.append(logits.numpy())
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def _serve(server_cls, cfg, params, max_batch, prompts, new_tokens):
    srv = server_cls(cfg, params, max_batch=max_batch, max_len=32)
    rids = [srv.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, new_tokens)]
    out = srv.run_until_done()
    return [list(map(int, out[r])) for r in rids]


@pytest.mark.parametrize("case", list(CASES))
def test_server_matches_reference_single_and_batched(case):
    """One request in one slot, then three over two slots (one waits for a
    slot): the same greedy tokens as the reference's server."""
    rcfg, rparams, pcfg, model = _pair(case)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, rcfg.vocab_size, size=n) for n in (6, 9, 7)]
    one = _serve(Server, pcfg, model, 1, prompts[:1], [5])
    assert one == _serve(RefServer, rcfg, rparams, 1, prompts[:1], [5])
    three = _serve(Server, pcfg, model, 2, prompts, [5, 4, 3])
    assert three == _serve(RefServer, rcfg, rparams, 2, prompts, [5, 4, 3])
    assert three[0] == one[0] and [len(t) for t in three] == [5, 4, 3]


@pytest.mark.parametrize("case", VARIANTS)
def test_grad_step_matches_reference(case):
    """The grad step's loss and every gradient against the reference's at
    the variants' attention shapes (H x D != d; a GQA group of 7)."""
    rcfg, rparams, pcfg, model = _pair(case)
    rb, pb = _batch(rcfg, seed=1, seq=16, batch=2)
    scale = 2.0 ** 15
    rloss, rgrads, rfinite = jax.jit(RS.make_grad_step(rcfg, RTrainConfig()))(
        rparams, rb, jnp.float32(scale))
    ploss, pgrads, pfinite = S.make_grad_step(pcfg, TrainConfig())(
        model, pb, scale)
    assert bool(rfinite) and bool(pfinite)
    np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-5)
    ours = convert.to_reference_tree({n: g.numpy() for n, g in pgrads.items()})
    flat_r = jax.tree_util.tree_flatten_with_path(_np(rgrads))[0]
    assert len(flat_r) == len(jax.tree_util.tree_leaves(ours))
    for path, leaf in flat_r:
        node = ours
        for p in path:
            node = node[p.key]
        assert node.shape == leaf.shape, path
        assert _rel(node, leaf) <= GRAD_REL, (path, _rel(node, leaf))


def test_serve_cli_default_arch():
    """The serve CLI with no ``--arch`` serves its default, llama3.2-1b."""
    from repro_torch.launch import serve
    stats = serve.main(["--reduced", "--device", "cpu", "--attn-impl",
                        "flash", "--requests", "3", "--max-batch", "2",
                        "--new-tokens", "4"])
    assert stats["arch"] == "llama3.2-1b"
    assert stats["completed"] == 3
    assert [len(t) for t in stats["results"].values()] == [4, 4, 4]
