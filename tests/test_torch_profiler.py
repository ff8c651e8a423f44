"""Detailed-mode profiler (§4) and the no-swap timeline: the port's
``profile_step`` over one eager step against the reference's jaxpr walk
(the ``llama_profile`` fixture), on the CPU.

Both profile the same step: reduced llama2-paper (8 layers, d 128, f32,
chunked attention), batch (4, 128) of ones, loss, gradients and an SGD
update at lr 1e-3, the port on the reference's initial weights
(``models.convert``).  The op streams differ (aten ops against jaxpr
equations), so parity is on the candidates: the same (site, layer) pairs
with the same instances, bytes, dtypes and shapes, apart from two
differences of representation, each asserted below:

* ``ln_in``: the reference names layer i's input ``ln_in`` and, as a scan
  residual, counts it beside layer i-1's ``resid_post`` (the embedding
  output for layer 0), though in the program they are one buffer.  The
  port profiles storages: that buffer is one instance, labelled by its
  first tag (``resid_post`` of layer i-1, ``embed_out`` for layer 0), so
  the port has no ``ln_in`` and does not count those bytes twice.
* ``attn_ctx``: the out-projection's backward saves the context reshaped to
  (B, S, H*D); the reference's aval matcher does not tie that residual to
  the (B, S, H, D) variable named ``attn_ctx``, so it finds no
  ``attn_ctx`` instance.  The port's tag labels the storage of the tensor
  it is given, so it has one per layer (bytes: one (B, S, H, D) tensor).

Liveness differs by design too: the port's death is the free, not the last
use, so ``attn_out`` and ``ffn_out`` (kept by no backward node) die in the
forward, where the reference keeps every named scan residual to its
backward use.  So does the chunked path's ``attn_ctx``: it is a view of
the softmax-weighted sum, which the out-projection copies into (B, S,
H*D); the backward saves the copy.  Under flash attention the kernel's
output is the saved buffer and lives to the backward.  All comparisons
are exact (integers).
"""
import collections
import threading

import jax
import numpy as np
import pytest
import torch

import repro_torch.configs as PC
from repro_torch.core.memtrace import build_timeline
from repro_torch.core.profiler import (MIN_TRACK_BYTES, ProfileData,
                                       dtype_code, profile_step)
from repro_torch.core.tokenizer import GLOBAL_VOCAB
from repro_torch.models import convert
from repro_torch.models import transformer as PT

torch.set_num_threads(1)      # tier-1 runs several xdist workers

LAYERS = 8
REF_ONLY = {("ln_in", i) for i in range(LAYERS)}
PORT_ONLY = {("attn_ctx", i) for i in range(LAYERS)}


def _step(cfg, model, batch):
    def step():
        loss, _ = PT.loss_fn(cfg, model, batch)
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p.sub_(1e-3 * p.grad)
                p.grad = None
    return step


@pytest.fixture(scope="module")
def port_profile(llama_small):
    cfg_r, _, params, _ = llama_small
    cfg = PC.get_reduced("llama2_paper").replace(num_layers=LAYERS)
    assert cfg.attn_impl == cfg_r.attn_impl == "chunked"
    model = convert.params_from_reference(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    batch = {k: torch.ones((4, 128), dtype=torch.int64)
             for k in ("tokens", "labels")}
    return profile_step(_step(cfg, model, batch), device="cpu"), model


def _by_pair(prof):
    out = collections.defaultdict(list)
    for t in prof.candidates:
        out[(t.site, t.layer)].append(t)
    return out


def test_same_candidate_pairs_and_bytes(llama_profile, port_profile):
    ref, port = _by_pair(llama_profile[0]), _by_pair(port_profile[0])
    assert set(port) == (set(ref) - REF_ONLY) | PORT_ONLY
    for pair in set(ref) & set(port):
        r, p = ref[pair], port[pair]
        assert sorted(t.nbytes for t in p) == sorted(t.nbytes for t in r), pair
        assert sorted(t.shape for t in p) == sorted(t.shape for t in r), pair
        assert {t.dtype_code for t in p} == {dtype_code("float32")}


def test_ln_in_is_the_previous_layers_buffer(llama_profile, port_profile):
    """The reference's ln_in of layer i has the bytes of the port's single
    instance of that buffer: resid_post of layer i-1 (embed_out for 0)."""
    ref, port = _by_pair(llama_profile[0]), _by_pair(port_profile[0])
    for i in range(LAYERS):
        prev = port[("embed_out", -1) if i == 0 else ("resid_post", i - 1)]
        assert [t.nbytes for t in ref[("ln_in", i)]] == \
            [t.nbytes for t in prev]


def test_attn_ctx_is_one_query_sized_tensor(port_profile):
    port = _by_pair(port_profile[0])
    for i in range(LAYERS):
        (ctx,) = port[("attn_ctx", i)]
        q = port[("qkv_proj", i)][0]
        assert ctx.shape == q.shape == (4, 128, 4, 32)
        assert ctx.nbytes == 4 * 128 * 4 * 32 * 4


def test_profile_sawtooth_liveness(port_profile):
    """tests/test_profiler_memtrace.py: ffn_pre born in layer order dies in
    reverse (backward) order."""
    prof = port_profile[0]
    first = {}
    for t in sorted(prof.candidates, key=lambda t: t.birth):
        if t.site == "ffn_pre":
            first.setdefault(t.layer, t)
    births = [first[i].birth for i in range(LAYERS)]
    deaths = [first[i].death for i in range(LAYERS)]
    assert births == sorted(births)
    assert deaths == sorted(deaths, reverse=True)


def test_timeline_peak_in_middle(port_profile):
    prof = port_profile[0]
    tl = build_timeline(prof)
    assert 0.2 * prof.n_ops < tl.peak_op < 0.8 * prof.n_ops
    assert tl.peak > prof.static_bytes
    # the forward-only residuals die before the peak; the saved ones after
    for t in prof.candidates:
        if t.site in ("attn_out", "ffn_out", "attn_ctx"):
            assert t.death <= tl.peak_op
        elif t.site in ("ffn_pre", "qkv_proj", "resid_post"):
            assert t.birth <= tl.peak_op < t.death


def test_profile_counts_and_static_bytes(llama_profile, port_profile):
    prof, model = port_profile
    assert prof.n_ops > 500 and prof.scan_layers == LAYERS
    assert llama_profile[0].scan_layers == LAYERS
    pbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert prof.static_bytes >= pbytes
    assert all(t.nbytes >= MIN_TRACK_BYTES for t in prof.tensors)
    assert all(0 < t.birth <= t.death <= prof.n_ops for t in prof.tensors)
    assert prof.t_iter > 0


def test_flash_attention_is_one_token_in_a_profile():
    cfg = PC.get_reduced("llama2_paper").replace(num_layers=2,
                                                 attn_impl="flash")
    model = PT.init_model(cfg, seed=0, device="cpu")
    batch = {k: torch.ones((2, 64), dtype=torch.int64)
             for k in ("tokens", "labels")}
    prof = profile_step(_step(cfg, model, batch), device="cpu")
    names = {tok: n for n, tok in GLOBAL_VOCAB._ids.items()}
    ops = [names[t] for t in prof.op_tokens]
    assert ops.count("repro_torch::flash_attention_fwd") == 2
    assert ops.count("repro_torch::flash_attention_bwd") == 2
    ctx = [t for t in prof.candidates if t.site == "attn_ctx"]
    assert [names[t.producer_token] for t in ctx] == \
        ["repro_torch::flash_attention_fwd"] * 2
    peak_op = build_timeline(prof).peak_op
    assert all(t.birth <= peak_op < t.death for t in ctx)   # saved by K1


def test_views_inplace_and_tags_add_no_instance():
    from repro_torch.core.sites import tag

    def step():
        x = torch.ones(64, 64)
        y = x.view(4096)
        x.mul_(2.0)
        tag(x, "ffn_pre")
        tag(y, "ffn_act")            # the same storage: the first tag stays
        z = x + 1.0
        del x, y
        return z

    prof = profile_step(step, device="cpu")
    assert len(prof.tensors) == 2
    x, z = prof.tensors
    assert (x.site, x.nbytes, x.death) == ("ffn_pre", 64 * 64 * 4, 4)
    assert z.site is None and z.death == prof.n_ops == 4


def test_death_recorded_when_another_thread_frees():
    """The weakref callback runs on the freeing thread (the autograd
    engine's device thread in a CUDA backward) and still stamps the op."""
    box = []

    def step():
        box.append(torch.zeros(1024))
        t = threading.Thread(target=box.clear)
        torch.ones(2)                 # op 2
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        torch.ones(2)                 # op 3

    prof = profile_step(step, device="cpu")
    (inst,) = [t for t in prof.tensors if t.nbytes == 4096]
    assert (inst.birth, inst.death, prof.n_ops) == (1, 2, 3)


def test_from_arrays_round_trip(llama_profile):
    ref = llama_profile[0]
    ts = ref.tensors
    prof = ProfileData.from_arrays(
        np.asarray(ref.op_tokens), [t.nbytes for t in ts],
        [t.birth for t in ts], [t.death for t in ts],
        t_iter=ref.t_iter, static_bytes=ref.static_bytes,
        uids=[t.uid for t in ts], sites=[t.site for t in ts],
        layers=[t.layer for t in ts], dtype_codes=[t.dtype_code for t in ts],
        shapes=[t.shape for t in ts],
        producer_tokens=[t.producer_token for t in ts],
        scan_layers=ref.scan_layers)
    assert prof.n_ops == ref.n_ops and prof.scan_layers == ref.scan_layers
    assert [vars(t) for t in prof.tensors] == [vars(t) for t in ts]


# The moe and ssm sites of a reduced granite-moe and mamba2 train step, as
# (site, layer) pairs, against the reference's jaxpr profile of the same
# step.  ``ssm_gate`` tags z, a slice of the in-projection tagged
# ``ssm_in``: the reference's backward saves the slice, so it finds an
# ``ssm_gate`` and no ``ssm_in``; the port labels a storage by its first
# tag (as with ``ln_in`` above), so the same buffer is its ``ssm_in``.
ZOO_FAMILY_SITES = {"granite_moe_1b_a400m": ("router_", "moe_"),
                    "mamba2_780m": ("ssm_",)}


@pytest.mark.parametrize("arch", sorted(ZOO_FAMILY_SITES))
def test_zoo_sites_labelled_as_reference(arch):
    import jax.numpy as jnp
    import repro.configs as RC
    from repro.core.profiler import profile_jaxpr
    from repro.models.registry import get_api as ref_get_api
    from repro_torch.core.sites import base_site

    rcfg, pcfg = RC.get_reduced(arch), PC.get_reduced(arch)
    api = ref_get_api(rcfg)
    params, _ = api.init(rcfg, jax.random.PRNGKey(0))

    def train_step(p, batch):
        loss, g = jax.value_and_grad(lambda q: api.loss_fn(rcfg, q, batch)[0])(p)
        return loss, jax.tree.map(lambda a, b: a - 1e-3 * b, p, g)

    rbatch = {k: jnp.ones((2, 16), jnp.int32) for k in ("tokens", "labels")}
    ref = profile_jaxpr(jax.make_jaxpr(train_step)(params, rbatch), t_iter=1.0)
    model = convert.params_from_reference(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    pbatch = {k: torch.ones((2, 16), dtype=torch.int64)
              for k in ("tokens", "labels")}
    port = profile_step(_step(pcfg, model, pbatch), device="cpu")
    fam = ZOO_FAMILY_SITES[arch]

    def pairs(prof):
        return {(base_site(t.site), t.layer) for t in prof.candidates
                if base_site(t.site).startswith(fam)}
    want = {("ssm_in", i) if s == "ssm_gate" else (s, i)
            for s, i in pairs(ref)}
    assert pairs(port) == want
    assert {s for s, _ in want} >= (
        {"router_logits", "moe_dispatch", "moe_act", "moe_out"}
        if "moe_" in fam else {"ssm_in", "ssm_conv", "ssm_state", "ssm_out"})
