"""The vlm family (llama-3.2-vision-90b, reduced) against the reference, on
the CPU.

Reduced vision model: d 64, 4 heads over 2 KV heads of 16, 16 image tokens
of memory, f32, a cross block every 3rd layer.  At depth 6 (the reduced
config) the stack is two groups of 2 self blocks + 1 cross block; at
depth 7 one self block remains after the last group, the remainder stack
the reduced config never reaches.  Weights, inputs, tolerances and the
nonzero ``xgate`` as in ``tests/test_torch_encdec.py`` (whose helpers this
file uses).

F6 (reference side): the reference's ``transformer.prefill`` fills no KV
cache for vlm (``else: pass``), so a decode after it attends to zeros over
the whole prompt; the port's prefill collects every layer's K/V in its
forward and matches the reference's own token-by-token decode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as RT
from repro_torch.models import transformer as PT
from tests.test_torch_encdec import (TOL, batches, check_grads,
                                     checkpoints_cross, memory_of, pair, t64,
                                     tokens_of, trainer_vs_train_step)
from tests.test_torch_encdec import tmpdir  # noqa: F401  (a fixture)

torch.set_num_threads(1)      # tier-1 runs several xdist workers

ARCH = "llama3_2_vision_90b"
DEPTHS = (6, 7)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("depth", DEPTHS)
def test_forward_matches_reference(depth, impl):
    rcfg, rparams, pcfg, model = pair(ARCH, impl, num_layers=depth)
    assert len(model.cross_blocks) == 2 and len(model.blocks) == depth - 2
    mem, toks = memory_of(rcfg, 2), tokens_of(rcfg, 2, 11)
    rlog, _ = RT.forward(rcfg, rparams, jnp.asarray(toks),
                         memory=jnp.asarray(mem))
    with torch.no_grad():
        plog, aux = PT.forward(pcfg, model, t64(toks),
                               memory=torch.tensor(mem))
    assert plog.shape == (2, 11, rcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **TOL)


def decode_from_empty(rcfg, rparams, toks, mem, max_len=24):
    """The reference's token-by-token decode of ``toks`` from an empty
    cache: (logits per tick, final state)."""
    state = RT.init_decode_state(rcfg, toks.shape[0], max_len,
                                 memory=jnp.asarray(mem), params=rparams)
    logits = []
    for t in range(toks.shape[1]):
        lg, state = RT.decode_step(rcfg, rparams,
                                   jnp.asarray(toks[:, t:t + 1]), state)
        logits.append(np.asarray(lg))
    return logits, state


@pytest.mark.parametrize("depth", DEPTHS)
def test_decode_matches_reference(depth):
    """init_decode_state(memory=, params=) projects every cross block's K/V
    once; 5 ticks of decode_step (self- and cross-attention through the
    flash-decode kernel's plain version) give the reference's logits and
    its caches in its layout: grouped selves, cross blocks, remainder."""
    rcfg, rparams, pcfg, model = pair(ARCH, "flash", num_layers=depth)
    B = 2
    mem, toks = memory_of(rcfg, B), tokens_of(rcfg, B, 5)
    rlogits, rstate = decode_from_empty(rcfg, rparams, toks, mem)
    with torch.no_grad():
        state = PT.init_decode_state(pcfg, B, 24, params=model,
                                     memory=torch.tensor(mem))
        assert state.cross_k.shape == (2, B, rcfg.image_tokens,
                                       rcfg.num_kv_heads, rcfg.head_dim)
        assert state.cross_k[1].is_contiguous()
        for t in range(toks.shape[1]):
            plog, state = PT.decode_step(pcfg, model, t64(toks[:, t:t + 1]),
                                         state)
            np.testing.assert_allclose(plog.numpy(), rlogits[t], **TOL)
    for name in ("attn_k", "attn_v", "cross_k", "cross_v"):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(rstate, name)), **TOL)
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(rstate.pos))


@pytest.mark.parametrize("depth", DEPTHS)
def test_prefill_fills_every_cache_f6(depth):
    """F6: the port's prefill + decode_step equal the reference's
    token-by-token decode (logits and the whole cache, at its layout's
    indices); the reference's own prefill leaves the cache zero, so its
    next decode step does not."""
    rcfg, rparams, pcfg, model = pair(ARCH, "flash", num_layers=depth)
    B, S_ = 2, 6
    mem, toks = memory_of(rcfg, B), tokens_of(rcfg, B, S_ + 1)
    rlogits, rstate = decode_from_empty(rcfg, rparams, toks, mem)
    with torch.no_grad():
        plog, state = PT.prefill(pcfg, model, t64(toks[:, :S_]), 24,
                                 memory=torch.tensor(mem))
        np.testing.assert_allclose(plog[:, -1:].numpy(), rlogits[S_ - 1],
                                   **TOL)
        nlog, state = PT.decode_step(pcfg, model, t64(toks[:, S_:]), state)
    np.testing.assert_allclose(nlog.numpy(), rlogits[S_], **TOL)
    np.testing.assert_allclose(state.attn_k.numpy(),
                               np.asarray(rstate.attn_k), **TOL)
    # the reference's prefill: a zero cache at pos S
    _, pre = RT.prefill(rcfg, rparams, jnp.asarray(toks[:, :S_]), 24,
                        memory=jnp.asarray(mem))
    assert not np.asarray(pre.attn_k).any()
    bad, _ = RT.decode_step(rcfg, rparams, jnp.asarray(toks[:, S_:]), pre)
    assert np.abs(np.asarray(bad) - rlogits[S_]).max() > 10 * TOL["atol"]


@pytest.mark.parametrize("depth", DEPTHS)
def test_grad_step_matches_reference(depth):
    """Every gradient within GRAD_REL of the reference's, the cross blocks'
    and their xgate's among them (nonzero with xgate nonzero)."""
    rcfg, rparams, pcfg, model = pair(ARCH, "flash", num_layers=depth)
    rb, pb = batches(rcfg, 2, 8)
    grads = check_grads(rcfg, rparams, pcfg, model, rb, pb)
    for name in ("cross_blocks.0.xattn.wk", "cross_blocks.1.xgate",
                 f"blocks.{depth - 3}.attn.wq"):
        assert float(grads[name].norm()) > 0, name


def test_trainer_matches_reference_train_step(tmpdir):
    tr = trainer_vs_train_step(ARCH, tmpdir)
    assert tr.step == 3 and tr.model.cross_blocks[0].xgate.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_packages(tmpdir, dtype):
    """In bf16 the f32 ``xgate`` keeps its dtype, and AdamW's f32 master
    copy (every parameter's, xgate's too) crosses with the weights."""
    checkpoints_cross(ARCH, tmpdir, dtype=dtype, param_dtype=dtype)
