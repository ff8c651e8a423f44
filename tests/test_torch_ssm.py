"""The port's SSD scan (K4) and Mamba-2 (ssm) family against the reference,
on the CPU.

Kernel: the port's plain version and wrapper against the reference's
``ssd_scan`` (its Pallas kernel in interpret mode) and ``ssd_ref`` for y,
and against ``ssd_chunked`` for y and the final state.  Model: reduced
``mamba2-780m`` in f32, weights drawn by the reference and passed to the
port through numpy (``params_from_reference``), the same token streams
through both.  The CUDA kernel itself is checked against its plain version
by ``tests/test_torch_cuda_kernels.py`` (marked ``cuda``) and by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as PC
from repro.kernels.ssd_scan.ops import ssd_scan as ref_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref
from repro.models import transformer as RT
from repro.models.registry import get_api as ref_get_api
from repro.models.ssm import ssd_chunked
from repro.runtime.server import Server as RefServer
from repro_torch.kernels.ssd_scan import ops
from repro_torch.models import transformer as PT
from repro_torch.models.convert import (decode_state_from_reference,
                                        params_from_reference)
from repro_torch.runtime.server import Server

torch.set_num_threads(1)      # tier-1 runs several xdist workers

# tests/test_kernels.py::test_ssd_scan_sweep: (B, S, H, P, N, chunk)
SWEEP = [
    (2, 256, 3, 32, 16, 64),
    (1, 128, 2, 64, 32, 128),
    (1, 100, 1, 16, 8, 32),             # padded tail
    (2, 64, 4, 32, 128, 64),            # big state
]
TOL = dict(rtol=2e-3, atol=2e-3)      # f32 on both sides; summation order only


def _ssd_inputs(seed, B, S, H, P, N):
    """The reference sweep's distributions."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, P).astype(np.float32) * 0.5,
            np.abs(rng.randn(B, S, H)).astype(np.float32) * 0.1,
            -(np.abs(rng.randn(H)) + 0.5).astype(np.float32),
            rng.randn(B, S, N).astype(np.float32) * 0.3,
            rng.randn(B, S, N).astype(np.float32) * 0.3)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_ssd_plain_matches_reference_kernel_oracle_and_model(B, S, H, P, N,
                                                             chunk):
    x, dt, A, Bm, Cm = _ssd_inputs(0, B, S, H, P, N)
    j = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    ref_kernel = ref_ssd_scan(*j, chunk=chunk)
    oracle = jnp.transpose(ssd_ref(jnp.transpose(j[0], (0, 2, 1, 3)),
                                   jnp.transpose(j[1], (0, 2, 1)), *j[2:]),
                           (0, 2, 1, 3))
    y_model, state_model = ssd_chunked(*j, chunk)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    y, state = ops.ssd_scan_plain(*t, chunk=chunk)
    wy, wstate = ops.ssd_scan(*t, chunk=chunk)
    assert y.shape == (B, S, H, P) and state.shape == (B, H, P, N)
    assert state.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_kernel), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(oracle), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_model), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(state_model), **TOL)
    np.testing.assert_array_equal(wy.numpy(), y.numpy())
    np.testing.assert_array_equal(wstate.numpy(), state.numpy())


def test_ssd_final_state_is_the_state_after_the_last_token():
    """A ragged tail (S 100, chunk 32): the final state equals the
    sequential recurrence's state after token S - 1, and the state of a
    prefix continues into the rest of the sequence."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _ssd_inputs(1, 1, 100, 2, 16, 8))
    _, state = ops.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=32)
    s = torch.zeros(1, 2, 16, 8)
    for t in range(100):
        s = (s * torch.exp(dt[:, t] * A)[:, :, None, None]
             + torch.einsum("bhp,bn->bhpn", x[:, t] * dt[:, t, :, None],
                            Bm[:, t]))
    np.testing.assert_allclose(state.numpy(), s.numpy(), **TOL)


@pytest.mark.parametrize("chunk", [16, 32, 100])
def test_ssd_chunk_size_invariance_and_strided_inputs(chunk):
    """y and the state do not depend on the chunk size, and x, Bm and Cm
    passed as views into one tensor (as the model passes them) give what
    contiguous copies give."""
    B, S, H, P, N = 2, 100, 3, 16, 8
    x, dt, A, Bm, Cm = _ssd_inputs(2, B, S, H, P, N)
    xbc = torch.from_numpy(np.concatenate(
        [x.reshape(B, S, H * P), Bm, Cm], axis=-1))
    xv = xbc[..., :H * P].reshape(B, S, H, P)
    Bv, Cv = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    assert not (xv.is_contiguous() or Bv.is_contiguous())
    y, st = ops.ssd_scan(xv, torch.from_numpy(dt), torch.from_numpy(A), Bv,
                         Cv, chunk=chunk)
    y64, st64 = ops.ssd_scan(*(torch.from_numpy(a)
                               for a in (x, dt, A, Bm, Cm)), chunk=64)
    np.testing.assert_allclose(y.numpy(), y64.numpy(), **TOL)
    np.testing.assert_allclose(st.numpy(), st64.numpy(), **TOL)


def test_ssd_cuda_path_raises_instead_of_falling_back(monkeypatch):
    """A non-CPU tensor never reaches the plain versions: without grad the
    forward launch raises (no card here); with an input that needs grad the
    call goes to ``_SSDScanFn``, whose forward keeps the backward's states
    (``keep=True``), and never to the differentiable plain scan."""
    def fail(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")
    monkeypatch.setattr(ops, "ssd_scan_plain", fail)
    monkeypatch.setattr(ops, "ssd_scan_bwd_plain", fail)
    x = torch.empty(1, 8, 2, 16, device="meta")
    dt = torch.empty(1, 8, 2, device="meta")
    A = torch.empty(2, device="meta")
    Bm = torch.empty(1, 8, 4, device="meta")
    before = ops.ssd_scan.launches
    with pytest.raises(RuntimeError):
        ops.ssd_scan(x, dt, A, Bm, Bm, chunk=4)
    assert ops.ssd_scan.launches == before

    calls = []
    real = ops._forward

    def spy(*a, keep):
        calls.append((keep, torch.is_grad_enabled()))
        return real(*a, keep=keep)
    monkeypatch.setattr(ops, "_forward", spy)
    xg = x.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.ssd_scan(xg, dt, A, Bm, Bm, chunk=4)
    # inside the Function's forward: the kept states, autograd off
    assert calls == [(True, False)]
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.ssd_scan_bwd(x, dt, A, Bm, Bm, torch.empty_like(x), chunk=4,
                         saved=torch.empty(0, device="meta"))
    assert ops.ssd_scan.launches == before


def test_ssd_rejects_bad_shapes():
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _ssd_inputs(3, 1, 16, 2, 8, 4))
    with pytest.raises(ValueError, match="disagree"):
        ops.ssd_scan(x, dt[:, :8], A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="positive"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=0)
    # off the CPU an input that requires grad goes to the kernel pair (K4
    # and its backward), whose launch takes only one CUDA device: a meta
    # tensor raises rather than run the plain scan
    xm, dtm, Am, Bmm = (torch.empty(t.shape, device="meta", requires_grad=True)
                        for t in (x, dt, A, Bm))
    with pytest.raises(RuntimeError, match="one CUDA device"):
        ops.ssd_scan(xm, dtm, Am, Bmm, Bmm, chunk=8)
    with pytest.raises(ValueError, match="disagree"):
        ops.ssd_scan_bwd(x, dt[:, :8], A, Bm, Cm, x, chunk=8)


# ------------------------------------------------------- reduced mamba2-780m
@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference params, port cfg, port model)."""
    rcfg = RC.get_reduced("mamba2_780m")
    rparams, _ = ref_get_api(rcfg).init(rcfg, jax.random.PRNGKey(0))
    pcfg = PC.get_reduced("mamba2_780m")
    model = params_from_reference(pcfg, jax.tree.map(np.asarray, rparams),
                                  device="cpu")
    return rcfg, rparams, pcfg, model


def _tokens(seed, B, S, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, S)
                                               ).astype(np.int32)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.int64)


def test_converted_model_keeps_f32_leaves_and_counts_params(pair):
    _, _, pcfg, model = pair
    ssm = model.blocks[0].ssm
    assert all(getattr(ssm, n).dtype == torch.float32
               for n in ("A_log", "dt_bias", "D"))
    assert not hasattr(model.embed, "unembed")          # tied
    assert sum(p.numel() for p in model.parameters()) == pcfg.param_count()
    full = PC.get_config("mamba2-780m")
    bf16 = PT.Model(full.replace(num_layers=1), generator=None,
                    device=torch.device("meta"))
    assert bf16.blocks[0].ssm.in_proj.dtype == torch.bfloat16
    assert bf16.blocks[0].ssm.A_log.dtype == torch.float32


@pytest.mark.parametrize("S", [37, 70])
def test_forward_logits_match_reference(pair, S):
    """S 70 spans three chunks of 32 with a ragged tail."""
    rcfg, rparams, pcfg, model = pair
    toks = _tokens(S, 2, S, rcfg.vocab_size)
    ref, _ = RT.forward(rcfg, rparams, jnp.asarray(toks))
    with torch.no_grad():
        out, aux = PT.forward(pcfg, model, _t(toks))
    assert out.shape == (2, S, rcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("S", [2, 45])
def test_prefill_state_and_decode_match_reference(pair, S):
    """prefill logits, ssm_conv (a prompt shorter than the conv window
    included) and ssm_ssd, then token-by-token decode_step."""
    rcfg, rparams, pcfg, model = pair
    toks = _tokens(S + 1, 2, S, rcfg.vocab_size)
    rlog, rstate = RT.prefill(rcfg, rparams, jnp.asarray(toks), 64)
    with torch.no_grad():
        plog, pstate = PT.prefill(pcfg, model, _t(toks), 64)
    assert pstate.attn_k is None and pstate.attn_v is None
    np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **TOL)
    np.testing.assert_allclose(pstate.ssm_conv.numpy(),
                               np.asarray(rstate.ssm_conv), **TOL)
    np.testing.assert_allclose(pstate.ssm_ssd.numpy(),
                               np.asarray(rstate.ssm_ssd), **TOL)
    np.testing.assert_array_equal(pstate.pos.numpy(), np.asarray(rstate.pos))
    nxt = np.asarray(jnp.argmax(rlog[:, -1], axis=-1))[:, None]
    for _ in range(3):
        rlog, rstate = RT.decode_step(rcfg, rparams,
                                      jnp.asarray(nxt, jnp.int32), rstate)
        with torch.no_grad():
            plog, pstate = PT.decode_step(pcfg, model, _t(nxt), pstate)
        np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **TOL)
        np.testing.assert_allclose(pstate.ssm_ssd.numpy(),
                                   np.asarray(rstate.ssm_ssd), **TOL)
        np.testing.assert_allclose(pstate.ssm_conv.numpy(),
                                   np.asarray(rstate.ssm_conv), **TOL)
        nxt = np.asarray(jnp.argmax(rlog[:, -1], axis=-1))[:, None]


def test_decode_matches_forward(pair):
    """Port of tests/test_models_smoke.py::test_decode_matches_forward_ssm:
    token-by-token decode logits equal the full forward's, at 5e-3."""
    _, _, pcfg, model = pair
    toks = _t(_tokens(7, 1, 8, pcfg.vocab_size))
    with torch.no_grad():
        full, _ = PT.forward(pcfg, model, toks)
        state = PT.init_decode_state(pcfg, 1, 16, device="cpu")
        outs = []
        for t in range(toks.shape[1]):
            lg, state = PT.decode_step(pcfg, model, toks[:, t:t + 1], state)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(full.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=5e-3, atol=5e-3)


def test_decode_from_converted_reference_state(pair):
    """A reference prefill state converted to the port decodes to the
    reference's logits."""
    rcfg, rparams, pcfg, model = pair
    toks = _tokens(9, 2, 20, rcfg.vocab_size)
    rlog, rstate = RT.prefill(rcfg, rparams, jnp.asarray(toks), 32)
    pstate = decode_state_from_reference(
        jax.tree.map(lambda a: None if a is None else np.asarray(a), rstate),
        device="cpu")
    nxt = np.asarray(jnp.argmax(rlog[:, -1], axis=-1))[:, None]
    rlog, _ = RT.decode_step(rcfg, rparams, jnp.asarray(nxt, jnp.int32),
                             rstate)
    with torch.no_grad():
        plog, _ = PT.decode_step(pcfg, model, _t(nxt), pstate)
    np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **TOL)


def _serve(server_cls, cfg, params, prompts, new_tokens, max_batch=2,
           max_len=32):
    srv = server_cls(cfg, params, max_batch=max_batch, max_len=max_len)
    rids = [srv.submit(p, max_new_tokens=n) for p, n in zip(prompts, new_tokens)]
    out = srv.run_until_done()
    return [out[r] for r in rids]


def test_server_matches_reference(pair):
    """3 requests over 2 slots: the port's Server emits the reference
    Server's greedy tokens."""
    rcfg, rparams, pcfg, model = pair
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, rcfg.vocab_size, size=n) for n in (5, 9, 7)]
    ref = _serve(RefServer, rcfg, rparams, prompts, [4, 4, 4])
    got = _serve(Server, pcfg, model, prompts, [4, 4, 4])
    assert got == ref


def test_serve_cli_on_cpu():
    from repro_torch.launch import serve
    stats = serve.main(["--arch", "mamba2-780m", "--reduced", "--device",
                        "cpu", "--requests", "3", "--max-batch", "2",
                        "--new-tokens", "3", "--max-len", "32"])
    assert stats["completed"] == 3 and stats["arch"] == "mamba2-780m"
    assert all(len(v) == 3 for v in stats["results"].values())
    assert stats["latency"]["prefill_ms"]["n"] == 3
