"""K4's backward, ``ssd_scan_bwd_plain``, against autograd and the
reference, on the CPU.

``ssd_scan_bwd_plain`` is the chunked backward that the CUDA kernel
(``csrc/ssd_scan_bwd.cu``) computes, written in plain PyTorch; the card
holds the kernel to it (``chip_smoke.py`` phase ``ssd_bwd_kernel``).
Here it is held to (a) autograd through ``ssd_scan_plain`` (the port of
the reference's differentiable ``ssd_chunked``) and (b) ``jax.grad`` of
the reference's sequential oracle ``repro/kernels/ssd_scan/ref.py::
ssd_ref``, whose gradients are finite at any length (it has no masked
exp).  Inputs are made with numpy from a seed, f32; every gradient within
1e-4 of its largest magnitude.  Then F5: at 256 tokens the reference's
``ssd_chunked`` has NaN gradients where the port's are finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_ref
from repro.models.ssm import ssd_chunked
from repro_torch.kernels.ssd_scan import ops

torch.set_num_threads(1)      # tier-1 runs several xdist workers

TOL = 1e-4                    # of max |grad|
NAMES = ("x", "dt", "A", "Bm", "Cm")


def _inputs(seed, B, S, H, P, N, a_scale=0.3):
    """x, dt (post-softplus, in [0.01, 1]), A (negative), Bm, Cm, dy and a
    final-state cotangent, f32 numpy."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, P).astype(np.float32) * 0.5,
            (0.01 + 0.99 * rng.rand(B, S, H)).astype(np.float32),
            (-a_scale * np.arange(1, H + 1)).astype(np.float32),
            rng.randn(B, S, N).astype(np.float32) * 0.3,
            rng.randn(B, S, N).astype(np.float32) * 0.3,
            rng.randn(B, S, H, P).astype(np.float32),
            rng.randn(B, H, P, N).astype(np.float32))


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), name
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= TOL * scale, (name, err, scale)


@pytest.mark.parametrize("S,chunk,with_state", [
    (64, 16, True),       # four full chunks, a seeded final-state cotangent
    (50, 16, True),       # a ragged last chunk (2 of 16 tokens)
    (37, 64, False),      # one chunk shorter than the chunk size
    (90, 32, False),      # ragged, no final-state cotangent
    (40, 7, True),        # a chunk size that divides nothing
])
def test_plain_backward_matches_autograd(S, chunk, with_state):
    x, dt, A, Bm, Cm, dy, ds = _inputs(0, 2, S, 3, 8, 4)
    ts = [torch.tensor(a, requires_grad=True) for a in (x, dt, A, Bm, Cm)]
    y, st = ops.ssd_scan_plain(*ts, chunk=chunk)
    loss = (y * torch.from_numpy(dy)).sum()
    if with_state:
        loss = loss + (st * torch.from_numpy(ds)).sum()
    want = torch.autograd.grad(loss, ts)
    with torch.no_grad():
        got = ops.ssd_scan_bwd_plain(
            *(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
            torch.from_numpy(dy), torch.from_numpy(ds) if with_state else None,
            chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype == torch.float32
        _close(g.numpy(), w.numpy(), name)


@pytest.mark.parametrize("S,chunk", [(48, 16), (45, 16), (33, 64)])
def test_plain_backward_matches_reference_oracle(S, chunk):
    """jax.grad of the sequential recurrence (no chunks, no masked exp)
    against the port's chunked backward, with the same dy; ``ssd_ref``
    returns y only, so the final state's cotangent is zero."""
    x, dt, A, Bm, Cm, dy, _ = _inputs(1, 2, S, 3, 8, 4)

    def f(x_, dt_, A_, B_, C_):
        y = ssd_ref(jnp.moveaxis(x_, 2, 1), jnp.moveaxis(dt_, 2, 1), A_,
                    B_, C_)                                  # (B,H,S,P)
        return jnp.sum(jnp.moveaxis(y, 1, 2) * dy)

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    got = ops.ssd_scan_bwd_plain(
        *(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
        torch.from_numpy(dy), None, chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), np.asarray(w), name)


def test_plain_backward_finite_where_reference_chunked_is_nan():
    """F5: at 256 tokens in one chunk, dt |A| summed above the diagonal
    overflows the reference's exp(seg) and its masked branch's gradient is
    0 * inf = NaN; the port selects before the exp, so its backward stays
    finite and agrees with the oracle."""
    x, dt, A, Bm, Cm, dy, _ = _inputs(2, 1, 256, 2, 4, 4, a_scale=1.0)

    def loss_chunked(x_, dt_, A_, B_, C_):
        y, _ = ssd_chunked(x_, dt_, A_, B_, C_, 256)
        return jnp.sum(y * dy)

    ref = jax.grad(loss_chunked, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    assert not np.isfinite(np.asarray(ref[1])).all()      # ddt: NaN

    def loss_oracle(x_, dt_, A_, B_, C_):
        y = ssd_ref(jnp.moveaxis(x_, 2, 1), jnp.moveaxis(dt_, 2, 1), A_,
                    B_, C_)
        return jnp.sum(jnp.moveaxis(y, 1, 2) * dy)

    want = jax.grad(loss_oracle, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    got = ops.ssd_scan_bwd_plain(
        *(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
        torch.from_numpy(dy), None, chunk=256)
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), np.asarray(w), name)


def test_bwd_wrapper_takes_the_plain_version_on_the_cpu():
    """``ssd_scan_bwd`` on CPU tensors is the plain backward (no saved
    states needed), and counts no launch; dtypes follow the inputs."""
    x, dt, A, Bm, Cm, dy, ds = (torch.from_numpy(a)
                                for a in _inputs(3, 1, 20, 2, 8, 4))
    before = ops.ssd_scan_bwd.launches
    got = ops.ssd_scan_bwd(x.double(), dt, A, Bm.double(), Cm.double(),
                           dy, ds, chunk=8)
    want = ops.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, ds, chunk=8)
    assert ops.ssd_scan_bwd.launches == before
    assert [g.dtype for g in got] == [torch.float64, torch.float32,
                                      torch.float32, torch.float64,
                                      torch.float64]
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), w.numpy(), name)
