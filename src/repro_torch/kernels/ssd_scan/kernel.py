"""ctypes bindings of the CUDA SSD scan (``csrc/ssd_scan_fwd.cu``) and its
backward (``csrc/ssd_scan_bwd.cu``).

The forward ports the Pallas kernel ``repro/kernels/ssd_scan/kernel.py::
ssd_scan_fwd``; the backward computes what ``jax.grad`` of
``repro/models/ssm.py::ssd_chunked`` does, which has no Pallas kernel.
The libraries are built and loaded at the first launch
(``kernels/_build.py``), never at import, so the CPU tests can import this
module.  The kernels read x, dt, Bm and Cm in the model layout through
their strides; ``ops`` checks the arguments and allocates the scratch of
the bf16 passes (``scratch_floats``: what a backward reads, also
``saved_floats``), their dS buffer (``ds_floats``) and the backward's
workspace (``bwd_workspace_floats``) before these run.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

LIB = "ssd_scan_fwd"
BWD_LIB = "ssd_scan_bwd"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 128                 # NMAX of the kernel; N a multiple of 4
MAX_HEAD_DIM_BWD = 64           # PMAX of the backward
MAX_CHUNK_BWD_BF16 = 256        # CHUNK_WG of the backward's bf16 passes

_lib: Optional[ctypes.CDLL] = None
_fn = None
_scratch_fn = None
_bwd_lib: Optional[ctypes.CDLL] = None
_bwd_fn = None
_work_fn = None


def bind(lib: ctypes.CDLL):
    """The typed C entry points ``ssd_scan_fwd`` and
    ``ssd_scan_scratch_floats`` of a loaded library."""
    fn = lib.ssd_scan_fwd
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([vp] * 9                       # x dt A Bm Cm y state scratch ds
                   + [ci] * 6                     # B S H P N chunk
                   + [cl] * 10                    # strides of x, dt, Bm, Cm
                   + [ci, vp])                    # dtype stream
    fn.restype = ci
    size = lib.ssd_scan_scratch_floats
    size.argtypes, size.restype = [ci] * 7, cl    # B S H P N chunk dtype
    return fn, size


def _entry():
    global _lib, _fn, _scratch_fn
    if _fn is None:
        _lib = _build.load(LIB)
        _fn, _scratch_fn = bind(_lib)
    return _lib, _fn


def scratch_floats(B: int, S: int, H: int, P: int, N: int, chunk: int,
                   dtype: torch.dtype) -> int:
    """Floats of device scratch ``ssd_scan_fwd`` needs for these shapes (0
    for float32, whose kernel needs none): the incoming states, CB and cs.
    A bf16 call also needs a dS buffer (``ds_floats``)."""
    _entry()
    return int(_scratch_fn(B, S, H, P, N, chunk, DTYPE_CODES[dtype]))


def saved_floats(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """Floats of the scratch a forward keeps for its backward, in either
    dtype: the bf16 passes' layout (the incoming states, CB, cs), which the
    f32 kernel also fills when given it."""
    return scratch_floats(B, S, H, P, N, chunk, torch.bfloat16)


def ds_floats(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """Floats of the dS buffer of a bf16 forward, (B, nc, H, P, N): each
    chunk's own state contribution, dead once the call returns."""
    return B * -(-S // chunk) * H * P * N


def bind_bwd(lib: ctypes.CDLL):
    """The typed C entry points ``ssd_scan_bwd`` and
    ``ssd_scan_bwd_workspace_floats`` of a loaded library."""
    fn = lib.ssd_scan_bwd
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([vp] * 14       # x dt A Bm Cm dy dfinal saved work dx ddt dA dB dC
                   + [ci] * 6      # B S H P N chunk
                   + [cl] * 10     # strides of x, dt, Bm, Cm
                   + [ci, vp])     # dtype stream
    fn.restype = ci
    size = lib.ssd_scan_bwd_workspace_floats
    size.argtypes, size.restype = [ci] * 7, cl    # B S H P N chunk dtype
    return fn, size


def _bwd_entry():
    global _bwd_lib, _bwd_fn, _work_fn
    if _bwd_fn is None:
        _bwd_lib = _build.load(BWD_LIB)
        _bwd_fn, _work_fn = bind_bwd(_bwd_lib)
    return _bwd_lib, _bwd_fn


def bwd_workspace_floats(B: int, S: int, H: int, P: int, N: int,
                         chunk: int, dtype: torch.dtype) -> int:
    """Floats of device workspace ``ssd_scan_bwd`` needs for these shapes
    and dtype."""
    _bwd_entry()
    return int(_work_fn(B, S, H, P, N, chunk, DTYPE_CODES[dtype]))


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, y: torch.Tensor,
                 state: torch.Tensor, scratch: Optional[torch.Tensor],
                 ds: Optional[torch.Tensor], *, chunk: int) -> None:
    """Launch on the current stream of ``x``'s device and return without
    synchronising.  x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, Bm/Cm (B,S,N)
    in x's dtype, each with unit stride in its last dim; y (B,S,H,P)
    contiguous in x's dtype; state (B,H,P,N) contiguous f32; scratch at
    least ``scratch_floats(...)`` f32 on the same device (None when that is
    0, or ``saved_floats(...)`` for a forward whose backward follows); ds
    at least ``ds_floats(...)`` f32 for bf16 (else None)."""
    B, S, H, P = x.shape
    N = Bm.shape[2]
    lib, fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 None if ds is None else ds.data_ptr(),
                 B, S, H, P, N, int(chunk),
                 *x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                 *Cm.stride()[:2], DTYPE_CODES[x.dtype], stream)
    _build.check(lib, err, "ssd_scan_fwd launch")


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                 dfinal: Optional[torch.Tensor], saved: torch.Tensor,
                 work: torch.Tensor, dx: torch.Tensor, ddt: torch.Tensor,
                 dA: torch.Tensor, dB: torch.Tensor, dC: torch.Tensor, *,
                 chunk: int) -> None:
    """Launch the backward on the current stream of ``x``'s device and
    return without synchronising.  x, dt, A, Bm, Cm as for ``ssd_scan_fwd``;
    dy, dx (B,S,H,P) contiguous in x's dtype; dfinal (B,H,P,N) f32
    contiguous and 16-byte aligned, or None; saved: the forward's scratch
    (``saved_floats``, read only); work at least
    ``bwd_workspace_floats(...)`` f32; ddt (B,S,H) and dA (H,) f32, dB and
    dC (B,S,N) in x's dtype, all contiguous."""
    B, S, H, P = x.shape
    N = Bm.shape[2]
    lib, fn = _bwd_entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), dy.data_ptr(),
                 None if dfinal is None else dfinal.data_ptr(),
                 saved.data_ptr(), work.data_ptr(), dx.data_ptr(),
                 ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                 B, S, H, P, N, int(chunk),
                 *x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                 *Cm.stride()[:2], DTYPE_CODES[x.dtype], stream)
    _build.check(lib, err, "ssd_scan_bwd launch")
