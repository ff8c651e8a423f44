"""ctypes binding of the CUDA SSD scan (``csrc/ssd_scan_fwd.cu``).

Port of the Pallas kernel ``repro/kernels/ssd_scan/kernel.py::
ssd_scan_fwd``.  The library is built and loaded at the first launch
(``kernels/_build.py``), never at import, so the CPU tests can import this
module.  The kernels read x, dt, Bm and Cm in the model layout through
their strides; ``ops.ssd_scan`` checks the arguments and allocates the
scratch of the bf16 passes (``scratch_floats``) before this runs.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

LIB = "ssd_scan_fwd"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 128                 # NMAX of the kernel; N a multiple of 4

_lib: Optional[ctypes.CDLL] = None
_fn = None
_scratch_fn = None


def bind(lib: ctypes.CDLL):
    """The typed C entry points ``ssd_scan_fwd`` and
    ``ssd_scan_scratch_floats`` of a loaded library."""
    fn = lib.ssd_scan_fwd
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([vp] * 8                       # x dt A Bm Cm y state scratch
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
    for float32, whose kernel needs none)."""
    _entry()
    return int(_scratch_fn(B, S, H, P, N, chunk, DTYPE_CODES[dtype]))


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, y: torch.Tensor,
                 state: torch.Tensor, scratch: Optional[torch.Tensor], *,
                 chunk: int) -> None:
    """Launch on the current stream of ``x``'s device and return without
    synchronising.  x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, Bm/Cm (B,S,N)
    in x's dtype, each with unit stride in its last dim; y (B,S,H,P)
    contiguous in x's dtype; state (B,H,P,N) contiguous f32; scratch at
    least ``scratch_floats(...)`` f32 on the same device (None when that is
    0)."""
    B, S, H, P = x.shape
    N = Bm.shape[2]
    lib, fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 B, S, H, P, N, int(chunk),
                 *x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                 *Cm.stride()[:2], DTYPE_CODES[x.dtype], stream)
    _build.check(lib, err, "ssd_scan_fwd launch")
