"""ctypes binding of the CUDA SSD scan (``csrc/ssd_scan_fwd.cu``).

Port of the Pallas kernel ``repro/kernels/ssd_scan/kernel.py::
ssd_scan_fwd``.  The library is built and loaded at the first launch
(``kernels/_build.py``), never at import, so the CPU tests can import this
module.  The kernel reads x, dt, Bm and Cm in the model layout through
their strides; ``ops.ssd_scan`` checks the arguments before this runs.
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


def bind(lib: ctypes.CDLL):
    """The typed C entry point ``ssd_scan_fwd`` of a loaded library."""
    fn = lib.ssd_scan_fwd
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([vp] * 7                       # x dt A Bm Cm y state
                   + [ci] * 6                     # B S H P N chunk
                   + [cl] * 10                    # strides of x, dt, Bm, Cm
                   + [ci, vp])                    # dtype stream
    fn.restype = ci
    return fn


def _entry():
    global _lib, _fn
    if _fn is None:
        _lib = _build.load(LIB)
        _fn = bind(_lib)
    return _lib, _fn


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, y: torch.Tensor,
                 state: torch.Tensor, *, chunk: int) -> None:
    """Launch on the current stream of ``x``'s device and return without
    synchronising.  x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, Bm/Cm (B,S,N)
    in x's dtype, each with unit stride in its last dim; y (B,S,H,P)
    contiguous in x's dtype; state (B,H,P,N) contiguous f32."""
    B, S, H, P = x.shape
    N = Bm.shape[2]
    lib, fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                 B, S, H, P, N, int(chunk),
                 *x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                 *Cm.stride()[:2], DTYPE_CODES[x.dtype], stream)
    _build.check(lib, err, "ssd_scan_fwd launch")
