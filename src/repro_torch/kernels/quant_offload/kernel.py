"""ctypes binding of the CUDA int8 quantize/dequantize (``csrc/quant_offload.cu``).

Port of the Pallas kernels ``repro/kernels/quant_offload/kernel.py::
quantize_fwd`` (K2a) and ``dequantize_fwd`` (K2b).  The library is built
and loaded at the first launch (``kernels/_build.py``), never at import, so
the CPU tests can import this module.  ``ops.py`` checks the arguments and
works out the row layout before these run.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

LIB = "quant_offload"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None
_quant = _dequant = None


def bind(lib: ctypes.CDLL):
    """The typed C entry points ``quantize_rows`` and ``dequantize_rows`` of
    a loaded library."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    quant = lib.quantize_rows
    quant.argtypes = [vp, ci, cl, cl, cl, ci, vp, vp, vp]
    quant.restype = ci                    # x dtype rows rpo stride F q s stream
    dequant = lib.dequantize_rows
    dequant.argtypes = [vp, vp, ci, cl, cl, cl, ci, vp, vp]
    dequant.restype = ci                  # q s dtype rows rpo stride F out stream
    return quant, dequant


def _entry():
    global _lib, _quant, _dequant
    if _lib is None:
        lib = _build.load(LIB)
        _quant, _dequant = bind(lib)
        _lib = lib
    return _lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def quantize_rows(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, *,
                  rows: int, rows_per_outer: int, outer_stride: int,
                  features: int) -> None:
    """Launch K2a on the current stream of ``x``'s device; no sync."""
    lib = _entry()
    with torch.cuda.device(x.device):
        err = _quant(x.data_ptr(), DTYPE_CODES[x.dtype], rows, rows_per_outer,
                     outer_stride, features, q.data_ptr(), scales.data_ptr(),
                     _stream(x))
    _build.check(lib, err, "quantize_rows launch")


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor, out: torch.Tensor,
                    *, rows: int, rows_per_outer: int, outer_stride: int,
                    features: int) -> None:
    """Launch K2b on the current stream of ``q``'s device; no sync."""
    lib = _entry()
    with torch.cuda.device(q.device):
        err = _dequant(q.data_ptr(), scales.data_ptr(), DTYPE_CODES[out.dtype],
                       rows, rows_per_outer, outer_stride, features,
                       out.data_ptr(), _stream(q))
    _build.check(lib, err, "dequantize_rows launch")
