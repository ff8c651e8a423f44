"""ctypes bindings of the CUDA flash-attention forward
(``csrc/flash_attention_fwd.cu``), flash-attention backward
(``csrc/flash_attention_bwd.cu``) and flash-decode
(``csrc/flash_decode_fwd.cu``) kernels.

Ports of the Pallas kernels ``repro/kernels/flash_attention/kernel.py::
flash_attention_fwd`` and ``::flash_decode_fwd``, and of the backward rule
``repro/kernels/flash_attention/ops.py::_flash_bwd``.  Each library is built
and loaded at its first launch (``kernels/_build.py``), never at import, so
the CPU tests can import this module.  The kernels read the model layout
(B, S, H, D) directly; ``ops.flash_attention`` and ``ops.flash_decode``
check the arguments before these run.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

LIB = "flash_attention_fwd"
BWD_LIB = "flash_attention_bwd"
DECODE_LIB = "flash_decode_fwd"
HEAD_DIMS = (16, 32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None
_fn = None
_bwd_lib: Optional[ctypes.CDLL] = None
_bwd_fn = None
_decode_lib: Optional[ctypes.CDLL] = None
_decode_fn = None


# query rows per block of the bf16 kernel -> its consumer warpgroups (the
# wgs argument); the f32 kernel has one tile of F32_BLOCK_Q rows
BF16_BLOCK_Q = {64: 1, 128: 2}
F32_BLOCK_Q = 64


def bind(lib: ctypes.CDLL):
    """The typed C entry point ``flash_attention_fwd_wgs`` of a loaded
    library: ``flash_attention_fwd`` with the bf16 kernel's consumer
    warpgroups per block (0: the kernel's default rule) before the stream."""
    fn = lib.flash_attention_fwd_wgs
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp,        # q k v o lse kv_lens
                   ci, ci, ci, ci, ci, ci, ci,    # B H Kh Sq Sk D dtype
                   ctypes.c_float, ci, ci, vp]    # sm_scale causal wgs stream
    fn.restype = ci
    return fn


def warpgroups(dtype: torch.dtype, block_q: Optional[int]) -> int:
    """The ``wgs`` argument for ``block_q`` query rows per block (None: 0,
    the kernel's own rule, 64 rows up to 128 queries and 128 above).
    Raises for rows the kernel of ``dtype`` does not take."""
    if block_q is None:
        return 0
    if dtype == torch.bfloat16:
        rows = BF16_BLOCK_Q
    else:
        rows = {F32_BLOCK_Q: 0}
    if block_q not in rows:
        raise ValueError(f"block_q {block_q}: the {dtype} flash-attention "
                         f"kernel takes {sorted(rows)} query rows a block")
    return rows[block_q]


def _entry():
    global _lib, _fn
    if _fn is None:
        _lib = _build.load(LIB)
        _fn = bind(_lib)
    return _lib, _fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, kv_lens: Optional[torch.Tensor], *,
                        causal: bool, sm_scale: float,
                        lse: Optional[torch.Tensor] = None,
                        block_q: Optional[int] = None) -> None:
    """Launch on the current stream of ``q``'s device and return without
    synchronising.  q/out (B,Sq,H,D), k/v (B,Sk,Kh,D), contiguous, 16-byte
    aligned (the bf16 kernel reads them through tensor maps), one dtype;
    kv_lens (B,) int32 on the same device, or None; lse (B,H,Sq) f32 to
    receive each row's log-sum-exp, or None; ``block_q`` query rows per
    block (``warpgroups``), or None for the kernel's own rule."""
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    wgs = warpgroups(q.dtype, block_q)
    lib, fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _ptr(lse), _ptr(kv_lens), B, H, Kh, Sq, Sk, D,
                 DTYPE_CODES[q.dtype], float(sm_scale), int(causal), wgs,
                 stream)
    _build.check(lib, err, "flash_attention_fwd launch")


def bind_bwd(lib: ctypes.CDLL):
    """The typed C entry point ``flash_attention_bwd`` of a loaded library."""
    fn = lib.flash_attention_bwd
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp,            # q k v o dout
                   vp, vp,                        # lse delta
                   vp, vp, vp, vp,                # dq dk dv kv_lens
                   ci, ci, ci, ci, ci, ci, ci,    # B H Kh Sq Sk D dtype
                   ctypes.c_float, ci, vp]        # sm_scale causal stream
    fn.restype = ci
    return fn


def _bwd_entry():
    global _bwd_lib, _bwd_fn
    if _bwd_fn is None:
        _bwd_lib = _build.load(BWD_LIB)
        _bwd_fn = bind_bwd(_bwd_lib)
    return _bwd_lib, _bwd_fn


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, dq: torch.Tensor,
                        dk: torch.Tensor, dv: torch.Tensor,
                        kv_lens: Optional[torch.Tensor], *, causal: bool,
                        sm_scale: float) -> None:
    """Launch the three backward kernels (delta, dK/dV, dQ) on the current
    stream of ``q``'s device and return without synchronising.  q/o/dout/dq
    (B,Sq,H,D), k/v/dk/dv (B,Sk,Kh,D), contiguous, 16-byte aligned, one
    dtype; lse (B,H,Sq) f32 from the forward; kv_lens (B,) int32 or None.
    The f32 delta scratch (B,H,Sq) is allocated here."""
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib, fn = _bwd_entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(kv_lens),
                 B, H, Kh, Sq, Sk, D, DTYPE_CODES[q.dtype], float(sm_scale),
                 int(causal), stream)
    _build.check(lib, err, "flash_attention_bwd launch")


# K3's keys per split (``split_keys``) and the split blocks it aims for: at
# least DECODE_BLOCKS of them, two for each of the H100's 132 SMs.
SPLIT_KEYS = (256, 128, 64)
DECODE_BLOCKS = 2 * 132


def split_keys(B: int, Kh: int, Sk: int) -> int:
    """Keys per split of the decode kernel: the largest of SPLIT_KEYS that
    gives at least DECODE_BLOCKS (KV head, batch row, split) blocks, else
    the smallest.  From shapes only, never from the lens."""
    for t in SPLIT_KEYS:
        if Kh * B * -(-Sk // t) >= DECODE_BLOCKS:
            return t
    return SPLIT_KEYS[-1]


def decode_workspace_floats(B: int, H: int, Sk: int, D: int, Tk: int) -> int:
    """Floats of f32 workspace the decode kernel needs: each split's
    unnormalised accumulator and its (m, l) per batch row and query head."""
    return B * H * -(-Sk // Tk) * (D + 2)


def bind_decode(lib: ctypes.CDLL):
    """The typed C entry point ``flash_decode_fwd`` of a loaded library."""
    fn = lib.flash_decode_fwd
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp,    # q k v o workspace lse lens
                   ci, ci, ci, ci, ci, ci,        # B H Kh Sk D dtype
                   ctypes.c_float, ci, vp]        # sm_scale Tk stream
    fn.restype = ci
    return fn


def _decode_entry():
    global _decode_lib, _decode_fn
    if _decode_fn is None:
        _decode_lib = _build.load(DECODE_LIB)
        _decode_fn = bind_decode(_decode_lib)
    return _decode_lib, _decode_fn


def flash_decode_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     out: torch.Tensor, lens: torch.Tensor, *,
                     sm_scale: float, split: Optional[int] = None,
                     lse: Optional[torch.Tensor] = None) -> None:
    """Launch the split and combine kernels on the current stream of
    ``q``'s device and return without synchronising.  q/out (B,1,H,D), k/v
    (B,Sk,Kh,D), contiguous, one dtype, 16-byte aligned; lens (B,) int32 on
    the same device.  ``split`` keys per split (default ``split_keys``);
    the f32 workspace is allocated here.  ``lse``, if given, a contiguous
    f32 (B,H,1) the combine writes each row's log-sum-exp into."""
    B, _, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    tk = split_keys(B, Kh, Sk) if split is None else split
    ws = torch.empty(decode_workspace_floats(B, H, Sk, D, tk),
                     dtype=torch.float32, device=q.device)
    lib, fn = _decode_entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), None if lse is None else lse.data_ptr(),
                 lens.data_ptr(), B, H, Kh, Sk, D,
                 DTYPE_CODES[q.dtype], float(sm_scale), tk, stream)
    _build.check(lib, err, "flash_decode_fwd launch")
