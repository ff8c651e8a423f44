"""Row-wise symmetric int8 quantize / dequantize, their plain versions, and
the compressed-offload site helper.

Port of ``repro/kernels/quant_offload/ops.py``.  Rows are the flattened
leading dims of ``x``, F its last dim; the scale is ``max(absmax, 1e-12) /
127`` per row in f32, ``q = clip(round_half_even(x / scale), ±127)`` in
int8, and ``dequantize`` returns ``q * scale`` cast to the output dtype.
Shapes follow the reference: ``quantize(x)`` gives q of ``x.shape`` and
scales of ``x.shape[:-1] + (1,)``.

``quantize`` and ``dequantize`` take CPU tensors to ``quantize_plain`` /
``dequantize_plain`` and launch the CUDA kernels (K2a, K2b) for CUDA
tensors, with no fallback; any other device raises.  On the card they take
f32 or bf16 and a row layout of contiguous rows, either one contiguous run
or runs along the leading dim with any stride there: a KV slot row
``cache[:, b]`` is quantized, and restored, in place (see
``csrc/quant_offload.cu``).  ``quantize.launches`` and
``dequantize.launches`` count kernel launches.  The reference's
autotuned ``block_rows`` has no counterpart: the kernels choose their
lanes a row from the layout, so the autotuner measures the one launch
(its achieved bytes/s prices ``spill_compression="auto"``).  The wrappers
look their shape up in the installed table all the same, and
``quantize.tuned_launches`` / ``dequantize.tuned_launches`` count the
launches that had an entry there.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.sites import tag
from repro_torch.kernels.autotune.table import tuned_config
from repro_torch.kernels.quant_offload import kernel as K


def _rows(x: torch.Tensor) -> Tuple[int, int]:
    if x.dim() == 0 or x.shape[-1] == 0:
        raise ValueError(f"want (..., F) with F > 0, got {tuple(x.shape)}")
    F = x.shape[-1]
    return x.numel() // F, F


def _layout(x: torch.Tensor) -> Tuple[int, int]:
    """(rows_per_outer, outer_stride) of the kernels' row layout: one
    contiguous run, or runs of contiguous rows along dim 0 with any stride
    there.  Raises for any other layout."""
    R, F = _rows(x)
    if x.is_contiguous():
        return max(R, 1), max(R, 1) * F
    if x.dim() >= 2 and x[0].is_contiguous() and x.shape[0] > 1:
        rpo = math.prod(x.shape[1:-1])
        if x.stride(0) >= rpo * F:
            return rpo, x.stride(0)
    raise ValueError(
        f"the int8 kernels take contiguous rows, in one run or in runs along "
        f"dim 0; got shape {tuple(x.shape)} strides {x.stride()}")


def _check_cuda(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors on one device, False for CPU tensors; raises
    for anything else (no fallback)."""
    devs = {t.device for t in ts}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise RuntimeError(f"the int8 kernels run on one CUDA device or on "
                           f"the CPU; got {sorted(map(str, devs))}")
    return True


def _check_dtype(dtype: torch.dtype, what: str) -> None:
    if dtype not in K.DTYPE_CODES:
        raise TypeError(f"{what} must be float32 or bfloat16 on the card, "
                        f"got {dtype}")


# ------------------------------------------------------------ plain versions
def quantize_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2a.  The divisor 127 is a tensor, not a
    Python number: on CUDA, PyTorch turns division by a CPU scalar into a
    multiplication by its reciprocal, which is not the IEEE quotient."""
    _rows(x)
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = (torch.clamp(amax, min=1e-12)
             / torch.full((), 127.0, dtype=torch.float32, device=x.device))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_plain(q: torch.Tensor, scales: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of K2b."""
    return (q.float() * scales.float()).to(out_dtype)


# ----------------------------------------------------------------- wrappers
def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., F) -> (q int8 (..., F), scales f32 (..., 1)), both contiguous."""
    R, F = _rows(x)
    if not _check_cuda(x):
        return quantize_plain(x)
    _check_dtype(x.dtype, "quantize's input")
    rpo, stride = _layout(x)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    if R:
        K.quantize_rows(x, q, s, rows=R, rows_per_outer=rpo,
                        outer_stride=stride, features=F)
        quantize.launches += 1
        if tuned_config("quantize", (R, F), x.dtype) is not None:
            quantize.tuned_launches += 1
    return q, s


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None, *,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q int8 (..., F), scales (..., 1) -> ``q * scales`` in ``out_dtype``,
    or written into ``out`` (a tensor of q's shape, in any row layout
    ``quantize`` takes) and returned."""
    R, F = _rows(q)
    if out is None and out_dtype is None:
        raise TypeError("dequantize needs out_dtype or out")
    if out is not None and tuple(out.shape) != tuple(q.shape):
        raise ValueError(f"out {tuple(out.shape)} != q {tuple(q.shape)}")
    if scales.numel() != R:
        raise ValueError(f"{R} rows but {scales.numel()} scales")
    if not _check_cuda(q, scales, *(() if out is None else (out,))):
        x = dequantize_plain(q, scales.reshape(q.shape[:-1] + (1,)),
                             out_dtype if out is None else out.dtype)
        return x if out is None else out.copy_(x)
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"want int8 q and float32 scales, got {q.dtype}, "
                        f"{scales.dtype}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequantize takes a contiguous payload and scales")
    if out is None:
        out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    _check_dtype(out.dtype, "dequantize's output")
    rpo, stride = _layout(out)
    if R:
        K.dequantize_rows(q, scales, out, rows=R, rows_per_outer=rpo,
                          outer_stride=stride, features=F)
        dequantize.launches += 1
        if tuned_config("dequantize", (R, F), out.dtype) is not None:
            dequantize.tuned_launches += 1
    return out


quantize.launches = quantize.tuned_launches = 0
dequantize.launches = dequantize.tuned_launches = 0


# ------------------------------------------------------ compressed offload
class _CompressedOffload(torch.autograd.Function):
    """Forward ``dequantize(quantize(x))``; backward the identity, the
    straight-through gradient of the reference's custom vjp."""

    @staticmethod
    def forward(ctx, x):
        q, s = quantize(x)
        return dequantize(q, s, x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def compressed_offload(x: torch.Tensor, site: str) -> torch.Tensor:
    """Swap-compression boundary at ``site``: the value becomes
    ``dequantize(quantize(x))`` (lossy, at most half a quantization step
    per element) and the gradient passes straight through.  The reference
    also names the int8 pair after the site so its swap policy offloads
    it; that labelling comes with the executor slice (``core/sites.py``)."""
    tag(x, site)
    return _CompressedOffload.apply(x)
