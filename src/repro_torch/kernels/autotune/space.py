"""Per-kernel launch-config search spaces + roofline byte accounting.  Port
of ``repro/kernels/autotune/space.py``.

One :class:`KernelSpace` per kernel the reference tunes describes what the
autotuner can vary, how to build representative arguments, how to run a
variant, what the numerical oracle is (the port's plain version), and how
many bytes one call *must* move — the dtype-bytes accounting that turns a
measured time into an achieved fraction of the memory-bandwidth roofline
(``bytes_moved / t / hbm_bw``).  Default shapes are the reference's.

Each variant is the CUDA kernel's own launch knob, not the TPU's block
grid:

  * ``flash_attention`` (K1's forward): query rows per block,
    ``block_q`` 128 (two consumer warpgroups, the default) or 64 (one).
    The key tile is fixed by the kernel (128 keys in bf16), so there is
    no ``block_k``; the f32 kernel has one tile of 64 rows, its only
    variant.
  * ``ssd_scan`` (K4's forward): ``chunk`` 256, 64 or 128.  The forward
    takes any chunk in both dtypes and the bf16 backward takes up to 256
    (``ssd_scan/kernel.py::MAX_CHUNK_BWD_BF16``), so all three stay.
  * ``quantize`` / ``dequantize`` (K2a / K2b): one variant, ``{}``.  The
    kernels have no ``block_rows``: K2a picks its vector path from the
    layout.  The tuner still measures the one launch, since the spill
    advisor prices with its achieved bytes/s.

Arguments are drawn from ``torch.Generator`` seeded 0 on the device under
tuning.  ``run`` calls the wrappers production calls, so a CUDA tensor
launches the kernel and a CPU tensor runs the plain version.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

import torch

from repro_torch.kernels.autotune.table import dtype_name


@dataclass(frozen=True)
class KernelSpace:
    """One kernel's tunable surface."""
    name: str
    variants: Tuple[dict, ...]           # candidate configs, default first
    default: dict
    make_args: Callable[[Sequence[int], object, torch.device], tuple]
    run: Callable[[tuple, dict], object]
    ref: Callable[[tuple], object]
    bytes_moved: Callable[[Sequence[int], object], int]
    default_shape: Tuple[int, ...] = ()
    # dtype name -> variants, where a dtype's kernel takes fewer knobs
    dtype_variants: Tuple[Tuple[str, Tuple[dict, ...]], ...] = ()

    def variants_for(self, dtype) -> Tuple[dict, ...]:
        return dict(self.dtype_variants).get(dtype_name(dtype), self.variants)


def torch_dtype(dtype) -> torch.dtype:
    """``torch.float32`` from ``torch.float32``, ``np.float32`` or
    ``"float32"`` (and likewise bfloat16)."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(
        torch, dtype_name(dtype))


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=torch_dtype(dtype)).element_size()


def _randn(gen, shape, scale, dtype, device):
    return (torch.randn(*shape, generator=gen, device=device)
            * scale).to(torch_dtype(dtype))


def _gen(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


# ------------------------------------------------------- quant_offload
def _quant_args(shape, dtype, device):
    R, F = shape
    return (_randn(_gen(device), (R, F), 0.5, dtype, device),)


def _quant_run(args, config):
    from repro_torch.kernels.quant_offload import ops as Q
    return Q.quantize(args[0])


def _quant_ref(args):
    from repro_torch.kernels.quant_offload import ops as Q
    return Q.quantize_plain(args[0])


def _quant_bytes(shape, dtype) -> int:
    R, F = shape
    # read x (R,F,itemsize) + write int8 payload (R,F) + f32 scales (R,1)
    return R * F * _itemsize(dtype) + R * F + R * 4


def _dequant_args(shape, dtype, device):
    q, s = _quant_ref(_quant_args(shape, dtype, device))
    return (q, s, torch_dtype(dtype))


def _dequant_run(args, config):
    from repro_torch.kernels.quant_offload import ops as Q
    return Q.dequantize(*args)


def _dequant_ref(args):
    from repro_torch.kernels.quant_offload import ops as Q
    return Q.dequantize_plain(*args)


def _dequant_bytes(shape, dtype) -> int:
    R, F = shape
    return R * F + R * 4 + R * F * _itemsize(dtype)


# ----------------------------------------------------- flash_attention
def _flash_args(shape, dtype, device):
    B, S, H, D = shape
    gen, kh = _gen(device), max(H // 2, 1)
    return (_randn(gen, (B, S, H, D), 0.3, dtype, device),
            _randn(gen, (B, S, kh, D), 0.3, dtype, device),
            _randn(gen, (B, S, kh, D), 0.3, dtype, device))


def _flash_run(args, config):
    from repro_torch.kernels.flash_attention import ops as F
    q, k, v = args
    # the forward below the custom op: the variant's rows per block reach
    # the launch without entering the op's schema
    out, _ = F._forward(q, k, v, causal=True,
                        sm_scale=1.0 / math.sqrt(q.shape[-1]), kv_lens=None,
                        with_lse=False, block_q=config["block_q"])
    return out


def _flash_ref(args):
    from repro_torch.kernels.flash_attention import ops as F
    return F.flash_attention_plain(*args, causal=True)


def _flash_bytes(shape, dtype) -> int:
    B, S, H, D = shape
    kh = max(H // 2, 1)
    # q + k + v reads + o write: the memory-roofline lower bound (nothing
    # quadratic touches device memory)
    return (B * S * H * D + 2 * B * S * kh * D + B * S * H * D) * _itemsize(
        dtype)


# ------------------------------------------------------------ ssd_scan
SSD_STATE = 64                           # N of the reference's space


def _ssd_args(shape, dtype, device):
    B, S, H, P = shape
    N, gen = SSD_STATE, _gen(device)
    f32 = torch.float32
    x = _randn(gen, (B, S, H, P), 0.5, dtype, device)
    # dt and A in f32, as the model feeds the kernel (after softplus)
    dt = _randn(gen, (B, S, H), 1.0, f32, device).abs() * 0.1
    A = -(_randn(gen, (H,), 1.0, f32, device).abs() + 0.5)
    Bm = _randn(gen, (B, S, N), 0.3, dtype, device)
    Cm = _randn(gen, (B, S, N), 0.3, dtype, device)
    return (x, dt, A, Bm, Cm)


def _ssd_run(args, config):
    from repro_torch.kernels.ssd_scan import ops as S
    return S.ssd_scan(*args, chunk=config["chunk"])


def _ssd_ref(args):
    from repro_torch.kernels.ssd_scan import ops as S
    return S.ssd_scan_plain(*args)


def _ssd_bytes(shape, dtype) -> int:
    B, S, H, P = shape
    N = SSD_STATE
    # x + Bm + Cm reads and the y write in the activation dtype, dt read in
    # f32 (the reference counts dt in the activation dtype; A negligible)
    return (2 * B * S * H * P + 2 * B * S * N) * _itemsize(dtype) + B * S * H * 4


def _cfgs(key, values) -> Tuple[dict, ...]:
    return tuple({key: v} for v in values)


SPACES: Dict[str, KernelSpace] = {
    "quantize": KernelSpace(
        "quantize", ({},), {}, _quant_args, _quant_run, _quant_ref,
        _quant_bytes, default_shape=(1024, 1024)),
    "dequantize": KernelSpace(
        "dequantize", ({},), {}, _dequant_args, _dequant_run, _dequant_ref,
        _dequant_bytes, default_shape=(1024, 1024)),
    "flash_attention": KernelSpace(
        "flash_attention", _cfgs("block_q", (128, 64)), {"block_q": 128},
        _flash_args, _flash_run, _flash_ref, _flash_bytes,
        default_shape=(1, 256, 4, 64),
        dtype_variants=(("float32", ({"block_q": 64},)),)),
    "ssd_scan": KernelSpace(
        "ssd_scan", _cfgs("chunk", (256, 64, 128)),
        {"chunk": 256}, _ssd_args, _ssd_run, _ssd_ref, _ssd_bytes,
        default_shape=(1, 256, 4, 64)),
}
