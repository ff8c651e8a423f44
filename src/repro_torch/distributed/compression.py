"""Cross-pod gradient compression with error feedback (beyond-paper).

Port of ``repro/distributed/compression.py``.  The pod dim is the slow
link at multi-pod scale.  Instead of an f32/bf16 all-reduce across pods,
each pod quantizes its local gradient partial to int8 (+ per-row f32
scales), all-gathers the *int8* payload across the pod dim (wire bytes
÷ 2–4), and reduces locally after dequantization.  Error feedback
accumulates the quantization residual into the next step so the
compression bias telescopes away (EF-SGD).

The reference's ``_quant_rows`` is K2a's function (``scale = max(amax,
1e-12) / 127``, round half to even, ±127), so the port quantizes through
``kernels.quant_offload.ops.quantize`` (K2a on the card, its plain version
on the CPU) and dequantizes every gathered slab, and the residual, through
``ops.dequantize`` (K2b) in f32.  The payload and the scales cross the wire
through ``all_gather_into_tensor`` over the pod dim's process group, the
payload as int8.  ``stats`` counts the bytes each kind put on the wire and
the dtype of the last gathered payload.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.kernels.quant_offload import ops as qops

stats: Dict[str, object] = {"payload_bytes": 0, "scale_bytes": 0,
                            "payload_dtype": None}


def reset_stats() -> None:
    stats.update(payload_bytes=0, scale_bytes=0, payload_dtype=None)


def _rows(g: torch.Tensor) -> torch.Tensor:
    F = g.shape[-1] if g.dim() > 1 else g.numel()
    return g.reshape(-1, F).to(torch.float32).contiguous()


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x``, in the group's rank order."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.view((n,) + tuple(x.shape))


def _gathered_sum(q: torch.Tensor, s: torch.Tensor, group,
                  dequantize=qops.dequantize) -> torch.Tensor:
    """Gather the int8 rows and their scales over ``group``, dequantize each
    slab (K2b) and sum them in the group's rank order."""
    qg = _all_gather(q, group)                 # (pods, R, F) int8 on the wire
    sg = _all_gather(s, group)                 # (pods, R, 1) f32 (tiny)
    stats["payload_bytes"] += qg.numel() * qg.element_size()
    stats["scale_bytes"] += sg.numel() * sg.element_size()
    stats["payload_dtype"] = qg.dtype
    total = None
    for i in range(qg.shape[0]):
        part = dequantize(qg[i], sg[i], torch.float32)
        total = part if total is None else total + part
    return total


def _compressed_allreduce_leaf(g: torch.Tensor, group) -> torch.Tensor:
    q, s = qops.quantize(_rows(g))
    return _gathered_sum(q, s, group).reshape(g.shape).to(g.dtype)


def compressed_psum_tree(grads: Dict[str, torch.Tensor], axis: str, mesh=None
                         ) -> Dict[str, torch.Tensor]:
    """The int8 sum of every leaf over mesh dim ``axis``."""
    mesh = mesh if mesh is not None else shd.current_mesh()
    group = shd.group_of(mesh, (axis,))
    return {k: _compressed_allreduce_leaf(g, group) for k, g in grads.items()}


def make_compressed_grad_sync(mesh, axis: str = "pod", *,
                              plain: bool = False):
    """Returns sync(grads_local, err) -> (grads_synced, new_err): dicts of
    this rank's gradient partials and its error-feedback state (f32, the
    gradients' shapes) -> the mean over ``axis`` in the gradients' dtype
    and the new residuals.  ``plain`` quantizes through the kernels' plain
    versions on any device (what the card's kernels are held to)."""
    if axis not in shd.mesh_names(mesh):
        raise ValueError(f"mesh has no axis {axis!r}")
    group = shd.group_of(mesh, (axis,))
    n = shd.mesh_shape(mesh)[axis]
    quantize = qops.quantize_plain if plain else qops.quantize
    dequantize = qops.dequantize_plain if plain else qops.dequantize

    def sync(grads: Dict[str, torch.Tensor], err: Dict[str, torch.Tensor]
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        synced, new_err = {}, {}
        for k, g in grads.items():
            corrected = g.to(torch.float32) + err[k]
            x2d = _rows(corrected)
            q, s = quantize(x2d)
            new_err[k] = (x2d - dequantize(q, s, torch.float32)
                          ).reshape(corrected.shape)
            summed = _gathered_sum(q, s, group, dequantize)
            synced[k] = (summed / torch.full((), float(n), device=g.device)
                         ).reshape(g.shape).to(g.dtype)
        return synced, new_err

    return sync
