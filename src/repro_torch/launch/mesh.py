"""Production mesh construction.

Port of ``repro/launch/mesh.py``.  Functions, not module-level constants:
importing this module touches no process group.  Each builds a
``DeviceMesh`` with named dims over the current default process group
(``torch.distributed.init_process_group`` first: NCCL on the card, gloo on
the CPU, or the dry run's fake group), whose world size must equal the
mesh's size.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.common.config import (MULTI_POD_MESH, SINGLE_POD_MESH,
                                       MeshConfig)


def _device_type(device: Union[str, torch.device, None]) -> str:
    return torch.device("cuda" if device is None else device).type


def _init(shape: Tuple[int, ...], axes: Tuple[str, ...], device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} {axes} mesh needs a process group of "
                           f"{n} ranks: call init_process_group first")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"a {shape} {axes} mesh needs {n} ranks; the "
                           f"process group has {world}")
    return init_device_mesh(_device_type(device), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 ``("data", "model")``, or 2 x 16 x 16 ``("pod", "data",
    "model")`` with ``multi_pod``."""
    mc = mesh_config(multi_pod)
    return _init(mc.shape, mc.axes, device)


def make_mesh_from_config(mc: MeshConfig, device=None):
    return _init(mc.shape, mc.axes, device)


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model"),
                   device: Optional[Union[str, torch.device]] = "cpu"):
    """Small mesh for CPU tests (gloo ranks in child processes)."""
    return _init(shape, axes, device)


def mesh_config(multi_pod: bool) -> MeshConfig:
    return MULTI_POD_MESH if multi_pod else SINGLE_POD_MESH
