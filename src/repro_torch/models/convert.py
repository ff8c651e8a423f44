"""Load a reference parameter pytree into the port's model.

The reference keeps parameters as nested dicts of arrays, with the blocks
(dense, or ssm with ``ln`` and the eight ``ssm`` leaves) stacked along a
leading layer axis ``(L, ...)`` and weights in ``(in, out)`` layout.  ``params_from_reference`` takes that pytree with
numpy leaves (the caller converts from JAX; the port never imports it) and
copies every leaf into the matching parameter of a
``transformer.Model``: module attribute names equal the pytree's keys, and
each leaf takes its parameter's dtype (the ssm block's ``A_log``,
``dt_bias`` and ``D`` are f32 parameters, so they stay f32).
``decode_state_from_reference`` does the same for a decode state (KV
cache, or the ssm family's ``ssm_conv`` and ``ssm_ssd``), so both packages
can spill the same bytes.
"""
from __future__ import annotations

from typing import Any, Mapping, Union

import numpy as np
import torch
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.models.transformer import DecodeState, Model


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no torch.from_numpy
        a = a.astype(np.float32)
    return torch.tensor(a)                  # a copy: reference arrays are read-only


def _load(module: nn.Module, tree: Mapping[str, Any], layer, path: str,
          seen: set) -> None:
    for key, sub in tree.items():
        name = f"{path}{key}"
        if isinstance(sub, Mapping):
            _load(getattr(module, key), sub, layer, name + ".", seen)
            continue
        param = getattr(module, key)
        src = _tensor(sub if layer is None else np.asarray(sub)[layer])
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {tuple(src.shape)} "
                             f"!= port shape {tuple(param.shape)}")
        param.copy_(src.to(device=param.device, dtype=param.dtype))
        seen.add(id(param))


def params_from_reference(cfg: ModelConfig, np_params: Mapping[str, Any],
                          device: Union[str, torch.device, None] = None
                          ) -> Model:
    """A ``Model`` on ``device`` (default ``cuda``) holding the reference
    weights, cast to ``cfg.param_dtype``."""
    model = Model(cfg, generator=None, device=resolve_device(device))
    seen: set = set()
    with torch.no_grad():
        for key, sub in np_params.items():
            if key == "blocks":
                for i, blk in enumerate(model.blocks):
                    _load(blk, sub, i, f"blocks.{i}.", seen)
            else:
                _load(getattr(model, key), sub, None, key + ".", seen)
    missing = [n for n, p in model.named_parameters() if id(p) not in seen]
    if missing:
        raise ValueError(f"reference pytree lacks {missing}")
    return model


def decode_state_from_reference(np_state, device: Union[str, torch.device,
                                                        None] = None
                                ) -> DecodeState:
    """A port ``DecodeState`` on ``device`` (default ``cuda``) holding a
    reference decode state whose fields are numpy arrays (the caller
    converts from JAX) or None.  Cache fields keep their dtype (a bfloat16
    cache stays bfloat16, exactly); ``pos`` becomes int64."""
    dev = resolve_device(device)
    fields = {}
    for name in DecodeState._fields:
        a = getattr(np_state, name, None)
        if a is None:
            fields[name] = None
            continue
        bf16 = np.asarray(a).dtype.name == "bfloat16"
        t = _tensor(a).to(dev)
        if name == "pos":
            t = t.to(torch.int64)
        elif bf16:
            t = t.to(torch.bfloat16)
        fields[name] = t
    return DecodeState(**fields)
