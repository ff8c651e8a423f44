"""Load a reference parameter pytree into the port's model.

The reference keeps parameters as nested dicts of arrays, with each stack
of blocks (``STACKS``: ``blocks``, vlm's ``cross_blocks``, whisper's
``enc_blocks`` and ``dec_blocks``) stacked along a leading layer axis
``(L, ...)`` and weights in ``(in, out)`` layout.  ``params_from_reference``
takes that pytree with numpy leaves (the caller converts from JAX; the
port never imports it) and copies every leaf into the matching parameter
of a ``transformer.Model`` (``whisper.Model`` for encdec): module attribute
names equal the pytree's keys, and each leaf takes its parameter's dtype
(the ssm block's ``A_log``, ``dt_bias`` and ``D`` and a cross block's
``xgate`` are f32 parameters, so they stay f32; stacked, ``xgate`` is
``(L_cross,)``).  ``decode_state_from_reference`` does the same for a
decode state (KV cache, the ssm family's ``ssm_conv`` and ``ssm_ssd``, the
cross K/V, or whisper's ``EncDecState``), so both packages can spill the
same bytes.

For training, ``params_to_reference`` is the inverse of
``params_from_reference`` (the model's weights as the reference's pytree of
numpy arrays, blocks stacked again), and ``opt_state_from_reference`` /
``opt_state_to_reference`` move AdamW's ``step``, ``m``, ``v`` and
``master`` between the reference's ``AdamWState`` layout and the port's
tensors keyed by parameter name.  Checkpoints are written in the
reference's layout, so a checkpoint of either package restores in the
other; numpy has no bfloat16, so bf16 leaves go out as f32 (exact), as the
reference's checkpoint writer widens them.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.models import whisper
from repro_torch.models.transformer import DecodeState, Model

# the parameter-tree keys whose blocks the reference stacks on a layer axis
STACKS = ("blocks", "cross_blocks", "enc_blocks", "dec_blocks")


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
    cls = whisper.Model if cfg.family == "encdec" else Model
    model = cls(cfg, generator=None, device=resolve_device(device))
    return load_params_from_reference(model, np_params)


def load_params_from_reference(model: Model, np_params: Mapping[str, Any]
                               ) -> Model:
    """Copy a reference parameter pytree into ``model``'s parameters, in
    place; every parameter must be covered."""
    seen: set = set()
    with torch.no_grad():
        for key, sub in np_params.items():
            if key in STACKS:
                for i, blk in enumerate(getattr(model, key)):
                    _load(blk, sub, i, f"{key}.{i}.", seen)
            else:
                _load(model, {key: sub}, None, "", seen)
    missing = [n for n, p in model.named_parameters() if id(p) not in seen]
    if missing:
        raise ValueError(f"reference pytree lacks {missing}")
    return model


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def to_reference_tree(named: Mapping[str, Any], stack=np.stack
                      ) -> Dict[str, Any]:
    """Leaves keyed by the port's parameter names (``blocks.3.attn.wq``) as
    the reference's nested dict, the leaves of each stack of ``STACKS``
    stacked along a leading layer axis with ``stack`` (``np.stack``, or
    ``torch.stack`` for tensors)."""
    tree: Dict[str, Any] = {}
    layers: Dict[tuple, list] = {}
    for name, leaf in named.items():
        parts = name.split(".")
        if parts[0] in STACKS:
            layers.setdefault((parts[0],) + tuple(parts[2:]), []).append(
                (int(parts[1]), leaf))
            continue
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = leaf
    for path, items in layers.items():
        node = tree.setdefault(path[0], {})
        path = path[1:]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = stack([leaf for _, leaf in sorted(items,
                                                          key=lambda x: x[0])])
    return tree


def from_reference_tree(tree: Mapping[str, Any], prefix: str = ""
                        ) -> Dict[str, Any]:
    """The inverse of ``to_reference_tree``: leaves keyed by the port's
    parameter names, block leaves split along their layer axis."""
    out: Dict[str, Any] = {}
    for key, sub in tree.items():
        name = f"{prefix}{key}"
        if isinstance(sub, Mapping):
            if name in STACKS:
                for path, leaf in from_reference_tree(sub).items():
                    for i in range(leaf.shape[0]):
                        out[f"{name}.{i}.{path}"] = leaf[i]
            else:
                out.update(from_reference_tree(sub, name + "."))
        else:
            out[name] = sub
    return out


def params_to_reference(model: Model) -> Dict[str, Any]:
    """The model's weights as the reference's parameter pytree: nested dicts
    of numpy arrays, blocks stacked on a leading layer axis, bf16 widened to
    f32 (exact)."""
    return to_reference_tree({n: _numpy(p)
                              for n, p in model.named_parameters()})


def opt_state_to_reference(state) -> Dict[str, Any]:
    """AdamW state as the reference's ``AdamWState`` layout: ``step`` (int32
    scalar), ``m``, ``v`` and ``master`` (None when the params are f32) as
    parameter pytrees of numpy arrays."""
    def tree(d):
        return None if d is None else to_reference_tree(
            {n: _numpy(t) for n, t in d.items()})
    return {"step": np.asarray(state.step, np.int32), "m": tree(state.m),
            "v": tree(state.v), "master": tree(state.master)}


def opt_state_from_reference(model: Model, np_opt) -> "AdamWState":
    """The port's AdamW state for ``model`` from the reference's state (an
    ``AdamWState`` or a dict with its fields) whose leaves are numpy arrays:
    ``m``, ``v`` and ``master`` as f32 tensors on the model's device keyed
    by parameter name, ``step`` an int."""
    from repro_torch.optim.adamw import AdamWState

    get = (np_opt.get if isinstance(np_opt, Mapping)
           else lambda k: getattr(np_opt, k))
    params = dict(model.named_parameters())

    def load(tree) -> Optional[Dict[str, torch.Tensor]]:
        if tree is None:
            return None
        flat = from_reference_tree(tree)
        if set(flat) != set(params):
            raise ValueError(f"optimizer state keys differ from the model's: "
                             f"{sorted(set(flat) ^ set(params))[:8]}")
        return {n: _tensor(flat[n]).to(device=p.device, dtype=torch.float32)
                for n, p in params.items()}

    return AdamWState(int(np.asarray(get("step"))), load(get("m")),
                      load(get("v")), load(get("master")))


def decode_state_from_reference(np_state, device: Union[str, torch.device,
                                                        None] = None):
    """A port ``DecodeState`` (``whisper.EncDecState`` for the reference's
    ``EncDecState``) on ``device`` (default ``cuda``) holding a reference
    decode state whose fields are numpy arrays (the caller converts from
    JAX) or None.  Cache fields keep their dtype (a bfloat16 cache stays
    bfloat16, exactly); ``pos`` becomes int64."""
    dev = resolve_device(device)
    cls = (whisper.EncDecState if type(np_state).__name__ == "EncDecState"
           else DecodeState)
    fields = {}
    for name in cls._fields:
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
    return cls(**fields)
