"""``input_specs`` — fake-tensor stand-ins for every (arch × shape) cell:
shardable, zero device allocation.

Port of ``repro/launch/specs.py``.  For ``train`` cells the specs cover the
full train-step signature (params, opt_state, batch, loss_scale);
``prefill`` covers (params, batch); ``decode`` covers (params, tokens,
decode_state with a seq_len KV cache).  Where the reference returns
``ShapeDtypeStruct``s the port returns fake tensors made in one
``FakeTensorMode`` (``mode``) on ``device``, and the model itself for the
params; the batch is ``data.synthetic.make_batch_specs``'s shapes.
Modality frontends are stubs: ``memory`` is the precomputed frame/patch
embedding tensor.  Shardings are ``sharding.NamedSharding``s in trees keyed
by the port's parameter names.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.common.config import ModelConfig, ShapeConfig
from repro_torch.data.synthetic import TensorSpec, make_batch_specs
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import steps as S
from repro_torch.models.layers import torch_dtype
from repro_torch.models.registry import get_api


def _fake_mode(mode):
    from torch._subclasses.fake_tensor import FakeTensorMode
    return mode or FakeTensorMode()


def _fake(spec: TensorSpec, device, mode) -> torch.Tensor:
    with mode:
        return torch.zeros(spec.shape, dtype=spec.dtype,
                           device=torch.device(device))


def _memory_spec(cfg: ModelConfig, B: int):
    if cfg.family == "vlm":
        return TensorSpec((B, cfg.image_tokens, cfg.d_model),
                          torch_dtype(cfg.dtype))
    if cfg.family == "encdec":
        return TensorSpec((B, cfg.encoder_seq, cfg.d_model),
                          torch_dtype(cfg.dtype))
    return None


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                       device="cpu", mode=None, model=None):
    """The decode state of a ``shape.seq_len`` cache, in fake tensors."""
    mode = _fake_mode(mode)
    model = model or S.abstract_model(cfg, device=device, mode=mode)
    api = get_api(cfg)
    B = shape.global_batch
    mem = _memory_spec(cfg, B)
    memory = None if mem is None else _fake(mem, device, mode)
    with mode, torch.no_grad():
        return api.init_decode_state(cfg, B, shape.seq_len, params=model,
                                     memory=memory)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, device="cpu",
                mode=None) -> Tuple[tuple, dict]:
    """Returns (args, meta) for the cell's step function, fake tensors in
    ``mode`` (a new ``FakeTensorMode`` by default)."""
    from repro_torch.optim.adamw import adamw_init
    mode = _fake_mode(mode)
    model = S.abstract_model(cfg, device=device, mode=mode)
    B = shape.global_batch
    if shape.kind == "train":
        with mode:
            opt = adamw_init(model)
        batch = {k: _fake(v, device, mode)
                 for k, v in make_batch_specs(cfg, shape).items()}
        args = (model, opt, batch, 1.0)
        return args, {"step": "train"}
    if shape.kind == "prefill":
        batch = {"tokens": _fake(TensorSpec((B, shape.seq_len), torch.int32),
                                 device, mode)}
        mem = _memory_spec(cfg, B)
        if mem is not None:
            batch["memory"] = _fake(mem, device, mode)
        return (model, batch), {"step": "prefill"}
    tokens = _fake(TensorSpec((B, 1), torch.int32), device, mode)
    state = decode_state_specs(cfg, shape, device=device, mode=mode,
                               model=model)
    return (model, tokens, state), {"step": "decode"}


# ------------------------------------------------------------- shardings
def _batch_axes(mesh, batch: int) -> tuple:
    axes = tuple(a for a in ("pod", "data") if a in shd.mesh_names(mesh))
    # replicate tiny batches (e.g. long_500k batch=1) instead of 1/16 shards
    size = 1
    for a in axes:
        size *= shd.mesh_shape(mesh)[a]
    return axes if batch >= size else ()


def _lead(b_axes: tuple, ndim: int) -> tuple:
    if not ndim:
        return ()
    return (b_axes or None,) + (None,) * (ndim - 1)


def train_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    zero_stage: int = 2):
    """(in_shardings, out_shardings) of the train step: (params, opt_state,
    batch, loss_scale) and (params, opt_state, metrics)."""
    axes = S.param_axes(cfg)
    params_sds, opt_sds = S.abstract_train_state(cfg)
    p_spec = S.param_specs(axes, mesh, zero3=(zero_stage >= 3),
                           sds_tree=params_sds)
    o_spec = S.opt_specs(axes, mesh, zero_stage, opt_sds=opt_sds)
    b_axes = _batch_axes(mesh, shape.global_batch)
    b_spec = {k: _lead(b_axes, v.ndim)
              for k, v in make_batch_specs(cfg, shape).items()}
    p_sh, o_sh = S.to_shardings(p_spec, mesh), S.to_shardings(o_spec, mesh)
    scalar = shd.NamedSharding(mesh, ())
    return ((p_sh, o_sh, S.to_shardings(b_spec, mesh), scalar),
            (p_sh, o_sh, scalar))


def _state_fields(state) -> Tuple[str, ...]:
    return type(state)._fields


def decode_state_spec_tree(cfg: ModelConfig, shape: ShapeConfig, mesh,
                           state_sds):
    """Partition specs for the decode state: KV cache sharded batch->data
    and kv_seq->model (decode-time sequence parallelism); SSM state on
    heads."""
    b_axes = _batch_axes(mesh, shape.global_batch)

    def one(field: str, sds) -> tuple:
        nd = len(sds.shape)
        spec = [None] * nd
        if field in ("attn_k", "attn_v"):         # (L, B, S, Kh, D)
            spec[1] = b_axes or None
            spec[2] = "model"
        elif field in ("cross_k", "cross_v"):
            spec[1] = b_axes or None
        elif field == "ssm_conv":
            spec[1] = b_axes or None
            spec[-1] = "model"                    # channels
        elif field == "ssm_ssd":
            spec[1] = b_axes or None
            spec[2] = "model"                     # heads
        elif field == "pos":
            return ()
        return tuple(spec)

    return type(state_sds)(*[
        None if getattr(state_sds, f) is None
        else one(f, getattr(state_sds, f))
        for f in _state_fields(state_sds)])


def serve_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    state_sds=None):
    """(in_shardings, out_shardings) of the prefill step, or of the decode
    step given the decode state's specs ``state_sds``."""
    axes = S.param_axes(cfg)
    p_spec = S.param_specs(axes, mesh, sds_tree=S.abstract_params(cfg))
    b_axes = _batch_axes(mesh, shape.global_batch)
    if shape.kind == "prefill":
        batch = {"tokens": _lead(b_axes, 2)}
        if _memory_spec(cfg, shape.global_batch) is not None:
            batch["memory"] = _lead(b_axes, 3)
        return ((S.to_shardings(p_spec, mesh), S.to_shardings(batch, mesh)),
                shd.NamedSharding(mesh, _lead(b_axes, 3)))
    if state_sds is None:
        raise ValueError("decode shardings need the decode state's specs")
    tok_spec = (b_axes or None, None)
    st_spec = decode_state_spec_tree(cfg, shape, mesh, state_sds)
    st_spec = type(state_sds)(*[
        None if getattr(state_sds, f) is None else S.sanitize_specs(
            getattr(st_spec, f), getattr(state_sds, f), mesh)
        for f in _state_fields(state_sds)])
    st_sh = type(state_sds)(*[None if v is None else
                              shd.NamedSharding(mesh, v) for v in st_spec])
    logits = shd.NamedSharding(mesh, (b_axes or None, None, None))
    return ((S.to_shardings(p_spec, mesh), shd.NamedSharding(mesh, tok_spec),
             st_sh), (logits, st_sh))

