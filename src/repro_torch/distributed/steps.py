"""Train / eval step builders on one device.

Port of the step builders of ``repro/distributed/steps.py``:

  * ``make_train_step`` — the fused iteration: scaled loss, backward,
    unscale, clip, schedule and AdamW (what the paper's profiler sees as one
    sequence);
  * ``make_grad_step`` / ``make_apply_step`` — the split pair the trainer
    dispatches, so a host-side loss-scale skip really drops the optimizer
    step from the iteration (§2.3);
  * ``make_eval_step`` — the loss alone, under ``torch.no_grad``.

PyTorch idiom: the model is an ``nn.Module``, gradients come from
``loss.backward()`` into ``.grad`` and are handed on as tensors keyed by
parameter name; ``apply_step`` updates the parameters and the optimizer
state in place.  The grad step unscales each gradient as the reference's
does, ``g / loss_scale`` with the scale an f32 scalar, so a bf16 gradient
becomes f32 (JAX promotes bf16 / f32 to f32); the fused step divides in
the gradient's own dtype, as the reference's ``make_train_step`` does.
Sharding (``shd.constrain``, specs, ZeRO, ``grad_shardings``) and the
serving steps come with ROADMAP.md queue 1 item 11.

``policy`` is what the reference's step builders take as a remat policy:
here an ``Execution`` (``core.executor.Executor.execution``), the context
the forward and backward run under to apply a swap policy, or None for
plain autograd.  The unscale, the finiteness check and the optimizer run
after it, unchanged.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import (AdamWState, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.loss_scale import check_finite
from repro_torch.optim.schedules import warmup_cosine


def make_loss_fn(cfg: ModelConfig):
    """(model, batch, loss_scale) -> (loss * loss_scale, (loss, metrics))."""
    api = get_api(cfg)

    def loss_fn(model: nn.Module, batch, loss_scale):
        loss, metrics = api.loss_fn(cfg, model, batch)
        return loss * loss_scale, (loss, metrics)

    return loss_fn


def _run(policy):
    return policy.run() if policy is not None else contextlib.nullcontext()


def _backward(loss_fn, model, batch, loss_scale, policy=None):
    """Scaled loss and its backward, under ``policy``; returns (loss,
    {name: param}, metrics) with each parameter's ``.grad`` filled (zeros
    where the loss does not reach it) and the loss's parts (``xent``,
    ``aux``) detached."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    with _run(policy):
        scaled, (loss, m) = loss_fn(model, batch, loss_scale)
        scaled.backward()
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return loss.detach(), params, {k: v.detach() for k, v in m.items()}


def make_grad_step(cfg: ModelConfig, tcfg: TrainConfig, policy=None,
                   on_parts: Optional[Callable[[Dict[str, torch.Tensor]],
                                               None]] = None) -> Callable:
    """(model, batch, loss_scale) -> (loss, grads, finite): grads unscaled
    (f32) keyed by parameter name, ``finite`` a 0-d bool tensor.  The
    parameters' ``.grad`` are released.  ``on_parts``, if given, takes each
    call's loss parts (``xent``, ``aux``), detached."""
    loss_fn = make_loss_fn(cfg)

    def grad_step(model: nn.Module, batch, loss_scale
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                             torch.Tensor]:
        loss, params, parts = _backward(loss_fn, model, batch, loss_scale,
                                        policy)
        if on_parts is not None:
            on_parts(parts)
        scale = torch.tensor(loss_scale, dtype=torch.float32)
        grads = {}
        for n, p in params.items():
            grads[n] = p.grad.float().div_(scale.to(p.device))
            p.grad = None
        return loss, grads, check_finite(grads)

    return grad_step


def make_apply_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """(model, opt_state, grads) -> (model, opt_state, metrics): clip by the
    global norm, the warmup-cosine lr at the state's step, AdamW in place."""
    def apply_step(model: nn.Module, opt_state: AdamWState, grads):
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = warmup_cosine(opt_state.step, tcfg.learning_rate,
                           tcfg.warmup_steps, tcfg.steps)
        opt_state = adamw_update(model, grads, opt_state, tcfg, lr)
        return model, opt_state, {"grad_norm": gnorm, "lr": lr}

    return apply_step


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    policy=None) -> Callable:
    """The fused iteration: (model, opt_state, batch, loss_scale) ->
    (model, opt_state, {"loss", "grad_norm", "lr"})."""
    loss_fn = make_loss_fn(cfg)

    def train_step(model: nn.Module, opt_state: AdamWState, batch,
                   loss_scale):
        loss, params, _m = _backward(loss_fn, model, batch, loss_scale,
                                     policy)
        grads = {}
        for n, p in params.items():
            g = p.grad
            grads[n] = g / torch.tensor(loss_scale, dtype=torch.float32
                                        ).to(device=g.device, dtype=g.dtype)
            p.grad = None
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = warmup_cosine(opt_state.step, tcfg.learning_rate,
                           tcfg.warmup_steps, tcfg.steps)
        opt_state = adamw_update(model, grads, opt_state, tcfg, lr)
        return model, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def make_eval_step(cfg: ModelConfig, policy=None) -> Callable:
    """(model, batch) -> loss, with no autograd graph (so nothing is saved
    for ``policy`` to move)."""
    api = get_api(cfg)

    @torch.no_grad()
    def eval_step(model: nn.Module, batch):
        with _run(policy):
            loss, _ = api.loss_fn(cfg, model, batch)
        return loss

    return eval_step
