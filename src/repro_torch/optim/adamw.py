"""AdamW, the reference's formula op for op.

Port of ``repro/optim/adamw.py``: ``b1 = 0.9``, ``b2 = 0.95``, ``eps``
outside the square root, bias correction computed in f32, decoupled weight
decay applied to the f32 ``base`` (the f32 master copy where parameters are
not f32, else the parameter itself), and the new value cast back to the
parameter's dtype.  Not ``torch.optim.AdamW``: its order of operations
differs and parity with the reference would drift.

State is tensors keyed by parameter name (``model.named_parameters()``):
``m``, ``v`` (f32) and ``master`` (f32, or None when every parameter is
f32).  The update runs in place on the parameters and the state, one
parameter at a time, so the f32 temporaries stay one parameter large.
ZeRO stages map to sharding specs, not different math
(``opt_state_axes``, ``distributed.steps.opt_specs``): a sharded step
hands ``adamw_update`` each rank's shards of the parameters, gradients and
state.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.common.config import TrainConfig

B1, B2, EPS = 0.9, 0.95, 1e-8


class AdamWState(NamedTuple):
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    master: Optional[Dict[str, torch.Tensor]]   # None when params are f32


def _params(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params) -> AdamWState:
    """Zero moments (f32) and, when any parameter is not f32, an f32 master
    copy of every parameter.  ``params``: a module or a name -> tensor map."""
    ps = _params(params)
    m = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
         for n, p in ps.items()}
    v = {n: torch.zeros_like(t) for n, t in m.items()}
    master = None
    if any(p.dtype != torch.float32 for p in ps.values()):
        master = {n: p.detach().float().clone() for n, p in ps.items()}
    return AdamWState(0, m, v, master)


def opt_state_axes(param_axes, zero_stage: int) -> AdamWState:
    """Mirror of the params' logical-axes tree for m/v/master.  For ZeRO>=1
    the first shardable dim additionally maps to the data axis via the
    caller's rules override (``distributed.steps.ZERO_OPT_RULES``)."""
    return AdamWState(("scalar",), param_axes, param_axes, param_axes)


@torch.no_grad()
def adamw_update(params, grads: Mapping[str, torch.Tensor], state: AdamWState,
                 cfg: TrainConfig, lr) -> AdamWState:
    """One AdamW step on every parameter, in place; returns the new state
    (the same tensors, with ``step`` advanced).  ``lr``: a 0-d f32 tensor
    or a float."""
    ps = _params(params)
    step = state.step + 1
    f32 = torch.float32
    c1 = 1.0 - torch.tensor(B1, dtype=f32) ** torch.tensor(step, dtype=f32)
    c2 = 1.0 - torch.tensor(B2, dtype=f32) ** torch.tensor(step, dtype=f32)
    lr = torch.as_tensor(lr, dtype=f32)
    dev_consts: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
    for n, p in ps.items():
        dev = p.device
        if dev not in dev_consts:
            dev_consts[dev] = tuple(t.to(dev) for t in (c1, c2, lr))
        c1d, c2d, lrd = dev_consts[dev]
        gf = grads[n].to(f32)
        m, v = state.m[n], state.v[n]
        m.mul_(B1).add_(gf * (1 - B1))
        v.mul_(B2).add_(torch.square(gf) * (1 - B2))
        del gf
        upd = (m / c1d) / (torch.sqrt(v / c2d) + EPS)
        base = state.master[n] if state.master is not None else p
        upd.add_(base * cfg.weight_decay)
        upd.mul_(lrd)
        if state.master is not None:
            base.sub_(upd)
            p.copy_(base)               # round to the parameter dtype
        else:
            p.sub_(upd)
    return AdamWState(step, state.m, state.v, state.master)


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    total = None
    for g in grads.values():
        s = torch.sum(torch.square(g.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-12))``, in
    place and in the gradient's own dtype; returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return dict(grads), norm
