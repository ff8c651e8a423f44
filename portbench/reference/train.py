"""The reference's training steps: gradients of ``decoder.loss``, clipping
by the global norm, a linear warm-up into a cosine schedule and AdamW with
decoupled weight decay (b1 0.9, b2 0.95, eps 1e-8 outside the square
root, bias correction), all in float32.

The numbers the benchmark compares (``portbench.compare``) come from here:
each step's loss, every leaf's norm of a step's clipped gradient, and
every leaf's norm of the change after a step.
"""
from __future__ import annotations

import math
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch

from portbench.reference import decoder

B1, B2, EPS = 0.9, 0.95, 1e-8


def lr_at(step: int, base: float, warmup: int, total: int,
          final_frac: float = 0.1) -> float:
    """The rate of optimizer step ``step`` (from 0)."""
    if step < warmup:
        return base * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base * (final_frac + (1 - final_frac) * 0.5
                   * (1 + math.cos(math.pi * prog)))


def grads(cfg: Mapping, p: Dict[str, torch.Tensor], tokens, labels,
          prec: Optional[decoder.Precision] = None, rows: Optional[int] = None,
          double: Optional[str] = None, routes: Optional[dict] = None,
          stats: Optional[dict] = None
          ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(loss, gradient of every leaf) of one batch.  Two faults planted in
    the reference: ``rows``, only the batch's first rows; ``double``, that
    leaf's gradient doubled.  ``routes`` / ``stats``: ``decoder.loss``."""
    if rows is not None:
        tokens, labels = tokens[:rows], labels[:rows]
    names = list(p)
    with torch.enable_grad():
        leaves = [p[n].requires_grad_(True) for n in names]
        total, _ = decoder.loss(cfg, p, tokens, labels, prec, routes, stats)
        gs = torch.autograd.grad(total, leaves)
    for t in leaves:
        t.requires_grad_(False)
    g = dict(zip(names, gs))
    if double is not None:
        g[double] = g[double] * 2
    return float(total.detach()), g


def clip(g: Dict[str, torch.Tensor], max_norm: float) -> None:
    """Scale every gradient by min(1, max_norm / global norm), in place."""
    norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for x in g.values():
        x.mul_(scale)


def norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    out = {n: torch.linalg.vector_norm(t.float()) for n, t in tensors.items()}
    vals = torch.stack(list(out.values())).tolist()
    return dict(zip(out, vals))


class AdamW:
    def __init__(self, p: Dict[str, torch.Tensor], weight_decay: float):
        self.m = {n: torch.zeros_like(t) for n, t in p.items()}
        self.v = {n: torch.zeros_like(t) for n, t in p.items()}
        self.wd = weight_decay
        self.step = 0

    @torch.no_grad()
    def update(self, p: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor],
               lr: float) -> None:
        self.step += 1
        c1, c2 = 1 - B1 ** self.step, 1 - B2 ** self.step
        for n, x in p.items():
            m, v = self.m[n], self.v[n]
            m.mul_(B1).add_(g[n], alpha=1 - B1)
            v.mul_(B2).addcmul_(g[n], g[n], value=1 - B2)
            upd = (m / c1) / (torch.sqrt(v / c2) + EPS) + self.wd * x
            x.sub_(lr * upd)


def run(cfg: Mapping, p: Dict[str, torch.Tensor],
        batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], train: Mapping,
        prec: Optional[decoder.Precision] = None, rows: Optional[int] = None,
        double: Optional[str] = None, routes: Optional[Sequence[dict]] = None,
        record: bool = False, grad_at: Sequence[int] = (0,),
        change_at: Sequence[int] = (),
        change_of: Optional[Callable[[Dict[str, torch.Tensor]],
                                     Dict[str, float]]] = None) -> dict:
    """Train ``p`` (f32, updated in place) on ``batches``: each step's
    loss (``losses``), every leaf's norm of the clipped gradient of each
    step in ``grad_at`` (``grads[k]``) and ``change_of(p)`` after the
    update of each step in ``change_at`` (``changes[k]``).  An expert
    layer follows ``routes[step][layer]`` where given (``route_gap``: the
    widest gap of a followed choice), and with ``record`` returns the
    experts it chose (``routes``)."""
    opt = AdamW(p, train["weight_decay"])
    losses: List[float] = []
    kept: Dict[int, Dict[str, float]] = {}
    changes: Dict[int, Dict[str, float]] = {}
    stats: dict = {"route_gap": 0.0}
    chosen = []
    for k, (tokens, labels) in enumerate(batches):
        if record:
            stats["routes"] = {}
        loss, g = grads(cfg, p, tokens, labels, prec, rows, double,
                        None if routes is None else routes[k], stats)
        if record:
            chosen.append(stats.pop("routes"))
        clip(g, train["grad_clip"])
        if k in grad_at:
            kept[k] = norms(g)
        opt.update(p, g, lr_at(k, train["learning_rate"],
                               train["warmup_steps"], train["total_steps"]))
        losses.append(loss)
        del g
        if k in change_at:
            changes[k] = change_of(p)
    out = {"losses": losses, "grads": kept, "changes": changes}
    if routes is not None:
        out["route_gap"] = stats["route_gap"]
    if record:
        out["routes"] = chosen
    return out

