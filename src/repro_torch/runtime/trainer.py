"""Trainer — eager dispatch loop with the Chameleon runtime in-line.

Port of ``repro/runtime/trainer.py``.  Each iteration dispatches separate
steps, as the paper's setting does: the grad step; the optimizer step only
when the gradients are finite (a loss-scale overflow skips it and the
iteration's operator sequence shortens); an eval step every
``eval_every`` iterations.  With Chameleon on, ``ChameleonRuntime``
(``core.runtime``) records every dispatch's op stream, runs Algo 1 at the
end of each iteration, generates and selects policies, and the grad step
runs under the applied policy through the executor (``core.executor``).
The runtime is handed the iteration's time and the grad dispatch's own,
less that dispatch's measured copy stall (``report.grad_times``), at
which it prices the detailed profile (``core.runtime``'s module doc):
``report.stages``, ``report.policystore`` and ``report.adapt`` are the
reference's, and the ``runtime``, ``hostmem`` and ``memory`` metrics
providers are registered.  With Chameleon off the trainer needs no
runtime beyond its own steps: ``report.stages`` stays empty and
``report.policystore`` / ``report.adapt`` stay None.

Fault tolerance as in the reference: checkpoints on a cadence, written
asynchronously in the reference's layout (``checkpointing.manager``,
through the host tier's checkpoint traffic class when Chameleon runs one);
an emergency checkpoint when an iteration raises, recorded after the step
is counted so ``resume()`` does not replay an applied update; ``resume()``
from the latest step, sample-exact through the data cursor; straggler
detection on the step wall times; ``faults.tick`` at the top of every
iteration for armed fault plans.

``obs``: the spans ``compute.train_step``, ``compute.apply_step`` and
``compute.eval_step`` around the dispatches, and on the ``trainer`` lane
the host work between them: ``step`` (one iteration), ``batch`` (the next
batch to the device), ``settle`` (the execution's books) and
``train_end`` (the checkpoint wait and the stats at the end of
``train()``).  Each dispatch's phases are marked as their work is
launched (``distributed.steps``' ``on_mark``): ``fwd``, ``bwd`` and
``unscale`` in the grad dispatch, ``clip`` and ``adamw_update`` in the
apply, ``eval``.  Once the dispatch has synchronised, each phase is a
device record of the ``compute`` lane, and ``report.device_phases`` keeps
its seconds, the step's ``dispatch_s`` their sum; the grad dispatch's
start event anchors the tracer's device clock (``obs.tracer``).  With
Chameleon off the trainer stamps the tracer's iteration (the runtime
does with it on).
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import faults, obs
from repro_torch.checkpointing.manager import CheckpointManager
from repro_torch.common.config import ChameleonConfig, ModelConfig, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.core.runtime import ChameleonRuntime
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.distributed import steps as S
from repro_torch.models import convert
from repro_torch.models.layers import torch_dtype
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.loss_scale import (LossScaleState, init_loss_scale,
                                          update_loss_scale)
from repro_torch.runtime.straggler import StragglerDetector


@dataclass
class TrainReport:
    losses: List[float] = field(default_factory=list)
    # the loss's parts per step (xent + aux = loss; aux is the moe family's
    # load-balance loss, 0 for the others)
    xent: List[float] = field(default_factory=list)
    aux: List[float] = field(default_factory=list)
    times: List[float] = field(default_factory=list)
    # full critical-path latency per step: ``times`` plus the
    # ``end_iteration`` bookkeeping/adaptation that runs before the next
    # dispatch (equal to ``times`` with Chameleon off)
    wall_times: List[float] = field(default_factory=list)
    # the grad dispatch per step, from its start to its synchronised end,
    # less its measured copy stall (Chameleon prices its profile at it)
    grad_times: List[float] = field(default_factory=list)
    # per step, the device seconds of each dispatch phase (``fwd``,
    # ``bwd``, ``unscale``; ``clip`` and ``adamw_update`` where the update
    # ran; ``eval``) and ``dispatch_s``, their sum (host seconds on the CPU)
    device_phases: List[Dict[str, float]] = field(default_factory=list)
    skipped_steps: List[int] = field(default_factory=list)
    eval_losses: Dict[int, float] = field(default_factory=dict)
    # Chameleon's stage per step (empty with Chameleon off)
    stages: List[str] = field(default_factory=list)
    checkpoints: List[str] = field(default_factory=list)
    failures: List[str] = field(default_factory=list)
    # repro_torch.policystore: per-tier hit counters + adaptation
    # latencies (None when the runtime has no store attached)
    policystore: Optional[dict] = None
    # repro_torch.adapt: service counters (jobs / published / discarded /
    # failed / installed / speculative hits / watchdog), live at the end
    adapt: Optional[dict] = None

    @property
    def genpolicy_steps(self) -> int:
        return sum(1 for s in self.stages if s == "GenPolicy")


def _weakly(method: Callable[[], dict]) -> Callable[[], dict]:
    """A bound method as a metrics provider that does not keep its object
    alive: ``{}`` once the object is gone."""
    ref = weakref.WeakMethod(method)

    def provider() -> dict:
        fn = ref()
        return {} if fn is None else fn()

    return provider


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 cham: Optional[ChameleonConfig] = None,
                 mesh=None, data: Optional[SyntheticTokens] = None,
                 eval_data: Optional[SyntheticTokens] = None,
                 metrics_out: Optional[str] = None,
                 metrics_every: int = 25,
                 adapt_mode: Optional[str] = None, *,
                 device: Union[str, torch.device, None] = None):
        self.cfg, self.tcfg = cfg, tcfg
        self.cham = cham or ChameleonConfig(enabled=False)
        if adapt_mode is not None and adapt_mode != self.cham.adapt.mode:
            # placement override (--adapt-mode): inline keeps the paper's
            # measured GenPolicy iterations; async / speculative move the
            # variant search onto the repro_torch.adapt background worker
            self.cham = dataclasses.replace(
                self.cham,
                adapt=dataclasses.replace(self.cham.adapt, mode=adapt_mode))
        # kept, as the reference keeps it: the trainer trains unsharded;
        # sharded training goes through distributed.steps' builders
        self.mesh = mesh
        self.device = resolve_device(device)
        self.api = get_api(cfg)
        self.data = data or SyntheticTokens(cfg.vocab_size, 128, 8,
                                            seed=tcfg.seed)
        self.eval_data = eval_data or SyntheticTokens(
            cfg.vocab_size, self.data.seq_len, self.data.global_batch,
            seed=tcfg.seed + 1)
        self.model = self.api.init(cfg, seed=tcfg.seed, device=self.device)
        self.opt_state = adamw_init(self.model)
        self.loss_scale = init_loss_scale(tcfg.loss_scale)
        self.step = 0
        self.straggler = StragglerDetector(on_straggler=self._on_straggler)
        self.report = TrainReport()
        self._parts = None             # the last grad step's loss parts
        self._marks: Optional[list] = None   # the open dispatch's phases
        self._grad = S.make_grad_step(cfg, tcfg, on_parts=self._take_parts,
                                      on_mark=self._mark)
        self._apply = S.make_apply_step(cfg, tcfg, on_mark=self._mark)
        self._eval = S.make_eval_step(cfg)
        self.rt: Optional[ChameleonRuntime] = None
        if self.cham.enabled:
            self.rt = ChameleonRuntime(
                self.cham, lambda policy: S.make_grad_step(
                    cfg, tcfg, policy, on_parts=self._take_parts,
                    on_mark=self._mark),
                device=self.device)
            # every dispatch of the iteration runs under the recorder
            self._apply = self.rt.recorded(self._apply)
            self._eval = self.rt.recorded(self._eval)
        hostmem = self.rt.hostmem if self.rt is not None else None
        # checkpoint drains share the host link with policy swaps: route
        # them through the engine's lowest-priority checkpoint stream.  A
        # lost async checkpoint write degrades (one fewer restore point,
        # audited) instead of killing the train loop, as in the reference
        self.ckpt = CheckpointManager(
            tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints,
            engine=hostmem.engine if hostmem is not None else None,
            on_error="degrade" if self.cham.resilience.enabled else "raise")
        self._prepared = False
        self.metrics_out = metrics_out
        self.metrics_every = max(1, int(metrics_every))
        # weakly: the global registry must not keep a finished trainer (its
        # model, optimizer state and host tier) alive
        reg = obs.metrics()
        if hostmem is not None:
            reg.register_provider("hostmem", _weakly(hostmem.stats))
        reg.register_provider("runtime", _weakly(self._runtime_provider))
        # via a lambda: set_ledger may swap the default between snapshots
        reg.register_provider("memory", lambda: obs.ledger().stats())

    def _on_straggler(self, ev) -> None:
        """Mitigation hook: structured evidence for the orchestrator."""
        obs.audit().event("straggler.flagged", step=ev.step, host=ev.host,
                          wall=round(ev.t, 6), mean=round(ev.mean, 6),
                          std=round(ev.std, 6))
        obs.metrics().counter("straggler_flagged")

    def _runtime_provider(self) -> dict:
        if self.rt is None:
            return {"step": self.step, "chameleon": False,
                    "skipped_steps": len(self.report.skipped_steps)}
        return {
            "step": self.step,
            "stage": self.rt.machine.stage.value,
            "profiling_overhead_s": self.rt.profiling_overhead_s,
            "adaptation_overhead_s": self.rt.adaptation_overhead_s,
            "adaptations": len(self.rt.adaptations),
            "adapt": self.rt.service.stats(),
        }

    # ------------------------------------------------------------- utils
    def _device_batch(self, batch: Dict[str, np.ndarray]):
        """The token arrays as int64 on the device; for the vlm and encdec
        families also ``memory``, zeros of (B, image_tokens | encoder_seq,
        d_model) in the activation dtype, as the reference's trainer feeds
        its stub frontend."""
        out = {k: torch.as_tensor(v, dtype=torch.int64).to(self.device)
               for k, v in batch.items()}
        mem = {"vlm": self.cfg.image_tokens,
               "encdec": self.cfg.encoder_seq}.get(self.cfg.family)
        if mem is not None:
            out["memory"] = torch.zeros(
                (out["tokens"].shape[0], mem, self.cfg.d_model),
                dtype=torch_dtype(self.cfg.dtype), device=self.device)
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _next_batch(self):
        with obs.tracer().span(obs.LANE_TRAINER, "batch"):
            return self._device_batch(self.data.get())

    def _mark(self, phase: str) -> None:
        """``phase`` of the open dispatch is launched (``on_mark``); a
        replay of the grad dispatch outside the trainer's marks none."""
        if self._marks is not None:
            self._marks.append((phase, obs.tracer().mark(self.device)))

    def _dispatch(self, fn, args, first):
        """``fn(*args)`` with its phases marked from ``first``: (its
        output, the marks)."""
        self._marks = [("", first)]
        try:
            return fn(*args), self._marks
        finally:
            self._marks = None

    @staticmethod
    def _phases(marks, out: Dict[str, float]) -> None:
        """Each phase, from the mark before it to its own, once the
        dispatch has synchronised: a device record, its seconds into
        ``out``."""
        tr = obs.tracer()
        for (_, a), (phase, b) in zip(marks, marks[1:]):
            tr.record_device(obs.LANE_COMPUTE, phase, a, b)
            out[phase] = obs.mark_seconds(a, b)

    # ------------------------------------------------------------ resume
    def _templates(self):
        """Reference-layout templates of the checkpointed trees: meta
        tensors (no memory), f32 so bf16 leaves come back exact."""
        meta = {n: torch.empty(p.shape, dtype=torch.float32, device="meta")
                for n, p in self.model.named_parameters()}
        tree = convert.to_reference_tree(meta, stack=torch.stack)
        opt = {"step": np.zeros((), np.int32), "m": tree, "v": tree,
               "master": tree if self.opt_state.master is not None else None}
        return {"params": tree, "opt": opt}

    def resume(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        restored, extra = self.ckpt.restore(latest, self._templates())
        convert.load_params_from_reference(self.model, restored["params"])
        self.opt_state = convert.opt_state_from_reference(self.model,
                                                          restored["opt"])
        self.step = int(extra["step"])
        self.loss_scale = LossScaleState(float(extra["loss_scale"]),
                                         int(extra["growth"]))
        self.data.restore(extra["data"])
        return True

    def _checkpoint(self, block: bool = False):
        path = self.ckpt.save(
            self.step,
            {"params": convert.params_to_reference(self.model),
             "opt": convert.opt_state_to_reference(self.opt_state)},
            extra={"step": self.step,
                   "loss_scale": float(self.loss_scale.scale),
                   "growth": int(self.loss_scale.growth_count),
                   "data": self.data.state()},
            block=block)
        self.report.checkpoints.append(path)

    # -------------------------------------------------------------- train
    def train(self, steps: Optional[int] = None,
              fault_hook: Optional[Callable[[int], None]] = None
              ) -> TrainReport:
        steps = steps if steps is not None else self.tcfg.steps
        tracer = obs.tracer()
        batch = self._next_batch()
        if self.rt is not None and not self._prepared:
            self.rt.prepare((self.model, batch, self.loss_scale.scale))
            self._prepared = True
        end = self.step + steps
        while self.step < end:
            try:
                with tracer.span(obs.LANE_TRAINER, "step", arg=self.step):
                    self._one_step(batch, fault_hook)
                batch = self._next_batch()
            except (KeyboardInterrupt, Exception) as e:  # noqa: BLE001
                self.report.failures.append(f"step {self.step}: {e!r}")
                self.ckpt.wait()
                self._checkpoint(block=True)   # emergency checkpoint
                raise
        with tracer.span(obs.LANE_TRAINER, "train_end"):
            self.ckpt.wait()
            if self.rt is not None:
                self.report.policystore = self.rt.policystore_stats()
                self.report.adapt = self.rt.service.stats()
        return self.report

    def _take_parts(self, parts) -> None:
        self._parts = parts

    def _one_step(self, batch, fault_hook=None):
        faults.tick(self.step)   # armed fault plans key off the iteration
        rt = self.rt
        tracer = obs.tracer()
        if rt is None:
            tracer.set_iteration(self.step)
        phases: Dict[str, float] = {}
        t0 = time.perf_counter()
        args = (self.model, batch, self.loss_scale.scale)
        fn = rt.step_fn(args) if rt is not None else self._grad
        with tracer.span(obs.LANE_COMPUTE, "train_step", arg=self.step):
            tg = time.perf_counter()
            (loss, grads, finite), marks = self._dispatch(
                fn, args, tracer.anchor(self.device))
            parts = self._parts              # before any replay of fn
            finite_h = bool(finite)          # waits for the device
            t_grad = time.perf_counter() - tg
            self._phases(marks, phases)
        ex = getattr(fn, "execution", None)
        if ex is not None:
            with tracer.span(obs.LANE_TRAINER, "settle"):
                ex.settle()                  # after the sync above: on a
            # card the grad dispatch left the policy's books open
            t_grad = max(t_grad - ex.last["copy_stall_s"], 0.0)
        if rt is not None:
            rt.record_dispatch("train", fn, args)
        if finite_h:
            with tracer.span(obs.LANE_COMPUTE, "apply_step", arg=self.step):
                (self.model, self.opt_state, _m), marks = self._dispatch(
                    self._apply, (self.model, self.opt_state, grads),
                    tracer.mark(self.device))
                self._sync()
                self._phases(marks, phases)
            if rt is not None:
                rt.record_dispatch("apply", self._apply,
                                   (self.model, self.opt_state, grads))
        else:
            self.report.skipped_steps.append(self.step)
        del grads
        self.loss_scale = update_loss_scale(self.loss_scale, finite_h)

        if (self.tcfg.eval_every
                and self.step > 0
                and self.step % self.tcfg.eval_every == 0):
            ebatch = self._device_batch(self.eval_data.next_batch())
            with tracer.span(obs.LANE_COMPUTE, "eval_step", arg=self.step):
                e0 = tracer.mark(self.device)
                el = self._eval(self.model, ebatch)
                marks = [("", e0), ("eval", tracer.mark(self.device))]
                el = float(el)
                self._phases(marks, phases)
            if rt is not None:
                rt.record_dispatch("eval", self._eval, (self.model, ebatch))
            self.report.eval_losses[self.step] = el
        tracer.resolve()
        phases["dispatch_s"] = sum(phases.values())

        dt = time.perf_counter() - t0
        if rt is not None:
            self.report.stages.append(rt.end_iteration(dt, t_grad).value)
        # flag on the full critical-path latency (compute + end_iteration
        # bookkeeping): a degraded host link or a drift stall shows up in
        # the wall time even when the step itself is healthy
        wall = time.perf_counter() - t0
        self.straggler.observe(self.step, wall)
        self.report.losses.append(float(loss))
        self.report.xent.append(float(parts["xent"]))
        self.report.aux.append(float(parts["aux"]))
        self.report.times.append(dt)
        self.report.grad_times.append(t_grad)
        self.report.device_phases.append(phases)
        self.report.wall_times.append(wall)
        self.step += 1
        # step is incremented BEFORE any failure can be raised for this
        # iteration: the emergency checkpoint then records post-step state
        # under step N+1 and resume does not replay an applied update.
        if fault_hook is not None:
            fault_hook(self.step - 1)

        if (self.tcfg.checkpoint_every
                and self.step % self.tcfg.checkpoint_every == 0):
            self._checkpoint()

        if self.metrics_out and self.step % self.metrics_every == 0:
            obs.metrics().write_jsonl(self.metrics_out)
