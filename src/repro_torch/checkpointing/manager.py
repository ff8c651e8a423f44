"""Fault-tolerant checkpointing.

Port of ``repro/checkpointing/manager.py``, with the same on-disk format:

  * **atomicity** — writes go to ``step_N.tmp.<proc>`` and are renamed to
    ``step_N`` only after the manifest (with a sha256 per shard file) is
    fsynced; a crashed writer never leaves a ``step_N`` that restore would
    trust;
  * **async** — arrays are snapshotted to host memory when ``save()`` is
    called and written by a background thread;
  * **per-process shards** — each process writes ``<tree>.p<i>.npz`` (one
    file per tree on one process) and ``manifest.p<i>.json``; a tree of
    global arrays (DTensor leaves) is written by process 0 alone;
  * **emergency saves** — the trainer calls ``save(..., block=True)`` from
    its failure handler;
  * **host-memory tier integration** — with a ``repro_torch.hostmem``
    transfer engine attached, snapshot staging goes through the engine's
    lowest-priority ``checkpoint`` traffic class (on the card: device
    tensors copied on that class's D2H stream into pinned slabs), so
    concurrent swaps and KV spills preempt the drain.

Trees are nested dicts whose leaves are torch tensors, numpy arrays or
scalars; ``None`` leaves are skipped.  A DTensor leaf (a sharded train
state, ``distributed.steps``) is saved whole: every rank gathers it
(``full_tensor``, a collective, so every rank saves), and only process 0
writes a tree that holds one, as the reference's single process writes
its global arrays once; another process restores such a tree from process
0's manifest.  So a sharded save restores on one device, in either
package.  ``restore(..., shardings=)`` re-places every leaf on a new mesh
(elastic restart after a lost node): each rank keeps its piece as a
DTensor.  Keys are the
reference's: path components joined by ``/`` (``blocks/attn/wq``,
``m/embed/tok``), so a checkpoint written by either package restores in
the other.  bf16 leaves are widened to f32 (exact), as numpy has no bf16;
restore casts every leaf back to its template's dtype.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch import faults, obs


def _leaves(tree, prefix=""):
    """(key, leaf) of every non-None leaf, keys joined by ``/``."""
    if tree is None:
        return
    if not isinstance(tree, Mapping):
        yield prefix, tree
        return
    for k, child in tree.items():
        yield from _leaves(child, f"{prefix}/{k}" if prefix else str(k))


def _host(leaf) -> Any:
    """A leaf as what gets saved: a numpy array (bf16 widened to f32), or a
    tensor on the device when an engine stages it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if hasattr(t, "full_tensor"):            # a DTensor: the whole array
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t
    return np.asarray(leaf)


def _is_global(tree) -> bool:
    """Whether ``tree`` holds a DTensor leaf (the same global arrays on
    every process)."""
    return any(hasattr(v, "full_tensor") for _, v in _leaves(tree))


def _to_numpy(x, own: bool = False) -> np.ndarray:
    """``x`` as a numpy array; with ``own``, a tensor's values as they are
    now, never a view of its storage (a CPU tensor's ``numpy()`` is one)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type != "cpu":
            return t.cpu().numpy()
        return t.numpy().copy() if own else t.numpy()
    return np.asarray(x)


def _process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _process_count() -> int:
    dist = torch.distributed
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


class CheckpointManager:
    # shard writes get a short bounded retry before the whole save fails —
    # transient filesystem hiccups should not cost a checkpoint
    WRITE_RETRIES = 2

    def __init__(self, directory: str, keep: int = 3,
                 process_index: Optional[int] = None, engine=None,
                 on_error: str = "raise"):
        if on_error not in ("raise", "degrade"):
            raise ValueError(f"on_error must be 'raise' or 'degrade', "
                             f"got {on_error!r}")
        self.dir = directory
        self.keep = keep
        self.proc = _process_index() if process_index is None else process_index
        os.makedirs(directory, exist_ok=True)
        # optional repro_torch.hostmem TransferEngine: snapshot staging goes
        # through its lowest-priority "checkpoint" traffic class
        self.engine = engine
        # "raise": an async write failure surfaces on the next wait().
        # "degrade": it is audited and counted, and training continues with
        # one fewer restore point.
        self.on_error = on_error
        self.n_write_failures = 0
        self.n_restore_fallbacks = 0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -------------------------------------------------- engine staging
    def _stage(self, name: str, flat: Dict[str, Any]):
        """Submit every array to the engine's checkpoint-class D2H stream;
        the writer thread collects the staged bytes later.  On the card the
        copies read the live tensors after the work already queued on the
        current stream; the current stream then waits for them, so a later
        in-place update cannot overwrite a tensor before it is staged.

        Each value is an array (nothing to stage) or ``(event, snapshot)``.
        A copy that failed for good at issue leaves the engine holding the
        live tensor, which the caller may update in place before the writer
        runs: its snapshot is taken to the host here, synchronously, so the
        checkpoint holds the values of ``save()`` (P8)."""
        from repro_torch.hostmem.engine import TC_CHECKPOINT
        staged = {}
        for key, arr in flat.items():
            src = (arr if isinstance(arr, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(arr)))
            if src.numel() == 0:         # pool rejects empty reservations
                staged[key] = _to_numpy(src)
                continue
            ev = self.engine.submit_swap_out(
                src.contiguous(), tag=f"ckpt/{name}/{key}", cls=TC_CHECKPOINT)
            if ev._cuda is not None:
                torch.cuda.current_stream(self.engine.device).wait_event(
                    ev._cuda[1])
            staged[key] = (ev, _to_numpy(src, own=True)
                           if ev.failed_at_issue else None)
        return staged

    def _collect(self, staged: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Drain the staged events back to plain arrays (writer side) and
        recycle their slabs."""
        out = {}
        for key, item in staged.items():
            if isinstance(item, np.ndarray):
                out[key] = item
                continue
            ev, snapshot = item
            self.engine.wait(ev)
            if ev.failed:
                # staging failed terminally: the engine freed the slab, and
                # _stage took the values to the host when save() was called
                out[key] = snapshot
                continue
            out[key] = _to_numpy(ev.block.read())
            self.engine.pool.free(ev.block)
            # staged checkpoint bytes leave the host tier here, with no
            # H2D copy — balance the ledger's per-class gauge
            obs.ledger().note_release(ev.cls, ev.tag, ev.nbytes)
        return out

    # ---------------------------------------------------------------- save
    def save(self, step: int, trees: Dict[str, Any],
             extra: Optional[dict] = None, block: bool = False) -> str:
        """Snapshot now, write async (unless block=True)."""
        self.wait()
        with obs.tracer().span(obs.LANE_CHECKPOINT, "ckpt.snapshot",
                               arg=step):
            snap = {name: {k: _host(v) for k, v in _leaves(tree)}
                    for name, tree in trees.items() if tree is not None}
            if self.proc != 0:   # process 0 writes the global trees
                snap = {name: flat for name, flat in snap.items()
                        if not _is_global(trees[name])}
                if not snap:
                    return os.path.join(self.dir, f"step_{step:08d}")
            if self.engine is None:
                snap = {name: {k: _to_numpy(v, own=True)
                               for k, v in flat.items()}
                        for name, flat in snap.items()}
        if self.engine is not None:
            from repro_torch.hostmem.engine import TC_CHECKPOINT
            # widen the class window to the whole drain so no copy is
            # forced inline here — the writer thread drains them all
            self.engine.set_class_depth(
                TC_CHECKPOINT,
                sum(len(flat) for flat in snap.values()) + 2)
            with obs.tracer().span(obs.LANE_CHECKPOINT, "ckpt.stage",
                                   arg=step):
                snap = {name: self._stage(name, flat)
                        for name, flat in snap.items()}
        extra = dict(extra or {})
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + f".tmp.{self.proc}"

        def write():
            try:
                with obs.tracer().span(obs.LANE_CHECKPOINT, "ckpt.write",
                                       arg=step):
                    self._write_body(step, snap, extra, tmp, final)
            except BaseException as e:   # surfaced on next wait()
                self._error = e
                if self.engine is not None:   # recycle any staged slabs
                    try:
                        for flat in snap.values():
                            for item in flat.values():
                                if isinstance(item, np.ndarray):
                                    continue
                                ev = item[0]
                                self.engine.wait(ev)
                                if ev.block is not None and not ev.block.freed:
                                    self.engine.pool.free(ev.block)
                                    obs.ledger().note_release(
                                        ev.cls, ev.tag, ev.nbytes)
                    except BaseException:
                        pass

        if block:
            write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        return final

    def _write_body(self, step, snap, extra, tmp, final):
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "time": time.time(),
                    "process_count": _process_count(),
                    "extra": extra, "trees": {}}
        for name, flat in snap.items():
            if self.engine is not None:
                with obs.tracer().span(obs.LANE_CHECKPOINT, "ckpt.collect",
                                       arg=name):
                    flat = self._collect(flat)
            fname = f"{name}.p{self.proc}.npz"
            path = os.path.join(tmp, fname)
            self._write_shard(path, fname, flat)
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            manifest["trees"][name] = {
                "file": fname, "sha256": digest,
                "keys": sorted(flat.keys())}
        mpath = os.path.join(tmp, f"manifest.p{self.proc}.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if not os.path.exists(final):
            os.replace(tmp, final)
        else:
            shutil.rmtree(tmp, ignore_errors=True)
        self._gc()

    def _write_shard(self, path: str, fname: str, flat) -> None:
        last: Optional[BaseException] = None
        for attempt in range(self.WRITE_RETRIES + 1):
            try:
                if faults.inject("ckpt.write", key=fname) is not None:
                    raise OSError(f"injected shard-write failure ({fname})")
                np.savez(path, **flat)
                return
            except OSError as e:
                last = e
                obs.audit().event("ckpt.write_retry", file=fname,
                                  attempt=attempt + 1, error=repr(e)[:120])
                obs.metrics().counter("ckpt_write_retries")
        raise last

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is None:
            return
        err, self._error = self._error, None
        self.n_write_failures += 1
        if self.on_error == "degrade":
            obs.audit().event("ckpt.write_failed", error=repr(err)[:200])
            obs.metrics().counter("ckpt_write_failures")
            return
        raise RuntimeError(f"async checkpoint write failed: {err!r}")

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except (ValueError, IndexError):
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, templates: Dict[str, Any],
                shardings: Optional[Dict[str, Any]] = None,
                fallback: bool = True):
        """Rebuild trees shaped like ``templates``; returns (trees, extra).
        A template leaf that is a tensor gives a tensor of its dtype on its
        device (on the CPU for a ``meta`` template); any other leaf gives a
        numpy array of its dtype.  ``shardings`` (the same structure, leaves
        ``sharding.NamedSharding``) re-places each leaf on a *new* mesh:
        this rank's piece, a DTensor on the mesh's device.

        When the requested checkpoint is unreadable (corrupt shard,
        truncated manifest, missing file) and ``fallback`` is True, each
        older ``step_N`` is tried in turn; the corruption is audited with the
        shard named, and only when no checkpoint is readable does the first
        error surface."""
        candidates = [step]
        if fallback:
            candidates += [s for s in reversed(self.all_steps()) if s < step]
        first_err: Optional[BaseException] = None
        for s in candidates:
            try:
                return self._restore_one(s, templates, shardings)
            except (OSError, KeyError, ValueError) as e:
                if first_err is None:
                    first_err = e
                obs.audit().event("ckpt.restore_failed", step=s,
                                  error=repr(e)[:200])
                obs.metrics().counter("ckpt_restore_failures")
                if s != candidates[-1]:
                    self.n_restore_fallbacks += 1
                    obs.audit().event("ckpt.restore_fallback", frm=s)
        raise first_err

    def _restore_one(self, step: int, templates: Dict[str, Any],
                     shardings: Optional[Dict[str, Any]] = None):
        d = os.path.join(self.dir, f"step_{step:08d}")

        def load(proc):
            with open(os.path.join(d, f"manifest.p{proc}.json")) as f:
                return json.load(f)

        # a process that wrote nothing of its own (every tree global)
        # restores from process 0's manifest
        own = (self.proc == 0 or os.path.exists(
            os.path.join(d, f"manifest.p{self.proc}.json")))
        manifest = load(self.proc if own else 0)
        out = {}
        for name, template in templates.items():
            if template is None:
                out[name] = None
                continue
            info = manifest["trees"].get(name)
            if info is None and self.proc != 0:     # a global tree
                info = load(0)["trees"][name]
            if info is None:
                raise KeyError(name)
            path = os.path.join(d, info["file"])
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            if digest != info["sha256"]:
                raise IOError(
                    f"checkpoint corruption in shard {info['file']} of "
                    f"step {step}: sha256 {digest[:12]} != manifest "
                    f"{info['sha256'][:12]} ({path})")
            with np.load(path) as z:
                flat = dict(z)
            out[name] = _rebuild(template, flat, "",
                                 (shardings or {}).get(name))
        return out, manifest["extra"]


def _place(t: torch.Tensor, sh) -> torch.Tensor:
    """This rank's piece of the whole tensor ``t`` under ``sh`` (a
    ``sharding.NamedSharding``), as a DTensor on the mesh's device."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as shd
    pl = sh.placements
    piece = shd.local_chunk(t, sh.mesh, pl).contiguous()
    return DTensor.from_local(piece.to(sh.mesh.device_type), sh.mesh, pl,
                              run_check=False)


def _rebuild(template, flat: Dict[str, np.ndarray], prefix: str, sh=None):
    if template is None:
        return None
    if not isinstance(template, Mapping):
        arr = flat[prefix]
        if isinstance(template, torch.Tensor):
            dev = (torch.device("cpu") if template.device.type == "meta"
                   else template.device)
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=dev, dtype=template.dtype)
            return t if sh is None else _place(t, sh)
        want = np.asarray(template).dtype
        return arr.astype(want) if arr.dtype != want else arr
    return {k: _rebuild(c, flat, f"{prefix}/{k}" if prefix else str(k),
                        None if sh is None else sh.get(k))
            for k, c in template.items()}
