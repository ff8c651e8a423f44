"""Train / serve step builders, on one device or sharded on a mesh.

Port of ``repro/distributed/steps.py``:

  * ``make_train_step`` — the fused iteration: scaled loss, backward,
    unscale, clip, schedule and AdamW (what the paper's profiler sees as one
    sequence);
  * ``make_grad_step`` / ``make_apply_step`` — the split pair the trainer
    dispatches, so a host-side loss-scale skip really drops the optimizer
    step from the iteration (§2.3);
  * ``make_eval_step`` — the loss alone, under ``torch.no_grad``;
  * ``make_prefill_step`` / ``make_decode_step`` — serving;
  * sharding-spec derivation for params / optimizer state (ZeRO stages).

PyTorch idiom: the model is an ``nn.Module``, gradients come from
``loss.backward()`` into ``.grad`` and are handed on as tensors keyed by
parameter name; ``apply_step`` updates the parameters and the optimizer
state in place.  The grad step unscales each gradient as the reference's
does, ``g / loss_scale`` with the scale an f32 scalar, so a bf16 gradient
becomes f32 (JAX promotes bf16 / f32 to f32); the fused step divides in
the gradient's own dtype, as the reference's ``make_train_step`` does.

``policy`` is what the reference's step builders take as a remat policy:
here an ``Execution`` (``core.executor.Executor.execution``), the context
the forward and backward run under to apply a swap policy, or None for
plain autograd.  The unscale, the finiteness check and the optimizer run
after it, unchanged; on a card the execution's copies are retired, and
its books closed, by its ``settle`` after the finiteness check
(``runtime.trainer``).

Sharded training (eager, so the reference's jit shardings become explicit
collectives on the mesh's process groups).  ``shard_model`` turns a model
and its AdamW state into a ``ShardedModel`` (this rank's share) and a state
whose ``m`` / ``v`` / ``master`` are DTensors laid out as ``opt_specs``
says; ``make_train_step`` takes either.  ZeRO mapping (DeepSpeed-analogue
the paper builds on), "sharding specs, not different math":

  * ZeRO 0: every rank keeps everything; gradients are averaged over the
    batch dims (all-reduce);
  * ZeRO 1/2: the optimizer state shards over the batch dims on the
    ``embed`` dim (``ZERO_OPT_RULES``); the gradients are reduce-scattered
    to that layout (``grad_shardings``, when given, must name it), AdamW
    runs on the local shard and the parameters are all-gathered back;
  * ZeRO 3 (``ZERO3_PARAM_RULES``, or rules that put ``embed`` on the
    batch dims, as ``DP_ONLY_RULES`` do): the parameters shard the same
    way at rest and are gathered at use, one unit at a time (below);
  * tensor parallelism over ``model``: each rank holds its slice of the
    attention (heads), MLP (``mlp``), MoE (``experts``), vocabulary
    (``vocab``: the embedding's rows, the unembedding's columns, a
    vocab-parallel loss) and Mamba-2 (``ssm``: its heads) weights and runs
    the model code on them with a local config, its own on each model rank
    (``TpPlan``, ``sharding.tp_enter`` / ``tp_exit`` / ``tp_sum``), so K1,
    K4, the executor's hooks and the recorder see plain local tensors.  A
    weight the rules split over ``model`` that a rank cannot compute a
    slice of (the router) is held split at rest and gathered at use, its
    compute whole on every rank.  Under the default rules the decode cache
    splits its positions over ``model`` (``kv_seq``, ``models.attention``);
    ``make_prefill_step`` and ``make_decode_step`` all-gather the logits
    over the vocabulary.

Gather at use: the model code runs each unit (a block, the embedding, a
final norm, whisper's root) through ``nn.Module.__call__``
(``models.layers.Unit``).  A forward pre-hook all-gathers the unit's
weights split at rest into their parameters' own storage, a forward hook
frees that storage, a hook on the unit's outputs gathers them again before
its backward (a remat policy recomputes inside it), and when a parameter's
gradient is accumulated it goes to its state's layout at once (sliced over
``model`` where the rank computed it whole, summed where partial,
reduce-scattered over the batch dims) and its weight is freed.  Nothing
is hooked on a one-rank mesh.

Attention splits by query heads, a contiguous run a model rank
(``sharding.head_runs``: the longer runs on the lower ranks, none where
the model dim exceeds the heads), as the reference's padded split of
``act_heads`` puts at most as many on a chip.  Layouts that differ from
the rules (results equal): the KV projections shard with the query heads
when the model dim divides the KV heads (the rules replicate them); when
it does not, they stay whole on every rank and each rank computes the KV
heads its query heads read (``sharding.kv_slice``), their gradients summed
over ``model``.  Where the model dim does not divide the query heads
(qwen2-7b's 28, whisper's 20 over 16) the query and output projections
stay split at rest as the rules split ``q_dim`` (evenly) and are gathered
at use, a unit at a time; each rank narrows them to its heads
(``sharding.q_slice``) and their whole-shaped partial gradients are
reduce-scattered over ``model`` to the pieces at rest (the reference's
route moves activations with an all-to-all instead; this keeps the
weights' gather).  Mamba-2's B and C columns of the in-projection and
their conv channels split over ``model`` where it divides 2 x
``ssm_state`` (``ssm_bc``; all-gathered after the conv, ``models.ssm``).
Where the reference's per-chip work is still not matched
(``ShardedModel.departures``, the dry run's record): B and C whole on
every rank where the model dim does not divide 2 x ``ssm_state``
(``ParamLayout.runs``).  ``ShardedModel.layouts`` holds what each
parameter got.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.loss_scale import check_finite
from repro_torch.optim.schedules import warmup_cosine


ZERO_OPT_RULES = {"embed": ("pod", "data"), "layers": None}
ZERO3_PARAM_RULES = {"embed": ("pod", "data")}


# --------------------------------------------------------- sharding specs
def _axis_size(entry, mesh) -> int:
    if entry is None:
        return 1
    sizes = shd.mesh_shape(mesh)
    n = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n *= sizes[a]
    return n


def _shape(x):
    return tuple(getattr(x, "shape", ()))


def sanitize_specs(spec_tree, sds_tree, mesh):
    """Drop sharding on dims the mesh cannot divide evenly (e.g. vocab
    49155 or 20 heads fall back to replication on that dim).  Trees are
    dicts keyed alike; a leaf of ``sds_tree`` is anything with ``shape``."""
    if mesh is None:
        return spec_tree
    if isinstance(spec_tree, dict):
        return {k: sanitize_specs(v, sds_tree[k], mesh)
                for k, v in spec_tree.items()}
    shape = _shape(sds_tree)
    entries = list(spec_tree) + [None] * (len(shape) - len(spec_tree))
    return tuple(e if dim % _axis_size(e, mesh) == 0 else None
                 for dim, e in zip(shape, entries[:len(shape)]))


def param_specs(axes_tree, mesh, zero3: bool = False, sds_tree=None):
    rules = ZERO3_PARAM_RULES if zero3 else None
    with shd.use_mesh(mesh, rules):
        spec = shd.tree_spec(axes_tree, mesh)
    if sds_tree is not None:
        spec = sanitize_specs(spec, sds_tree, mesh)
    return spec


def opt_specs(axes_tree, mesh, zero_stage: int,
              opt_sds: Optional[AdamWState] = None) -> AdamWState:
    rules = ZERO_OPT_RULES if zero_stage >= 1 else None
    with shd.use_mesh(mesh, rules):
        p_spec = shd.tree_spec(axes_tree, mesh)
    out = AdamWState((), p_spec, p_spec, p_spec)
    if opt_sds is not None:
        out = AdamWState(
            (), sanitize_specs(out.m, opt_sds.m, mesh),
            sanitize_specs(out.v, opt_sds.v, mesh),
            sanitize_specs(out.master, opt_sds.master, mesh)
            if opt_sds.master is not None else None)
    return out


def batch_specs_sharding(batch_tree, mesh):
    """Partition specs of a batch: the leading dim over the batch dims."""
    if mesh is None:
        return None
    axes = tuple(a for a in ("pod", "data") if a in shd.mesh_names(mesh))
    return {k: (axes,) + (None,) * (len(_shape(x)) - 1)
            for k, x in batch_tree.items()}


def to_shardings(spec_tree, mesh):
    """Partition specs -> ``NamedSharding``s (dicts / AdamWState trees)."""
    if mesh is None or spec_tree is None:
        return None
    if isinstance(spec_tree, dict):
        return {k: to_shardings(v, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, AdamWState):
        return AdamWState(*[to_shardings(v, mesh) for v in spec_tree])
    return shd.NamedSharding(mesh, tuple(spec_tree))


# ------------------------------------------------------------- state init
def _model_class(cfg: ModelConfig):
    from repro_torch.models import transformer, whisper
    return whisper.Model if cfg.family == "encdec" else transformer.Model


def abstract_model(cfg: ModelConfig, *, device="cpu", mode=None
                   ) -> nn.Module:
    """The model with fake-tensor weights: no allocation (dry run safe).
    ``mode``: the ``FakeTensorMode`` to make them in (a new one by
    default)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = mode or FakeTensorMode()
    with mode:
        return _model_class(cfg)(cfg, generator=None,
                                 device=torch.device(device))


def abstract_params(cfg: ModelConfig, *, device="cpu", mode=None
                    ) -> Dict[str, torch.Tensor]:
    """Fake tensors for the parameters, keyed by name."""
    return dict(abstract_model(cfg, device=device,
                               mode=mode).named_parameters())


def abstract_train_state(cfg: ModelConfig, *, device="cpu", mode=None):
    """(params, AdamW state), fake tensors in one ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = mode or FakeTensorMode()
    params = abstract_params(cfg, device=device, mode=mode)
    with mode:
        opt = adamw_init(params)
    return params, opt


@functools.lru_cache(maxsize=64)
def param_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical axes of every parameter, keyed by the port's name, from each
    module's own ``AXES`` declaration (the model built on ``meta``)."""
    model = _model_class(cfg)(cfg, generator=None,
                              device=torch.device("meta"))
    out = {}
    for name, _ in model.named_parameters():
        path, attr = name.rpartition(".")[::2]
        out[name] = type(model.get_submodule(path)).AXES[attr]
    return out


# ------------------------------------------------------ sharded training
# tensor dim each block parameter splits over the model dim (local compute)
_TP_DIMS = {
    "attn": {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0, "bv": 0},
    "mlp": {"wi_gate": 1, "wi_up": 1, "wo": 0},
    "moe": {"wi_gate": 0, "wi_up": 0, "wo": 0},
    "vocab": {"tok": 0, "unembed": 1},
    "ssm": {"in_proj": 1, "conv_w": 1, "conv_b": 0, "A_log": 0,
            "dt_bias": 0, "D": 0, "norm_scale": 0, "out_proj": 0},
}
_KV_PARAMS = ("wk", "wv", "bk", "bv")
_Q_PARAMS = ("wq", "bq", "wo")
_BLOCKS = (("attn", "attn"), ("xattn", "attn"), ("mlp", "mlp"),
           ("moe", "moe"), ("ssm", "ssm"))


def _block_of(name: str) -> Optional[str]:
    parts = name.split(".")
    for part, blk in _BLOCKS:
        if part in parts:
            return blk
    return "vocab" if parts[0] == "embed" else None


def _ssm_runs(cfg: ModelConfig, attr: str, bc_split: bool):
    """(length, split) runs along the model dim of a Mamba-2 parameter
    under an ``ssm`` plan: z / x / dt columns and x channels split by
    heads, the B / C columns and channels split too where the plan holds
    ``ssm_bc`` (each rank convolves its own and all-gathers them), else
    whole (every head reads them)."""
    di, ds = cfg.ssm_d_inner, cfg.ssm_state
    bc = (2 * ds, bc_split)
    if attr == "in_proj":
        return ((di, True), (di, True), bc, (cfg.ssm_heads, True))
    if attr in ("conv_w", "conv_b"):
        return ((di, True), bc)
    return None


class ParamLayout(NamedTuple):
    """Where one parameter lives on the mesh: the partition specs of the
    stored parameter and of its optimizer state (global), the tensor dim
    it splits over the model dim, the dims it and its state split over the
    batch dims, and whether each model rank's gradient is partial (a rank
    computes its own heads of a whole KV projection, ``TpPlan.kv``, or of a
    query / output projection gathered whole, ``TpPlan.q``) and is summed
    over the model dim.  ``gather_tp``: the rules split it over the model
    dim on ``tp_dim`` but a rank computes with it whole (the router) or
    takes its heads out of it whole (attention whose query heads the model
    dim does not divide): held split at rest and in its state, gathered at
    use; the whole gradient each model rank computes alike is sliced, a
    partial one (``tp_sum``) reduce-scattered.  ``runs``: (length, split)
    runs along ``tp_dim`` (Mamba-2's fused in-projection and conv): a split
    run is divided over the model dim, a whole run is on every rank and its
    partial gradients are summed over it; the specs then leave the model
    dim out."""
    param: tuple
    opt: tuple
    tp_dim: Optional[int]
    dp_param: Optional[int]
    dp_opt: Optional[int]
    tp_sum: bool = False
    gather_tp: bool = False
    runs: Optional[tuple] = None


def _attn_split(cfg: ModelConfig, tp: int):
    """How the model dim splits the attention: None where there are no
    heads, ``"shard"`` where it divides the query and the KV heads (each
    rank's slices of every projection), else every rank's run of heads
    (``sharding.head_runs``)."""
    H, Kh = cfg.num_heads, cfg.num_kv_heads
    if not H:
        return None
    if H % tp == 0 and Kh % tp == 0:
        return "shard"
    return shd.head_runs(H, Kh, tp)


def _on_model(logical: str) -> bool:
    return shd.partition_spec((logical,))[:1] == ("model",)


def _tp_blocks(cfg: ModelConfig, tp: int) -> frozenset:
    blocks = set()
    if _attn_split(cfg, tp) is not None:
        blocks.add("attn")
    if cfg.d_ff and cfg.d_ff % tp == 0:
        blocks.add("mlp")
    if (cfg.family == "moe" and cfg.num_experts % tp == 0
            and _on_model("experts")):
        blocks.add("moe")
    if cfg.vocab_size % tp == 0 and _on_model("vocab"):
        blocks.add("vocab")
    if (cfg.family in ("ssm", "hybrid") and cfg.ssm_heads % tp == 0
            and _on_model("ssm_heads") and _on_model("ssm_inner")):
        blocks.add("ssm")
        if 2 * cfg.ssm_state % tp == 0:
            blocks.add("ssm_bc")
    return frozenset(blocks)


def _local_cfg(cfg: ModelConfig, blocks, tp: int, split, rank: int
               ) -> ModelConfig:
    """The config model rank ``rank`` runs: its heads (none where the model
    dim exceeds them) and its share of the MLP."""
    kw = {}
    if "attn" in blocks:
        if split == "shard":
            kw.update(num_heads=cfg.num_heads // tp,
                      num_kv_heads=cfg.num_kv_heads // tp)
        else:
            kw.update(num_heads=split[rank].count,
                      num_kv_heads=len(split[rank].kv))
    if "mlp" in blocks:
        kw["d_ff"] = cfg.d_ff // tp
    return cfg.replace(**kw) if kw else cfg


def _layout(pspec: tuple, ndim: int, tp_dim, tp_axis, batch: tuple,
            what: str) -> Tuple[tuple, Optional[int]]:
    """A rule-derived spec with the model dim where local compute puts it,
    and the dim it splits over the batch dims."""
    entries = list(pspec) + [None] * (ndim - len(pspec))
    out, dp = [], None
    for d, e in enumerate(entries):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        if tp_axis is not None:
            axes = tuple(a for a in axes if a != tp_axis)
        if axes:
            if tuple(axes) != batch:
                raise NotImplementedError(
                    f"{what}: dim {d} on {axes}; the sharded step splits "
                    f"a dim over all the batch dims {batch} or none")
            dp = d
        if d == tp_dim:
            axes = axes + (tp_axis,)
        out.append(None if not axes else
                   axes[0] if len(axes) == 1 else axes)
    return tuple(out), dp


def _model_dim(pspec: tuple, axis: str) -> Optional[int]:
    """The tensor dim partition spec ``pspec`` splits over mesh dim
    ``axis``, or None."""
    for d, e in enumerate(pspec):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return d
    return None


def _split(t: torch.Tensor, dim: Optional[int], idx: int, n: int):
    return t if dim is None or n == 1 else t.tensor_split(n, dim)[idx]


def _tp_piece(t: torch.Tensor, lay: ParamLayout, rank: int, n: int):
    """Model rank ``rank``'s piece of the whole ``t`` along ``lay.tp_dim``
    (its runs' pieces, concatenated, where it has runs)."""
    if lay.runs is None or n == 1:
        return _split(t, lay.tp_dim, rank, n)
    parts, off = [], 0
    for length, split in lay.runs:
        run = t.narrow(lay.tp_dim, off, length)
        parts.append(_split(run, lay.tp_dim, rank, n) if split else run)
        off += length
    return torch.cat(parts, lay.tp_dim)


def _whole_runs(lay: ParamLayout, n: int):
    """(offset, length) of each whole run in a model rank's piece."""
    out, off = [], 0
    for length, split in lay.runs:
        if not split:
            out.append((off, length))
        off += length // n if split else length
    return out


def _gather(shard: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """All-gather ``shard`` over ``group`` (``n`` ranks) along ``dim``."""
    return shard if n == 1 else shd.all_gather(shard, dim, group)


def _own(piece: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """``piece`` contiguous, in a storage of its own when it is a part of
    ``whole`` (a view would keep all of ``whole`` alive); ``whole``'s
    storage when it is all of it."""
    if piece.numel() == whole.numel():
        return piece.contiguous()
    return piece.clone(memory_format=torch.contiguous_format)


def _set_param(module: nn.Module, name: str, t: torch.Tensor) -> None:
    path, attr = name.rpartition(".")[::2]
    setattr(module.get_submodule(path), attr, nn.Parameter(t))


def _units(root: nn.Module):
    """(unit, its parameters): every ``Unit`` of the model's tree that no
    other unit holds, and the root's own parameters when it is a unit."""
    from repro_torch.models.layers import Unit
    out = []

    def walk(m):
        for c in m.children():
            if isinstance(c, Unit):
                out.append((c, list(c.parameters())))
            else:
                walk(c)

    walk(root)
    if isinstance(root, Unit):
        out.append((root, list(root.parameters(recurse=False))))
    return out


def _grad_ready(ref, n: str, p: torch.Tensor) -> None:
    """A parameter's gradient is whole: to its state's layout, and its
    gathered weight freed (``ShardedModel._gather_at_use``)."""
    sm = ref()
    if sm is None:
        return
    sm.grads[n] = sm.grad_to_state(n, p.grad)
    p.grad = None
    sm._done.add(n)
    sm.release((n,))


def _regather(ref, names, _grad) -> None:
    """A unit's backward is next: its weights gathered again."""
    sm = ref()
    if sm is not None:
        sm.gather(names, backward=True)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


class ShardedModel:
    """This rank's share of a model on a mesh (``shard_model``): the local
    module (its weights this rank's slices along the model dim), the local
    config the model code runs with, the TP plan and every parameter's
    ``ParamLayout``.  A parameter split at rest (over the batch dims under
    ZeRO 3, over the model dim where ``gather_tp``) keeps its piece in
    ``shards``; the module's parameter keeps its shape with its storage
    freed, and is gathered into that same storage only while a unit that
    uses it runs (``_gather_at_use``): saved references see it again in the
    backward.  ``grads`` takes each gradient in its state's layout as the
    backward produces it; ``gathered_bytes`` / ``peak_gathered_bytes`` count
    the gathered weights."""

    def __init__(self, cfg: ModelConfig, module: nn.Module, local_cfg,
                 mesh, rules, plan: shd.TpPlan, layouts, batch_dims):
        self.cfg, self.module, self.local_cfg = cfg, module, local_cfg
        self.mesh, self.rules, self.plan = mesh, rules, plan
        self.layouts: Dict[str, ParamLayout] = layouts
        self.dp_rank, self.dp = (shd.coordinate(mesh, batch_dims)
                                 if batch_dims else (0, 1))
        self.dp_group = shd.group_of(mesh, batch_dims)
        self.world_group = shd.group_of(mesh, shd.mesh_names(mesh))
        self.shards: Dict[str, torch.Tensor] = {}
        self.grads: Dict[str, torch.Tensor] = {}
        self._params = dict(module.named_parameters())
        self._gathered: Dict[str, int] = {}
        self._done: set = set()
        self.gathered_bytes = 0
        self.peak_gathered_bytes = 0

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @contextlib.contextmanager
    def context(self):
        """The mesh, its rules and the TP plan, for the model code."""
        with shd.use_mesh(self.mesh, self.rules), shd.local_tp(self.plan):
            yield

    # ------------------------------------------------ storage at rest
    def split_at_rest(self, n: str) -> bool:
        lay = self.layouts[n]
        return ((lay.dp_param is not None and self.dp > 1)
                or (lay.gather_tp and self.plan.size > 1))

    def _assemble(self, n: str) -> torch.Tensor:
        lay, t = self.layouts[n], self.shards[n]
        if lay.dp_param is not None:
            t = _gather(t, lay.dp_param, self.dp_group, self.dp)
        if lay.gather_tp:
            t = _gather(t, lay.tp_dim, self.plan.group, self.plan.size)
        return t

    def gather(self, names, backward: bool = False) -> None:
        """All-gather the pieces of ``names`` into their parameters'
        storage (in the backward, only those whose gradient is not in)."""
        for n in names:
            if (n in self._gathered or n not in self.shards
                    or (backward and n in self._done)):
                continue
            p = self._params[n]
            full = self._assemble(n)
            nb = p.numel() * p.element_size()
            p.untyped_storage().resize_(nb)
            with torch.no_grad(), \
                    torch.autograd._unsafe_preserve_version_counter(p):
                p.copy_(full)
            self._gathered[n] = nb
            self.gathered_bytes += nb
            self.peak_gathered_bytes = max(self.peak_gathered_bytes,
                                           self.gathered_bytes)

    def release(self, names) -> None:
        """Free the storage of the gathered parameters among ``names``."""
        for n in names:
            nb = self._gathered.pop(n, None)
            if nb is not None:
                self._params[n].untyped_storage().resize_(0)
                self.gathered_bytes -= nb

    def rest(self, n: str) -> torch.Tensor:
        """The tensor that holds ``n`` between steps."""
        return self.shards[n] if n in self.shards else \
            self._params[n].detach()

    def state_view(self, n: str) -> torch.Tensor:
        """``n``'s piece in its optimizer state's layout (a view of
        ``rest(n)`` that AdamW updates in place)."""
        lay = self.layouts[n]
        return _split(self.rest(n), None if lay.dp_param is not None
                      else lay.dp_opt, self.dp_rank, self.dp)

    # ---------------------------------------------------- gradients
    def grad_to_state(self, n: str, g: torch.Tensor) -> torch.Tensor:
        """A rank's gradient of ``n`` -> its state's layout: sliced over the
        model dim (``gather_tp``; reduce-scattered where it is partial),
        partial parts summed over it, then reduce-scattered (or averaged)
        over the batch dims."""
        lay, plan = self.layouts[n], self.plan
        if plan.size > 1:
            if lay.gather_tp and lay.tp_sum:
                g = shd.reduce_scatter(g, lay.tp_dim, plan.group)
            elif lay.gather_tp:
                g = _split(g, lay.tp_dim, plan.rank, plan.size).clone(
                    memory_format=torch.contiguous_format)
            elif lay.tp_sum:
                g = shd.all_sum(g, plan.group)
            elif lay.runs is not None:
                g = g.clone()
                for off, length in _whole_runs(lay, plan.size):
                    run = g.narrow(lay.tp_dim, off, length)
                    run.copy_(shd.all_sum(run, plan.group))
        if self.dp > 1:
            if lay.dp_opt is not None:
                g = shd.reduce_scatter(g, lay.dp_opt, self.dp_group)
            else:
                g = shd.all_sum(g, self.dp_group)
            g = g / self.dp
        return g

    def sq_norm(self, n: str, g: torch.Tensor) -> Optional[torch.Tensor]:
        """The sum of squares of the part of ``n``'s gradient piece that
        this rank counts toward the global norm (each element once over
        the mesh), or None."""
        lay, plan = self.layouts[n], self.plan
        if ((lay.tp_dim is None and plan.rank != 0)
                or (lay.dp_opt is None and self.dp_rank != 0)):
            return None
        if lay.runs is not None and plan.rank != 0 and plan.size > 1:
            g = g.clone()
            for off, length in _whole_runs(lay, plan.size):
                g.narrow(lay.tp_dim, off, length).zero_()
        return torch.sum(torch.square(g.to(torch.float32)))

    # ---------------------------------------------------- the hooks
    def _gather_at_use(self) -> None:
        """Per unit of the model (``_units``): a forward pre-hook gathers
        its weights split at rest, a forward hook frees them and, under
        autograd, hooks the unit's output to gather them again before its
        backward (a remat policy's recompute runs inside it); on a mesh of
        more than one rank each parameter's gradient goes to its state's
        layout as it is accumulated, and a gathered weight is freed then.
        On one rank nothing is hooked."""
        name_of = {id(p): n for n, p in self._params.items()}
        owned = set()
        for unit, params in _units(self.module):
            names = tuple(name_of[id(p)] for p in params
                          if name_of[id(p)] in self.shards)
            owned.update(names)
            if names:
                unit.register_forward_pre_hook(
                    functools.partial(self._pre, names))
                unit.register_forward_hook(
                    functools.partial(self._post, names))
        if set(self.shards) - owned:
            raise NotImplementedError(
                "split at rest outside any unit of the model: "
                + ", ".join(sorted(set(self.shards) - owned)))
        if self.mesh.size() > 1:
            # weakly (as in _post): the collector does not see a cycle
            # through a tensor's hooks, which would keep this model alive
            me = weakref.ref(self)
            for n, p in self._params.items():
                p.register_post_accumulate_grad_hook(
                    functools.partial(_grad_ready, me, n))

    def _pre(self, names, _module, _args) -> None:
        self.gather(names)

    def _post(self, names, _module, _args, out) -> None:
        self.release(names)
        if torch.is_grad_enabled():
            # the unit's main output (a block's x, not a MoE block's aux,
            # whose gradient comes first): its gradient is in just before
            # the unit's backward starts
            outs = [t for t in _tensors(out) if t.requires_grad]
            if outs:
                outs[0].register_hook(functools.partial(
                    _regather, weakref.ref(self), names))

    def begin_step(self) -> None:
        self.grads.clear()
        self._done.clear()

    def end_backward(self) -> None:
        self.release(tuple(self._gathered))

    # ------------------------------------------------------- DTensor views
    def _whole_over_model(self, n: str, local: torch.Tensor) -> torch.Tensor:
        """A parameter with runs, whole over the model dim: every rank's
        piece gathered and each split run put back together."""
        lay, tp = self.layouts[n], self.plan.size
        pieces = _gather(local, lay.tp_dim, self.plan.group, tp).tensor_split(
            tp, lay.tp_dim)
        parts, off = [], 0
        for length, split in lay.runs:
            step = length // tp if split else length
            if split:
                parts += [q.narrow(lay.tp_dim, off, step) for q in pieces]
            else:
                parts.append(pieces[0].narrow(lay.tp_dim, off, step))
            off += step
        return torch.cat(parts, lay.tp_dim)

    def params(self) -> Dict[str, Any]:
        """Every parameter as a DTensor in its global layout (``shards``
        or the module's weights as the local pieces; a parameter with runs
        made whole over the model dim); for checkpoints."""
        from torch.distributed.tensor import DTensor
        out = {}
        for n in self._params:
            lay, local = self.layouts[n], self.rest(n)
            if lay.runs is not None and self.plan.size > 1:
                local = self._whole_over_model(n, local)
            out[n] = DTensor.from_local(
                local, self.mesh, shd.to_placements(lay.param, self.mesh),
                run_check=False)
        return out

    def departures(self) -> dict:
        """What this layout computes or holds whole over the model dim
        where the reference's rules split it (the module doc): {block:
        bytes} of the weights gathered whole for compute (the router's
        excepted: the reference's expert-parallel layer takes it whole
        too; a weight of which a rank computes only its heads is not), and
        the bytes of Mamba-2's whole B / C runs per chip."""
        whole: Dict[str, int] = {}
        bc = 0
        for n, lay in self.layouts.items():
            p = self._params[n]
            if lay.gather_tp and not lay.tp_sum and self.plan.size > 1 \
                    and not n.endswith(".router"):
                blk = _block_of(n) or n.rpartition(".")[2]
                whole[blk] = whole.get(blk, 0) + p.numel() * p.element_size()
            elif lay.runs is not None and self.plan.size > 1:
                per = p.numel() // p.shape[lay.tp_dim] * p.element_size()
                bc += sum(length for length, split in lay.runs
                          if not split) * per
        return {"computed_whole": whole, "ssm_bc_bytes": int(bc)}


def shard_model(cfg: ModelConfig, model: nn.Module, mesh,
                opt_state: Optional[AdamWState] = None, *,
                zero_stage: int = 2, rules: Optional[dict] = None
                ) -> Tuple[ShardedModel, Optional[AdamWState]]:
    """This rank's ``ShardedModel`` of the full ``model`` (every rank holds
    the same weights) and, given ``opt_state`` (the full AdamW state), its
    share of it with DTensor ``m`` / ``v`` / ``master``.  A piece smaller
    than its full tensor gets a storage of its own (a view would keep the
    whole alive); a whole one shares the full tensor's (a one-rank mesh
    copies nothing)."""
    from torch.distributed.tensor import DTensor
    with shd.use_mesh(mesh, rules):
        merged = shd.current_rules()
        batch = shd.resolve_axes("batch", mesh)
        names = shd.mesh_names(mesh)
        tp_axis = "model" if "model" in names and "model" not in batch \
            else None
        tp_rank, tp = (shd.coordinate(mesh, (tp_axis,)) if tp_axis
                       else (0, 1))
        blocks = _tp_blocks(cfg, tp) if tp_axis else frozenset()
        split = _attn_split(cfg, tp) if "attn" in blocks else None
        heads = split if isinstance(split, tuple) else None
        kv = heads[tp_rank].kv if heads else None
        q = (heads[tp_rank][:2] if heads and cfg.num_heads % tp
             else None)
        kv_seq = (cfg.num_kv_heads if tp_axis and cfg.num_kv_heads
                  and _on_model("kv_seq") else None)
        plan = shd.TpPlan(shd.group_of(mesh, (tp_axis,)) if tp_axis
                          else None, tp, tp_rank, blocks, kv, kv_seq, q,
                          heads)
        full = dict(model.named_parameters())
        axes = param_axes(cfg)
        zero3 = zero_stage >= 3
        p_spec = param_specs(axes, mesh, zero3=zero3, sds_tree=full)
        o_spec = opt_specs(axes, mesh, zero_stage,
                           opt_sds=AdamWState((), full, full, full)).m
    layouts = {}
    for n, t in full.items():
        blk = _block_of(n)
        attr = n.rpartition(".")[2]
        # a rank computes its heads out of the whole weight: the gradient
        # is partial; the KV projections stay whole on every rank, the
        # query and output projections are held as the rules split them
        kv_whole = blk == "attn" and kv is not None and attr in _KV_PARAMS
        tp_sum = kv_whole or (blk == "attn" and q is not None
                              and attr in _Q_PARAMS)
        tp_dim = (_TP_DIMS[blk].get(attr)
                  if blk in blocks and not tp_sum else None)
        runs = (_ssm_runs(cfg, attr, "ssm_bc" in blocks)
                if blk == "ssm" and tp_dim is not None else None)
        gather_tp = False
        if tp_dim is None and tp_axis is not None and not kv_whole:
            tp_dim = _model_dim(p_spec[n], tp_axis)
            gather_tp = tp_dim is not None
        spec_dim = None if runs else tp_dim
        ps, dp_p = _layout(p_spec[n], t.dim(), spec_dim, tp_axis, batch, n)
        os_, dp_o = _layout(o_spec[n], t.dim(), spec_dim, tp_axis, batch, n)
        if dp_p is not None and dp_p != dp_o:
            raise NotImplementedError(f"{n}: parameter and state split "
                                      f"different dims over the batch")
        layouts[n] = ParamLayout(ps, os_, tp_dim, dp_p, dp_o, tp_sum,
                                 gather_tp, runs)
    lcfg = _local_cfg(cfg, blocks, tp, split, tp_rank)
    module = _model_class(lcfg)(lcfg, generator=None,
                                device=torch.device("meta"))
    sm = ShardedModel(cfg, module, lcfg, mesh, merged, plan, layouts, batch)
    for n, t in full.items():
        lay = layouts[n]
        if not sm.split_at_rest(n):
            piece = t if lay.gather_tp else _tp_piece(t.detach(), lay,
                                                      tp_rank, tp)
            _set_param(module, n, _own(piece.detach(), t))
            continue
        piece = _split(t.detach(), lay.tp_dim, tp_rank, tp) \
            if lay.gather_tp else _tp_piece(t.detach(), lay, tp_rank, tp)
        sm.shards[n] = _split(piece, lay.dp_param, sm.dp_rank,
                              sm.dp).clone(
                                  memory_format=torch.contiguous_format)
        _set_param(module, n, torch.empty(
            t.shape if lay.gather_tp else piece.shape, dtype=t.dtype,
            device=t.device))
    sm._params = dict(module.named_parameters())
    for n in sm.shards:                 # at rest: the shape, no storage
        sm._params[n].untyped_storage().resize_(0)
    sm._gather_at_use()
    if opt_state is None:
        return sm, None

    def local(n, t):
        lay = layouts[n]
        piece = _own(_split(_tp_piece(t, lay, tp_rank, tp), lay.dp_opt,
                            sm.dp_rank, sm.dp), t)
        return DTensor.from_local(piece, mesh,
                                  shd.to_placements(lay.opt, mesh),
                                  run_check=False)

    def tree(d):
        return None if d is None else {n: local(n, t) for n, t in d.items()}

    return sm, AdamWState(opt_state.step, tree(opt_state.m),
                          tree(opt_state.v), tree(opt_state.master))


def shard_batch(batch: Dict[str, torch.Tensor], mesh, rules=None
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: the leading dim split over the
    batch dims (``batch_specs_sharding``)."""
    with shd.use_mesh(mesh, rules):
        dims = shd.resolve_axes("batch", mesh)
    if not dims:
        return dict(batch)
    i, n = shd.coordinate(mesh, dims)
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} does not split over {n} ranks "
                         f"of {dims}")
    return {k: v.tensor_split(n, 0)[i] for k, v in batch.items()}


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _sharded_train_step(sm: ShardedModel, opt_state: AdamWState, batch,
                        loss_scale, tcfg: TrainConfig, policy):
    """One fused iteration on this rank's share (module doc)."""
    sm.begin_step()
    with sm.context():
        loss, params, _m = _backward(make_loss_fn(sm.local_cfg), sm.module,
                                     batch, loss_scale, policy, fill=False)
    sm.end_backward()
    if sm.dp > 1:
        loss = shd.mean(loss, sm.dp_group)
    grads, views = {}, {}
    for n, p in params.items():
        g = sm.grads.pop(n, None)
        if g is None:                   # one rank, or unused by the loss
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            g = sm.grad_to_state(n, g)
        grads[n] = g / torch.tensor(loss_scale, dtype=torch.float32
                                    ).to(device=g.device, dtype=g.dtype)
        views[n] = sm.state_view(n)
    # the global norm: each piece counted once over the mesh
    total = None
    for n, g in grads.items():
        s = sm.sq_norm(n, g)
        if s is not None:
            total = s if total is None else total + s
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=sm.device)
    if sm.mesh.size() > 1:
        total = shd.all_sum(total, sm.world_group)
    gnorm = torch.sqrt(total)
    scale = torch.clamp(tcfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    lr = warmup_cosine(opt_state.step, tcfg.learning_rate,
                       tcfg.warmup_steps, tcfg.steps)

    def loc(d):
        return None if d is None else {n: _local(t) for n, t in d.items()}

    local_state = AdamWState(opt_state.step, loc(opt_state.m),
                             loc(opt_state.v), loc(opt_state.master))
    new = adamw_update(views, grads, local_state, tcfg, lr)
    for n in params:
        lay = sm.layouts[n]
        if lay.dp_opt is not None and lay.dp_param is None and sm.dp > 1:
            with torch.no_grad():
                sm.rest(n).copy_(_gather(views[n], lay.dp_opt, sm.dp_group,
                                         sm.dp))
    opt_state = AdamWState(new.step, opt_state.m, opt_state.v,
                           opt_state.master)
    return sm, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}


def _check_grad_shardings(sm: ShardedModel, grad_shardings) -> None:
    """``grad_shardings`` must give every parameter the layout of its
    optimizer state on ``sm``'s mesh."""
    if set(grad_shardings) != set(sm.layouts):
        raise ValueError("grad_shardings names other parameters than the "
                         "model's: " + ", ".join(sorted(
                             set(grad_shardings) ^ set(sm.layouts))[:4]))
    for n, lay in sm.layouts.items():
        sh = grad_shardings[n]
        if sh.mesh is not sm.mesh or tuple(sh.spec) != tuple(lay.opt):
            raise ValueError(f"grad_shardings[{n!r}] is {tuple(sh.spec)}; "
                             f"the optimizer state of {n} is laid out as "
                             f"{tuple(lay.opt)} on the step's mesh")


# ----------------------------------------------------------------- steps
def make_loss_fn(cfg: ModelConfig):
    """(model, batch, loss_scale) -> (loss * loss_scale, (loss, metrics))."""
    api = get_api(cfg)

    def loss_fn(model: nn.Module, batch, loss_scale):
        loss, metrics = api.loss_fn(cfg, model, batch)
        return loss * loss_scale, (loss, metrics)

    return loss_fn


def _run(policy):
    return policy.run() if policy is not None else contextlib.nullcontext()


def _mark(on_mark, phase: str) -> None:
    if on_mark is not None:
        on_mark(phase)


def _backward(loss_fn, model, batch, loss_scale, policy=None,
              fill: bool = True, on_mark=None):
    """Scaled loss and its backward, under ``policy``; returns (loss,
    {name: param}, metrics) with each parameter's ``.grad`` filled (with
    ``fill``, zeros where the loss does not reach it) and the loss's parts
    (``xent``, ``aux``) detached.  ``on_mark``, if given, is called with
    ``"fwd"`` once the loss is launched and ``"bwd"`` once the backward
    is."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    with _run(policy):
        scaled, (loss, m) = loss_fn(model, batch, loss_scale)
        _mark(on_mark, "fwd")
        scaled.backward()
        _mark(on_mark, "bwd")
    for p in params.values():
        if fill and p.grad is None:
            p.grad = torch.zeros_like(p)
    return loss.detach(), params, {k: v.detach() for k, v in m.items()}


def make_grad_step(cfg: ModelConfig, tcfg: TrainConfig, policy=None,
                   on_parts: Optional[Callable[[Dict[str, torch.Tensor]],
                                               None]] = None,
                   on_mark: Optional[Callable[[str], None]] = None
                   ) -> Callable:
    """(model, batch, loss_scale) -> (loss, grads, finite): grads unscaled
    (f32) keyed by parameter name, ``finite`` a 0-d bool tensor.  The
    parameters' ``.grad`` are released.  ``on_parts``, if given, takes each
    call's loss parts (``xent``, ``aux``), detached.  ``on_mark``, if
    given, is called with the name of each phase as its work is launched:
    ``fwd`` (to the loss), ``bwd`` (the backward) and ``unscale`` (to the
    finiteness check)."""
    loss_fn = make_loss_fn(cfg)

    def grad_step(model: nn.Module, batch, loss_scale
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                             torch.Tensor]:
        loss, params, parts = _backward(loss_fn, model, batch, loss_scale,
                                        policy, on_mark=on_mark)
        if on_parts is not None:
            on_parts(parts)
        scale = torch.tensor(loss_scale, dtype=torch.float32)
        grads = {}
        for n, p in params.items():
            grads[n] = p.grad.float().div_(scale.to(p.device))
            p.grad = None
        finite = check_finite(grads)
        _mark(on_mark, "unscale")
        return loss, grads, finite

    return grad_step


def make_apply_step(cfg: ModelConfig, tcfg: TrainConfig,
                    on_mark: Optional[Callable[[str], None]] = None
                    ) -> Callable:
    """(model, opt_state, grads) -> (model, opt_state, metrics): clip by the
    global norm, the warmup-cosine lr at the state's step, AdamW in place.
    ``on_mark``, as ``make_grad_step``'s: ``clip`` and ``adamw_update``."""
    def apply_step(model: nn.Module, opt_state: AdamWState, grads):
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        _mark(on_mark, "clip")
        lr = warmup_cosine(opt_state.step, tcfg.learning_rate,
                           tcfg.warmup_steps, tcfg.steps)
        opt_state = adamw_update(model, grads, opt_state, tcfg, lr)
        _mark(on_mark, "adamw_update")
        return model, opt_state, {"grad_norm": gnorm, "lr": lr}

    return apply_step


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, policy=None,
                    grad_shardings=None) -> Callable:
    """The fused iteration: (model, opt_state, batch, loss_scale) ->
    (model, opt_state, {"loss", "grad_norm", "lr"}).  ``model`` may be a
    ``ShardedModel`` (with ``shard_model``'s state and this rank's
    ``shard_batch``); its gradients are reduce-scattered to the optimizer
    state's layout.  ``grad_shardings``, the reference's pin of the
    gradients to that layout, must then name it: a sharding per parameter
    whose spec is its ``ParamLayout.opt`` (else ValueError)."""
    loss_fn = make_loss_fn(cfg)

    def train_step(model: nn.Module, opt_state: AdamWState, batch,
                   loss_scale):
        if isinstance(model, ShardedModel):
            if grad_shardings is not None:
                _check_grad_shardings(model, grad_shardings)
            return _sharded_train_step(model, opt_state, batch, loss_scale,
                                       tcfg, policy)
        if grad_shardings is not None:
            raise TypeError("grad_shardings needs a ShardedModel")
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


def make_prefill_step(cfg: ModelConfig, policy=None) -> Callable:
    """(model, batch) -> logits of ``batch["tokens"]`` (and ``memory``)."""
    api = get_api(cfg)

    @torch.no_grad()
    def prefill_step(model, batch):
        c, m = cfg, model
        ctx = contextlib.nullcontext()
        if isinstance(model, ShardedModel):
            c, m, ctx = model.local_cfg, model.module, model.context()
        with ctx, _run(policy):
            logits, _ = api.forward(c, m, batch["tokens"],
                                    memory=batch.get("memory"))
        return _whole_logits(model, logits)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """(model, tokens (B,1), state) -> (logits, new state)."""
    api = get_api(cfg)

    @torch.no_grad()
    def decode_step(model, tokens, state):
        if isinstance(model, ShardedModel):
            with model.context():
                logits, state = api.decode_step(model.local_cfg, model.module,
                                                tokens, state)
            return _whole_logits(model, logits), state
        return api.decode_step(cfg, model, tokens, state)

    return decode_step


def _whole_logits(model, logits: torch.Tensor) -> torch.Tensor:
    """A ``ShardedModel``'s logits whole over the vocabulary (all-gathered
    over the model dim where its plan splits the vocabulary), so a sampler
    sees what the unsharded step gives."""
    if (not isinstance(model, ShardedModel) or "vocab" not in model.plan.blocks
            or model.plan.size == 1):
        return logits
    return _gather(logits, logits.dim() - 1, model.plan.group,
                   model.plan.size)
