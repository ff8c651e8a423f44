"""Logical-axis sharding rules (MaxText-style) on a ``DeviceMesh``.

Port of ``repro/distributed/sharding.py``.  Models annotate activations and
parameters with *logical* axis names; a rules table maps each name to mesh
dims.  Outside a mesh every helper is a no-op, so the same model code runs
on one device, under the Chameleon runtime and in the dry run unchanged.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims.
Where the reference speaks of a ``PartitionSpec`` (one entry per tensor
dim: None, a mesh dim, or a tuple of mesh dims) the port keeps the same
tuple (``partition_spec``); ``spec`` gives the DTensor placements it means,
one per mesh dim (``Shard(d)`` or ``Replicate()``), and ``sharding`` pairs
them with the mesh (``NamedSharding``).  Several mesh dims sharding one
tensor dim must come in the mesh's order (pod before data), as DTensor
splits them.

The reference's ``shard_map`` helper becomes explicit local compute on the
mesh's process groups.  ``local_tp`` installs a ``TpPlan``: the blocks whose
parameters a rank holds only its slice of along the ``model`` dim.  Model
code marks each such block with ``tp_enter`` (identity forward, a sum over
the model group backward) on its inputs and ``tp_exit`` (a sum over the
model group forward, identity backward) on its partial output, Megatron's
pair; both are no-ops for a block the plan does not hold.  Attention
splits by query heads (``head_runs``: a contiguous run a rank, the longer
runs on the lower ranks, none where the model dim exceeds the heads).
Where the model dim does not divide the KV heads, ``kv_slice`` picks the KV
heads of the rank's query heads out of the whole projections; where it
does not divide the query heads, ``q_slice`` picks the rank's heads out of
the whole query and output projections.  The vocabulary
(``vocab``: the embedding's rows, the unembedding's columns and the loss)
and the Mamba-2 heads (``ssm``) are blocks of the plan too; their code
reads the rank's share with ``tp_group`` / ``tp_rank`` / ``tp_size``, and
``tp_sum`` (a sum over the model group both ways) joins a reduction over a
split dim, such as Mamba-2's gated norm over all of ``d_inner``, and
``tp_gather`` (an all-gather forward, a reduce-scatter backward) makes
whole what each rank holds a slice of, such as Mamba-2's B and C channels
after their convolution (``ssm_bc``).  So attention, the executor's
saved-tensor hooks and the recorder see plain local tensors.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, FrozenSet, NamedTuple, Optional, Sequence, Tuple

import torch

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicate)
DEFAULT_RULES = {
    "batch": ("pod", "data"),       # DP across pods and the data axis
    "seq": None,
    "act_embed": None,
    "act_heads": "model",           # activation head dim (TP)
    "act_kv_heads": None,           # GQA: few kv heads -> replicated
    "act_mlp": "model",
    "act_vocab": "model",
    "kv_seq": "model",              # decode-time sequence parallelism over KV
    # --- parameters ---
    "embed": None,                  # param d_model dim
    "fsdp_embed": ("pod", "data"),  # ZeRO-3/FSDP shard dim for big params
    "heads": "model",
    "kv_heads": None,
    "q_dim": "model",               # fused num_heads*head_dim
    "kv_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",             # expert parallelism
    "expert_mlp": None,
    "layers": None,                 # stacked scan dim
    "conv": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "pos": None,
    "scalar": None,
}

# Swap frees the memory that forced tensor parallelism, so the whole mesh
# becomes a DP domain (paper Table 2's TP->DP substitution): parameters and
# optimizer state shard over every axis (ZeRO-3 through the rules),
# activations shard on batch only.
DP_ONLY_RULES = {
    "batch": ("pod", "data", "model"),
    "embed": ("pod", "data", "model"),
    "fsdp_embed": ("pod", "data", "model"),
    "heads": None, "q_dim": None, "kv_dim": None, "mlp": None,
    "vocab": None, "experts": None, "expert_mlp": None,
    "ssm_inner": None, "ssm_heads": None,
    "act_heads": None, "act_mlp": None, "act_vocab": None, "kv_seq": None,
}


class HeadRun(NamedTuple):
    """One model rank's share of the attention: its query heads ``first``
    .. ``first + count - 1`` and the KV heads they read, in the order its
    local KV heads take (``head_runs``)."""
    first: int
    count: int
    kv: Tuple[int, ...]


class TpPlan(NamedTuple):
    """The model dim as local compute: its process group and the blocks
    (``attn``, ``mlp``, ``moe``, ``vocab``, ``ssm``, and ``ssm_bc`` where
    Mamba-2's B / C channels split too) whose weights each rank holds a
    slice of.  ``heads`` (every model rank's ``HeadRun``) is set when the
    attention does not split as the plain slices of its weights, and then
    ``kv`` is this rank's KV heads when the model dim does not divide the
    KV heads (every rank holds the KV projections whole and computes only
    those, ``kv_slice``), ``q`` this rank's (first query head, count) when
    it does not divide the query heads (the query and output projections
    are gathered whole at use and narrowed, ``q_slice``).  ``kv_seq`` (the
    whole model's KV heads) is set when the decode cache splits its
    positions over the model dim, every rank holding all KV heads of its
    positions (``models.attention``)."""
    group: object
    size: int
    rank: int
    blocks: FrozenSet[str]
    kv: Optional[Tuple[int, ...]] = None
    kv_seq: Optional[int] = None
    q: Optional[Tuple[int, int]] = None
    heads: Optional[Tuple[HeadRun, ...]] = None


def head_runs(num_heads: int, num_kv_heads: int, tp: int
              ) -> Tuple[HeadRun, ...]:
    """Every model rank's run of query heads: ``num_heads // tp`` or one
    more, the longer runs on the lower ranks (so rank 0 carries the most),
    0 where ``tp`` exceeds the heads; the reference's padded split puts at
    most as many on a chip.  A run's KV heads are those its query heads
    read, each once where the local grouping the kernels use (local query
    head i reads local KV head i // (count / KV heads)) picks them, else
    one per query head (a KV head repeated)."""
    base, extra = divmod(num_heads, tp)
    group = num_heads // num_kv_heads
    out, first = [], 0
    for r in range(tp):
        n = base + (r < extra)
        reads = [h // group for h in range(first, first + n)]
        kv = sorted(set(reads))
        if not kv or n % len(kv) or any(
                reads[i] != kv[i // (n // len(kv))] for i in range(n)):
            kv = reads
        out.append(HeadRun(first, n, tuple(kv)))
        first += n
    return tuple(out)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict = dict(DEFAULT_RULES)
        self.tp: Optional[TpPlan] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Install mesh + logical rules for the sharding annotations.  Nested
    calls inherit the enclosing context's rules (so a dp_only outer context
    composes with the ZeRO overrides applied inside spec-building
    helpers)."""
    prev = (_CTX.mesh, _CTX.rules)
    base = _CTX.rules if _CTX.mesh is not None else DEFAULT_RULES
    _CTX.mesh = mesh
    merged = dict(base)
    if rules:
        merged.update(rules)
    _CTX.rules = merged
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def current_rules() -> dict:
    return dict(_CTX.rules)


def mesh_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def mesh_shape(mesh) -> Dict[str, int]:
    """{dim name: size}, the reference's ``mesh.shape``."""
    return dict(zip(mesh_names(mesh), mesh.mesh.shape))


def _resolve(name: Optional[str], mesh):
    if name is None:
        return None
    ax = _CTX.rules.get(name, None)
    if ax is None:
        return None
    names = mesh_names(mesh)
    if isinstance(ax, tuple):
        present = tuple(a for a in ax if a in names)
        return present if present else None
    return ax if ax in names else None


def resolve_axes(name: str, mesh) -> Tuple[str, ...]:
    """The mesh dims logical axis ``name`` maps to, as a tuple."""
    ax = _resolve(name, mesh)
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def partition_spec(logical: Sequence[Optional[str]], mesh=None) -> tuple:
    """The reference's ``spec``: one entry per tensor dim; ``()`` with no
    mesh."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return ()
    return tuple(_resolve(n, mesh) for n in logical)


def to_placements(pspec: tuple, mesh) -> list:
    """DTensor placements (one per mesh dim) of a partition spec."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(pspec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"mesh dims {axes} shard tensor dim {d} out of "
                             f"the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh dim {names[i]} shards two tensor "
                                 f"dims in {pspec}")
            out[i] = Shard(d)
    return out


def spec(logical: Sequence[Optional[str]]) -> list:
    """DTensor placements of a tensor with these logical axes on the
    active mesh; ``[]`` with no mesh."""
    mesh = _CTX.mesh
    if mesh is None:
        return []
    return to_placements(partition_spec(logical, mesh), mesh)


class NamedSharding(NamedTuple):
    """A mesh and a partition spec (the reference's ``NamedSharding``)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)


def sharding(logical: Sequence[Optional[str]]) -> Optional[NamedSharding]:
    mesh = _CTX.mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, partition_spec(logical, mesh))


def constrain(x, logical: Sequence[Optional[str]]):
    """Re-lay a DTensor to the logical axes on the active mesh.  A no-op
    with no mesh, and on a plain (local) tensor: local compute keeps its
    own layout (``local_tp``)."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = to_placements(partition_spec(logical, mesh), mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _tree_map(fn, tree):
    if _is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[None if v is None else _tree_map(fn, v)
                            for v in tree])
    raise TypeError(f"not an axes tree: {tree!r}")


def tree_sharding(axes_tree, mesh=None):
    """Map a tree (dicts / NamedTuples) of logical-axis tuples to
    ``NamedSharding``s."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return None
    return _tree_map(
        lambda axes: NamedSharding(mesh, partition_spec(axes, mesh)),
        axes_tree)


def tree_spec(axes_tree, mesh=None):
    """Map a tree of logical-axis tuples to partition specs (``()`` for
    every leaf with no mesh)."""
    mesh = mesh if mesh is not None else _CTX.mesh
    return _tree_map(
        lambda axes: () if mesh is None else partition_spec(axes, mesh),
        axes_tree)


# ------------------------------------------------------ process groups
_GROUPS: Dict[tuple, object] = {}


def group_of(mesh, dims: Sequence[str]):
    """The process group over mesh dims ``dims`` (in the mesh's order) that
    holds this rank, or None when ``dims`` is empty.  One dim is the mesh's
    own group; several are built once (every rank builds every slice, as
    ``new_group`` asks)."""
    import torch.distributed as dist
    names = mesh_names(mesh)
    dims = tuple(sorted(dims, key=names.index))
    if not dims:
        return None
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    key = (id(mesh), dims)
    if key not in _GROUPS or _GROUPS[key][0] is not mesh:
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():    # rank arithmetic, not traced
            ranks = mesh.mesh
            keep = [names.index(d) for d in dims]
            other = [i for i in range(len(names)) if i not in keep]
            n = 1
            for i in keep:
                n *= ranks.shape[i]
            rows = ranks.permute(*other, *keep).reshape(-1, n).tolist()
        me = dist.get_rank()
        mine = None
        for row in rows:
            g = dist.new_group(row)
            if me in row:
                mine = g
        _GROUPS[key] = (mesh, mine)
    return _GROUPS[key][1]


def clear_groups() -> None:
    """Forget the groups ``group_of`` built (their process group is
    gone)."""
    _GROUPS.clear()


def coordinate(mesh, dims: Sequence[str]) -> Tuple[int, int]:
    """(this rank's index, count) along mesh dims ``dims`` taken together,
    the first dim outermost."""
    names = mesh_names(mesh)
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for d in sorted(dims, key=names.index):
        size = mesh.mesh.shape[names.index(d)]
        idx = idx * size + coord[names.index(d)]
        n *= size
    return idx, n


def local_chunk(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's piece of a full tensor under DTensor ``placements``
    (``torch.chunk`` splits, mesh dims in order)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    out = full
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.mesh.shape[i]
            out = out.tensor_split(n, dim=pl.dim)[coord[i]]
    return out


# ------------------------------------------------------- local TP pairs
@contextlib.contextmanager
def local_tp(plan: Optional[TpPlan]):
    """Install ``plan`` for the model code's ``tp_enter`` / ``tp_exit``."""
    prev = _CTX.tp
    _CTX.tp = plan
    try:
        yield
    finally:
        _CTX.tp = prev


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor; no autograd)."""
    import torch.distributed as dist
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.group), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; backward, the sum over ``group`` of the ranks'
    partial gradients (Megatron's ``f``).  No-op for ``group`` None."""
    return x if group is None else _Enter.apply(x, group)


def exit(x: torch.Tensor, group) -> torch.Tensor:  # noqa: A001
    """The sum over ``group`` forward, identity backward (Megatron's
    ``g``).  No-op for ``group`` None."""
    return x if group is None else _Exit.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim``, in rank
    order (no autograd)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if n == 1:
        return x
    y = x.detach().movedim(dim, 0).contiguous()
    out = torch.empty((n * y.shape[0],) + tuple(y.shape[1:]),
                      dtype=y.dtype, device=y.device)
    dist.all_gather_into_tensor(out, y, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, this rank's piece of it along
    ``dim`` (rank order; no autograd)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if n == 1:
        return x
    y = x.detach().movedim(dim, 0).contiguous()
    out = torch.empty((y.shape[0] // n,) + tuple(y.shape[1:]),
                      dtype=y.dtype, device=y.device)
    dist.reduce_scatter_tensor(out, y, group=group)
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.group), None


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group`` (a new tensor; no
    autograd)."""
    import torch.distributed as dist
    x = x.detach().contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group`` (no autograd)."""
    import torch.distributed as dist
    return all_sum(x, group) / dist.get_world_size(group)


def _plan_group(block: str):
    plan = _CTX.tp
    if plan is None or block not in plan.blocks or plan.size == 1:
        return None
    return plan.group


def current_tp() -> Optional[TpPlan]:
    """The installed plan, or None."""
    return _CTX.tp


def tp_group(block: str):
    """The model group when the installed plan splits ``block`` over more
    than one rank, else None."""
    return _plan_group(block)


def tp_size(block: str) -> int:
    """Ranks ``block`` is split over (1 when the plan does not split it)."""
    return 1 if _plan_group(block) is None else _CTX.tp.size


def tp_rank(block: str) -> int:
    """This rank's index among the ranks ``block`` is split over."""
    return 0 if _plan_group(block) is None else _CTX.tp.rank


def tp_sum(x: torch.Tensor, block: str) -> torch.Tensor:
    """The sum over the model group of each rank's partial ``x``, both
    ways: a reduction over a dim the plan splits (forward) whose result
    each rank's own share then uses (backward: the partial gradients
    summed).  ``x`` unchanged for a block the plan does not split."""
    group = _plan_group(block)
    return x if group is None else _Sum.apply(x, group)


def tp_enter(x: torch.Tensor, block: str) -> torch.Tensor:
    """The input of a model-parallel block of the installed plan."""
    return enter(x, _plan_group(block))


def kv_slice(w: torch.Tensor, head_dim: int) -> torch.Tensor:
    """The columns of a whole KV projection (or bias) that this rank's
    query heads read (``TpPlan.kv``, in order), under a plan with ``kv``
    set; ``w`` otherwise.  Its gradient is then partial on each rank and is
    summed over the model group (``ParamLayout.tp_sum``)."""
    plan = _CTX.tp
    if plan is None or plan.kv is None:
        return w
    heads = plan.kv
    first = heads[0] if heads else 0
    if heads == tuple(range(first, first + len(heads))):
        return w.narrow(-1, first * head_dim, len(heads) * head_dim)
    return torch.cat([w.narrow(-1, h * head_dim, head_dim) for h in heads],
                     -1)


def q_slice(w: torch.Tensor, head_dim: int, dim: int = -1) -> torch.Tensor:
    """This rank's query heads' part (along ``dim``) of a query projection,
    its bias or the output projection gathered whole at use, under a plan
    with ``q`` set; ``w`` otherwise.  Its gradient is then whole-shaped and
    partial on each rank, and is reduce-scattered over the model group to
    the rank's piece at rest (``ParamLayout.tp_sum`` with ``gather_tp``)."""
    plan = _CTX.tp
    if plan is None or plan.q is None:
        return w
    first, n = plan.q
    return w.narrow(dim, first * head_dim, n * head_dim)


def tp_gather(x: torch.Tensor, dim: int, block: str) -> torch.Tensor:
    """Every rank's ``x`` of the model group concatenated along ``dim`` (a
    contiguous tensor), where the installed plan splits ``block``; the
    backward reduce-scatters the ranks' partial gradients to each one's
    piece.  ``x`` unchanged for a block the plan does not split."""
    group = _plan_group(block)
    return x if group is None else _Gather.apply(x, dim % x.dim(), group)


def tp_exit(x: torch.Tensor, block: str) -> torch.Tensor:
    """The partial output of a model-parallel block of the installed plan,
    summed over the model group."""
    return exit(x, _plan_group(block))
