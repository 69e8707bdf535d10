"""Sharding rules and the collectives that realize them: the LM's
parameters over a process mesh, and the time-surface engine's slot pool
over the shards of a host mesh.

The port of ``repro.distributed.sharding``.  **The model half**:
Megatron-style tensor parallelism over ``"model"``, data parallelism
over ``("pod", "data")`` and, with ``cfg.fsdp``, the parameters' embed
dim split over the data axes too (ZeRO-3).  A rule whose logical dim
does not divide its mesh axis replicates that dim instead (glm4's 2 KV
heads, hymba's 25 heads on a 16-way model axis), as in the reference.
``param_shardings`` gives each leaf's ``PartitionSpec`` as a tuple, one
entry a dim: None, a mesh axis, or a tuple of mesh axes, in the
reference's order.  ``Placement`` realizes one: ``shard_leaf`` keeps a
rank's block of a full leaf and ``gather_leaf`` gathers it back.  A dim
that does not divide its axes raises for that leaf (GSPMD would pad it);
the rules never ask for one.

**Decode caches** (serving over a mesh): ``cache_placements`` lays a
batch's caches out as the reference's ``dryrun.abstract_cache_specs``
does (flash-decoding: the batch over the data axes that divide it, the
sequence over ``cache_seq_axes``, every KV head on every rank, an SSM's
state over the batch axes); ``shard_caches`` keeps a rank's block of
whole caches and ``gather_caches`` gathers them back.

**The slot-pool half**: a host mesh is a list of devices with one ``"data"`` axis; the pool's slot
axis splits into contiguous blocks, one per shard, and every other axis
stays whole.  Where the reference hands ``shard_map`` a
``PartitionSpec``, the port hands the engine the ordered list of shard
devices (``slot_pool_devices``): shard ``k`` owns global slots
``[k * slots_per_shard, (k + 1) * slots_per_shard)`` and keeps its rows
in tensors of its own on ``slot_pool_devices(mesh)[k]``.

The rules read only ``mesh.shape``, so any object with the reference's
``{axis: size}`` dict stands in for a mesh there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.models import module as M


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data axes: the batch and the slot pool split over
    them."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


# ------------------------------------------------------------ the rules

def fsdp_axes(cfg, mesh):
    """ZeRO-3 shards params over every data axis (pod included)."""
    return data_axes(mesh) if cfg.fsdp else None


def logical_rules(cfg, mesh) -> Dict[str, object]:
    """Logical axis name -> mesh axis (or tuple of axes, or None)."""
    m = mesh.shape["model"]
    fsdp = fsdp_axes(cfg, mesh)
    rules: Dict[str, object] = {
        "vocab": "model",           # padded_vocab is always divisible
        "embed": fsdp,
        "mlp": "model" if cfg.d_ff % m == 0 else None,
        "heads": "model" if cfg.n_heads % m == 0 else None,
        "kv_heads": ("model" if cfg.n_kv_heads and cfg.n_kv_heads % m == 0
                     else None),
        "head_dim": None,
        "layers": None,
        "experts_router": None,
        "ssm_inner": None,          # refined below
        "expert_mlp": None,         # set by the MoE strategy
        "experts": None,
    }
    if cfg.n_experts:
        from repro_torch.models.moe import moe_strategy

        if moe_strategy(cfg, m) == "ep":
            rules["experts"], rules["expert_mlp"] = "model", None
        else:
            rules["experts"], rules["expert_mlp"] = None, "model"
    if cfg.family in ("ssm", "hybrid"):
        from repro_torch.models.ssm import ssm_dims

        di, h, p, n = ssm_dims(cfg)
        # the inner dim splits only on head boundaries, so the (h, p)
        # reshape keeps its sharding (hymba's 25 heads replicate)
        ok = di % m == 0 and h % m == 0
        rules["ssm_inner"] = "model" if ok else None
        rules["ssm_heads"] = "model" if ok else None
    return rules


def param_shardings(cfg, mesh):
    """Each parameter leaf's spec (a tuple with an entry per dim), the
    expert weights' from the MoE strategy."""
    from repro_torch.models import transformer as T

    specs = M.partition_specs(T.param_defs(cfg), logical_rules(cfg, mesh))
    if cfg.n_experts:
        from repro_torch.models.moe import expert_weight_specs

        up, down = expert_weight_specs(cfg, mesh.shape["model"],
                                       fsdp_axes(cfg, mesh))
        moe = specs["layers"]["moe"]
        moe["we_gate"] = moe["we_up"] = (None, *up)   # layers axis first
        moe["we_down"] = (None, *down)
    return specs


def spec_axes(spec) -> Tuple[str, ...]:
    """Flatten a spec's mesh-axis names (entries may be str/tuple)."""
    out = []
    for e in spec:
        if e is None:
            continue
        if isinstance(e, str):
            out.append(e)
        else:
            out.extend(e)
    return tuple(out)


def batch_spec(mesh, global_batch: int) -> tuple:
    """Shard the batch over as many data axes as divide it."""
    axes = []
    for a in data_axes(mesh):
        size = mesh.shape[a]
        if global_batch % size == 0 and size > 1:
            axes.append(a)
            global_batch //= size
    return (tuple(axes),) if axes else ()


def input_shardings(cfg, mesh, global_batch: int) -> tuple:
    """The spec of a (batch, seq) input."""
    return (*batch_spec(mesh, global_batch), None)


def cache_seq_axes(mesh, global_batch: int, seq_len: int):
    """Mesh axes for the KV-cache sequence dim at decode: the batch takes
    the data axes it divides; the remaining ones and ``"model"`` split
    the sequence (the flash-decoding layout)."""
    used = set(spec_axes(batch_spec(mesh, global_batch)))
    seq_axes = [a for a in (*data_axes(mesh), "model") if a not in used]
    ok = []
    prod = 1
    for a in seq_axes:
        if seq_len % (prod * mesh.shape[a]) == 0:
            ok.append(a)
            prod *= mesh.shape[a]
    return tuple(ok)


# ------------------------------------------- placements and collectives

def _entry(e) -> Tuple[str, ...]:
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one leaf lives on a ``distributed.mesh.ProcessMesh``: its full
    ``shape`` and its ``spec`` (per dim, the mesh axes that split it).
    A rank holds the block of each split dim at its row-major index over
    that dim's axes."""

    shape: Tuple[int, ...]
    spec: tuple
    mesh: Any = dataclasses.field(compare=False, repr=False)

    def __post_init__(self):
        for n, e in zip(self.shape, self.spec):
            k = self.mesh_count(e)
            if n % k:
                raise ValueError(
                    f"a dim of {n} does not split {k} ways over {e} (leaf "
                    f"{self.shape}, spec {self.spec}); GSPMD would pad it")

    def mesh_count(self, e) -> int:
        return math.prod(self.mesh.shape[a] for a in _entry(e))

    def axes(self, dims=None) -> Tuple[str, ...]:
        """The axes of size > 1 that split ``dims`` (default: every dim),
        in mesh order."""
        dims = range(len(self.shape)) if dims is None else dims
        return self.mesh.ordered(
            [a for d in dims for a in _entry(self.spec[d])])

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(n // self.mesh_count(e)
                     for n, e in zip(self.shape, self.spec))

    def block(self) -> Tuple[slice, ...]:
        """This rank's block of the full leaf."""
        out = []
        for n, e, k in zip(self.shape, self.spec, self.local_shape):
            i = self.mesh.index(_entry(e)) if e is not None else 0
            out.append(slice(i * k, (i + 1) * k))
        return tuple(out)

    def psum(self, x: torch.Tensor, dims=None, op=dist.ReduceOp.SUM
             ) -> torch.Tensor:
        """``x`` (a partial over this rank's block) reduced over the axes
        that split ``dims``; unchanged where none does."""
        group = self.mesh.group(self.axes(dims))
        if group is None:
            return x
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, op=op, group=group)
        return x


def placements(cfg, mesh):
    """Each parameter leaf's ``Placement`` on ``mesh``."""
    from repro_torch.models import transformer as T

    def walk(d, spec):
        if isinstance(d, dict):
            return {k: walk(d[k], spec[k]) for k in d}
        return Placement(d.shape, spec, mesh)

    return walk(T.param_defs(cfg), param_shardings(cfg, mesh))


def shard_leaf(x: torch.Tensor, pl: Placement) -> torch.Tensor:
    """This rank's block of the full leaf ``x`` (a copy)."""
    if tuple(x.shape) != tuple(pl.shape):
        raise ValueError(f"leaf {tuple(x.shape)} is not the placement's "
                         f"{pl.shape}")
    return x[pl.block()].clone()


def _gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0],) + xm.shape[1:])
    dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim) if dim else out


def _scatter_dim(g: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    gm = g.movedim(dim, 0).contiguous()
    out = gm.new_empty((gm.shape[0] // n,) + gm.shape[1:])
    dist.reduce_scatter_tensor(out, gm, group=group)
    return out.movedim(0, dim) if dim else out


class _Gather(torch.autograd.Function):
    """All-gather of one dim over a group.  Backward: the sum of the
    ranks' gradients, scattered (``partial``: each rank's gradient is a
    part of the whole, as over the data axes), or this rank's block of
    its own gradient (every rank holds the same whole gradient, as over
    the model axis of a block computed whole on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, index, partial):
        ctx.args = (dim, group, n, index, partial)
        return _gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n, index, partial = ctx.args
        if partial:
            g = _scatter_dim(g, dim, group, n)
        else:
            k = g.shape[dim] // n
            g = g.narrow(dim, index * k, k)
        return g, None, None, None, None, None


def gather_leaf(x: torch.Tensor, pl: Placement, axes=None) -> torch.Tensor:
    """The leaf gathered from this rank's block ``x`` over ``axes``
    (default: every axis that splits it), differentiably.  The data axes'
    gradients are partial (each rank's batch) and reduce-scatter back;
    any other axis's gradient is the same on every rank, and each keeps
    its block."""
    mesh = pl.mesh
    want = set(pl.axes() if axes is None else mesh.ordered(axes))
    datas = set(data_axes(mesh))
    for dim, e in enumerate(pl.spec):
        names = mesh.ordered(_entry(e))
        if names and set(names) <= want:
            x = _Gather.apply(x, dim, mesh.group(names), mesh.count(names),
                              mesh.index(names), set(names) <= datas)
    return x


def gather_full(x: torch.Tensor, pl: Placement) -> torch.Tensor:
    """The whole leaf from this rank's block, outside autograd."""
    with torch.no_grad():
        for dim, e in enumerate(pl.spec):
            names = pl.mesh.ordered(_entry(e))
            if names:
                x = _gather_dim(x, dim, pl.mesh.group(names),
                                pl.mesh.count(names))
    return x


class _Enter(torch.autograd.Function):
    """Megatron's f: the identity forward; backward, the sum over the
    group of the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Leave(torch.autograd.Function):
    """Megatron's g: the sum over the group forward; the identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(x: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """``x``, replicated over ``axes``, entering a region that splits its
    work over them: its gradient is summed over their ranks."""
    group = mesh.group(axes)
    return x if group is None else _Enter.apply(x, group)


def leave(x: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """The sum over ``axes`` of the ranks' partial ``x`` (the end of a
    row-parallel product), whose gradient passes to every rank whole."""
    group = mesh.group(axes)
    return x if group is None else _Leave.apply(x, group)


@torch.no_grad()
def reduce_data(g: torch.Tensor, pl: Placement, axes,
                scatter: bool = False) -> torch.Tensor:
    """A gradient of the leaf that ``pl`` places, summed over the data
    ranks ``axes``: whole on every rank (in float32) where no data axis
    splits the leaf; with ``scatter``, ``g`` is the gathered leaf's and
    is reduce-scattered back to this rank's block; else ``g`` is the
    block's, which ``gather_leaf``'s backward has already summed."""
    mesh = pl.mesh
    datas = set(mesh.ordered(axes))
    split = [d for d, e in enumerate(pl.spec)
             if set(mesh.ordered(_entry(e))) & datas]
    if not split:
        return all_reduce_(g.to(torch.float32), mesh, axes)
    if not scatter:
        return g
    (d,) = split
    names = mesh.ordered(_entry(pl.spec[d]))
    return _scatter_dim(g, d, mesh.group(names), mesh.count(names))


def all_reduce_(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """``x`` summed (or ``op``) over ``axes`` in place, outside
    autograd."""
    group = mesh.group(axes)
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def all_gather_dim(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The ranks' ``x`` over ``axes`` joined along ``dim`` in their
    row-major order, outside autograd; ``x`` where the axes span one
    rank."""
    group = mesh.group(axes)
    if group is None:
        return x
    return _gather_dim(x, dim % x.dim(), group, mesh.count(axes))


# ------------------------------------------------------- decode caches

def kv_spec(mesh, batch: int, seq_len: int, ndim: int) -> tuple:
    """The flash-decoding spec of a (B, S, ...) cache leaf of ``ndim``
    dims: the batch over ``batch_spec``, the sequence over
    ``cache_seq_axes`` (None where that gives ``()``), the rest whole."""
    bspec = batch_spec(mesh, batch)
    seq = cache_seq_axes(mesh, batch, seq_len) or None
    return (bspec[0] if bspec else None, seq) + (None,) * (ndim - 2)


def cache_placements(cfg, mesh, batch: int, max_len: int,
                     stacked: bool = False):
    """Each decode cache leaf's ``Placement`` on ``mesh`` for ``batch``
    requests of ``max_len`` positions: the flash-decoding layout of the
    reference's ``dryrun.abstract_cache_specs``.  K/V, int8 codes and
    scales (B, S, K, .) and ``pos`` (B, S) put the batch over
    ``batch_spec(mesh, batch)`` and the sequence over
    ``cache_seq_axes(mesh, batch, S)``, taken per layer (a local ring
    and a global cache differ in length), whole where that gives ``()``;
    every KV head is on every rank.  An SSM's conv rings and state split
    over the batch axes only.  A list of per-layer trees, or with
    ``stacked`` one tree whose leaves lead with the layers dim (whole),
    as ``transformer.stack_caches`` lays uniform caches out."""
    from repro_torch.models import transformer as T

    caches = T.abstract_decode_caches(cfg, batch, max_len)
    if stacked:
        if not T.uniform_layers(cfg):
            raise ValueError(f"{cfg.name}: stacked caches need every "
                             "layer's cache in one shape (uniform layers)")
        caches = T.stack_caches(caches)
    bspec = batch_spec(mesh, batch)
    lead = 1 if stacked else 0
    out = {}
    for path, x in M.flatten(caches).items():
        if "ssm" in path.split("."):
            spec = (bspec[0] if bspec else None,) + (None,) * (
                x.dim() - lead - 1)
        else:
            spec = kv_spec(mesh, batch, x.shape[lead + 1], x.dim() - lead)
        out[path] = Placement(tuple(x.shape), (None,) * lead + spec, mesh)
    return M.unflatten_like(caches, out)


def shard_caches(caches, pls):
    """This rank's block of each leaf of the whole caches ``caches`` (a
    copy)."""
    flat = M.flatten(pls)
    return M.unflatten_like(caches, {k: shard_leaf(x, flat[k]) for k, x in
                                     M.flatten(caches).items()})


def gather_caches(caches, pls):
    """The whole caches from this rank's blocks, outside autograd."""
    flat = M.flatten(pls)
    return M.unflatten_like(caches, {k: gather_full(x, flat[k]) for k, x in
                                     M.flatten(caches).items()})


def local_block(x: torch.Tensor, pl: Placement, rows_dim: int = 0
                ) -> torch.Tensor:
    """This rank's block of ``x``, whose ``rows_dim`` already holds this
    rank's rows of the batch and whose other dims are whole: every dim
    but that one cut to the rank's block (a copy)."""
    block = list(pl.block())
    block[rows_dim] = slice(None)
    return x[tuple(block)].clone()


def slot_shard_count(mesh) -> int:
    """How many ways the engine's slot pool splits: the product of the
    mesh's data axes."""
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return max(n, 1)


def pad_pool(n_slots: int, mesh) -> int:
    """Smallest pool size >= ``n_slots`` divisible by the shard count.

    A pool that does not divide is padded: the engine never hands out
    the dead tail slots, and they read as never-written.  Elastic pools
    grow and shrink in buckets padded by this same rule, so every
    capacity splits evenly.
    """
    n = slot_shard_count(mesh)
    return -(-n_slots // n) * n


def shard_of(slot: int, slots_per_shard: int) -> int:
    """The shard owning a global slot index (contiguous blocks).  The
    multi-shard EDF scheduler budgets per shard with this."""
    return slot // slots_per_shard


def slot_pool_devices(mesh) -> List[torch.device]:
    """The device of each shard of the slot pool, in shard order: the
    counterpart of the reference's ``slot_pool_sharding`` /
    ``slot_pool_spec`` / ``slot_pool_out_specs``.  Every leaf of the
    engine state and every pool-level product splits the same way, so
    one list places all of them."""
    devices = [torch.device(d) for d in mesh.devices]
    if len(devices) != slot_shard_count(mesh):
        raise ValueError(f"mesh lists {len(devices)} devices for "
                         f"{slot_shard_count(mesh)} shards")
    return devices
