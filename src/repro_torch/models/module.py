"""Minimal parameter system: a nested dict of ``ParamDef``s per model.

The port of ``repro.models.module``.  A model is described by a nested
dict of ``ParamDef``s -- shape, logical axis names, initializer -- from
which ``init_params`` materializes a nested dict of tensors with the same
keys, so a parameter's leaf path (``layers.ssm.z_proj``) is the
reference's.  ``partition_specs`` maps each leaf's logical axes to mesh
axes through a rules dict (``distributed.sharding.logical_rules``).
``abstract_params`` gives the leaves as empty ``meta`` tensors (each
whole, or a rank's block of it), the dry run's stand-ins.

``init_params`` draws from a ``core.prng`` key as the reference draws
from a ``jax.random`` key: one ``split`` per leaf in jax's leaf order,
then ``normal`` per leaf.  Keys and bits are bitwise the reference's on
any device, and each weight within ``prng.normal``'s few-ULP band.
Given each leaf's block (``blocks``, a rank's part of a sharded leaf),
only the block's counters are drawn: the same bits, at the block's
memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device

#: flat elements drawn at once: a leaf is drawn in slices of this many,
#: so the int64 threefry temporaries stay ~1 GB whatever the leaf's size
_DRAW_SLICE = 1 << 24


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]        # logical axis name per dim
    init: str = "normal"                   # normal | zeros | ones | embed
    scale: float = 1.0                     # stddev multiplier / fan-in override
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def _initialize(key: torch.Tensor, d: ParamDef, device,
                block: Optional[Tuple[slice, ...]] = None) -> torch.Tensor:
    """The leaf ``d`` drawn from ``key``, or only its ``block`` (a slice
    a dim) with the bits the whole leaf has there."""
    block = block or tuple(slice(0, n) for n in d.shape)
    shape = tuple(s.stop - s.start for s in block)
    if d.init == "zeros":
        return torch.zeros(shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(shape, dtype=d.dtype, device=device)
    if d.init == "embed":
        std = d.scale
    elif d.init == "normal":
        # fan-in scaled init; last-but-one dim = fan_in
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(d.init)
    # prng.normal(key, shape) * std, drawn slice by slice: each element's
    # normal depends only on its flat index in the whole leaf
    out = torch.empty(shape, dtype=d.dtype, device=device).view(-1)
    whole = tuple(shape) == tuple(d.shape)
    for lo in range(0, out.numel(), _DRAW_SLICE):
        idx = torch.arange(lo, min(lo + _DRAW_SLICE, out.numel()),
                           dtype=torch.int64, device=device)
        if not whole:
            idx = _block_flat(idx, block, shape, d.shape)
        out[lo:lo + idx.numel()] = prng.normal_at(key, idx) * std
    return out.view(shape)


def _block_flat(pos: torch.Tensor, block, shape, full) -> torch.Tensor:
    """Flat indices in the whole leaf (``full``) of the block's elements
    at row-major positions ``pos`` of the block (``shape``)."""
    flat = torch.zeros_like(pos)
    stride = 1
    for s, n, f in reversed(list(zip(block, shape, full))):
        flat += (pos % n + s.start) * stride
        pos = pos // n
        stride *= f
    return flat


def _children(tree):
    """A node's (key, child) pairs in JAX's flattening order -- a dict's
    keys sorted, a tuple's or list's indices in order -- or None for a
    leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if type(tree) in (tuple, list):
        return list(enumerate(tree))
    return None


def flatten(tree, sep: str = ".", prefix: str = "") -> Dict[str, Any]:
    """``{leaf path: leaf}`` of a tree of dicts, tuples and lists, paths
    joined with ``sep``: dict keys sorted at every level (the order
    ``init_params`` draws in, and JAX's flattening order of a dict), a
    tuple's or list's entries by index, as JAX names them (``0/embed``)."""
    out: Dict[str, Any] = {}
    for k, v in _children(tree):
        path = f"{prefix}{k}"
        if _children(v) is not None:
            out.update(flatten(v, sep, path + sep))
        else:
            out[path] = v
    return out


def unflatten(flat, sep: str = ".") -> dict:
    """The nested dict of ``{leaf path: leaf}`` (inverse of ``flatten`` on
    a tree of dicts; ``unflatten_like`` rebuilds tuples and lists)."""
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split(sep)
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def unflatten_like(template, flat, sep: str = ".", prefix: str = ""):
    """The tree of ``template``'s structure whose leaf at each path is
    ``flat[path]`` (inverse of ``flatten`` on any tree)."""
    kids = _children(template)
    if kids is None:
        return flat[prefix[:-len(sep)]]
    out = {k: unflatten_like(v, flat, sep, f"{prefix}{k}{sep}")
           for k, v in kids}
    if isinstance(template, dict):
        return {k: out[k] for k in template}
    return type(template)(out[i] for i in range(len(template)))


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def init_params(defs, key: torch.Tensor, device=None, blocks=None):
    """Materialize a nested dict of ``ParamDef`` into tensors on ``device``
    (default: the CUDA device; raises when there is none): ``key`` (a
    ``prng.PRNGKey``) is split once per leaf in sorted path order, as the
    reference's ``init_params(defs, key)`` splits it, and each leaf is
    drawn on ``device`` from its own key.  ``blocks``, ``{leaf path:
    per-dim slices}``, draws only those leaves' blocks."""
    device = resolve_device(device)
    flat = flatten(defs)
    bl = blocks or {}
    keys = prng.split(key.to(device), len(flat))
    return unflatten({path: _initialize(k, d, device, bl.get(path))
                      for k, (path, d) in zip(keys, flat.items())})


def abstract_params(defs, placements=None):
    """Each leaf of ``defs`` as an empty tensor of its dtype on the
    ``meta`` device, nothing allocated: whole, or with ``placements`` (a
    tree like ``defs`` of ``distributed.sharding.Placement``) this rank's
    block of it (``local_shape``)."""
    pls = flatten(placements) if placements is not None else {}
    return unflatten({
        path: torch.empty(pls[path].local_shape if path in pls else d.shape,
                          dtype=d.dtype, device="meta")
        for path, d in flatten(defs).items()})


def partition_specs(defs, rules: Dict[str, Any]):
    """Each leaf's spec: per dim, the rule of its logical axis (None: the
    dim is replicated; a mesh axis name or a tuple of them).  Unknown
    logical names replicate."""
    return _map(lambda d: tuple(rules.get(a) if a is not None else None
                                for a in d.axes), defs)


def stack_layer_defs(defs, n_layers: int):
    """Prepend a 'layers' dim to every ParamDef in a subtree."""
    return _map(lambda d: dataclasses.replace(
        d, shape=(n_layers,) + d.shape, axes=("layers",) + d.axes), defs)


def count_params(defs) -> int:
    return sum(math.prod(d.shape) for d in flatten(defs).values())


def cast_floating(tree, dtype):
    """Cast floating leaves of a nested dict of tensors to ``dtype``."""
    return _map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)
