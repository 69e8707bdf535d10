"""Minimal parameter system: a nested dict of ``ParamDef``s per model.

The port of ``repro.models.module``.  A model is described by a nested
dict of ``ParamDef``s -- shape, logical axis names, initializer -- from
which ``init_params`` materializes a nested dict of tensors with the same
keys, so a parameter's leaf path (``layers.ssm.z_proj``) is the
reference's.  The reference's mesh-only ``partition_specs`` and dry-run
``abstract_params`` are not ported.

``init_params`` draws from an explicit ``torch.Generator``.  Its numbers
are not ``jax.random``'s: to compare with the reference, carry the
reference's weights across with ``repro_torch.convert``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device


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


def _initialize(gen: torch.Generator, d: ParamDef, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "embed":
        std = d.scale
    elif d.init == "normal":
        # fan-in scaled init; last-but-one dim = fan_in
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(d.init)
    x = torch.randn(d.shape, generator=gen, device=gen.device)
    return x.mul_(std).to(device=device, dtype=d.dtype)


def flatten(tree, sep: str = ".", prefix: str = "") -> Dict[str, Any]:
    """``{leaf path: leaf}`` of a nested dict, paths joined with ``sep``
    and keys sorted at every level (the order ``init_params`` draws in,
    and JAX's flattening order of a dict)."""
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, sep, path + sep))
        else:
            out[path] = v
    return out


def unflatten(flat, sep: str = ".") -> dict:
    """The nested dict of ``{leaf path: leaf}`` (inverse of ``flatten``)."""
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split(sep)
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def init_params(defs, generator: torch.Generator, device=None):
    """Materialize a nested dict of ``ParamDef`` into tensors on ``device``
    (default: the CUDA device; raises when there is none), drawing the
    leaves in sorted path order from ``generator`` on its own device."""
    device = resolve_device(device)
    return unflatten({path: _initialize(generator, d, device)
                      for path, d in flatten(defs).items()})


def stack_layer_defs(defs, n_layers: int):
    """Prepend a 'layers' dim to every ParamDef in a subtree."""
    return _map(lambda d: dataclasses.replace(
        d, shape=(n_layers,) + d.shape, axes=("layers",) + d.axes), defs)


def count_params(defs) -> int:
    return sum(math.prod(d.shape) for d in flatten(defs).values())


def cast_floating(tree, dtype):
    """Cast floating leaves of a nested dict of tensors to ``dtype``."""
    return _map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)
