"""Stage-1 head weights: how a ``Classify`` product finds its params.

The port of ``repro.serve.heads``.  A head descriptor in a
``ReadoutSpec`` is hashable and carries no tensors, only a ``weights``
key; this module resolves the key to a param tree (the nested dict of
``models.cnn.cnn_defs``) once per engine, on the engine's device.

Resolution order for ``Classify(weights=key)``:

  1. the in-process registry (``register_head_params``);
  2. a checkpoint directory (``checkpoint.Checkpointer``, the reference's
     layout): if ``key`` is a directory with saved steps, its latest step
     restores against the head's param template, shapes checked leaf by
     leaf.  Restores are cached by (absolute path, head geometry, step,
     device), never by the raw key: a relative key survives a ``chdir``,
     two geometries never share an entry, and a newly saved step is
     served at the next resolve;
  3. the ``"default"`` key initializes deterministically from
     ``prng.PRNGKey(zlib.crc32(head geometry))``, the reference's key:
     its key stream is the reference's bitwise and each weight is within
     ``prng.normal``'s few-ULP band of the reference's.

Any other key raises ``KeyError`` at resolution (the first read).
"""
from __future__ import annotations

import os
import zlib
from typing import Dict, Tuple

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models import cnn
from repro_torch.models import module as M

#: process-wide weights registry: key -> param tree
_REGISTRY: Dict[str, dict] = {}

#: checkpoint restore cache: (abspath, geometry, step, device) -> params
_CKPT_CACHE: Dict[Tuple[str, Tuple[int, int, int, int], int, str], dict] = {}


def register_head_params(key: str, params) -> None:
    """Publish a param tree under ``key`` for ``Classify(weights=key)``
    specs to resolve against (overwrites an earlier registration)."""
    _REGISTRY[key] = params


def clear_registry() -> None:
    """Drop every registered key and cached checkpoint restore."""
    _REGISTRY.clear()
    _CKPT_CACHE.clear()


def _head_geometry(head, cfg) -> Tuple[int, int, int, int]:
    """The tuple that determines a head's param shapes."""
    return (len(head.inputs), cfg.polarities, head.n_classes, head.width)


def head_param_defs(head, cfg) -> dict:
    """ParamDef tree of one ``Classify`` head under engine config ``cfg``:
    the CNN's input channels are the head's K stacked surface inputs times
    the engine's polarity planes (the ``ts_stack_frontend`` layout)."""
    return cnn.cnn_defs(len(head.inputs) * cfg.polarities, head.n_classes,
                        width=head.width)


def _checkpoint_params(head, cfg, directory: str, device: torch.device):
    """Latest-step restore from ``directory`` (which must exist), cached
    by (abspath, geometry, step, device); None when it holds no step."""
    ckpt = Checkpointer(directory)
    step = ckpt.latest_step()
    if step is None:
        return None
    key = (directory, _head_geometry(head, cfg), step, str(device))
    params = _CKPT_CACHE.get(key)
    if params is None:
        params, _ = ckpt.restore(head_param_defs(head, cfg), step=step,
                                 device=device)
        _CKPT_CACHE[key] = params
    return params


def resolve_head_params(head, cfg, device=None) -> dict:
    """Resolve one ``Classify`` head's weights key to a param tree on
    ``device`` (default: the CUDA device; raises when there is none); see
    the module docstring for the order."""
    device = resolve_device(device)
    params = _REGISTRY.get(head.weights)
    if params is not None:
        return M.unflatten({k: v.to(device)
                            for k, v in M.flatten(params).items()})
    path = os.path.abspath(head.weights)
    if os.path.isdir(path):
        params = _checkpoint_params(head, cfg, path, device)
        if params is not None:
            return params
    if head.weights == "default":
        seed = zlib.crc32(f"{len(head.inputs)}:{cfg.polarities}:"
                          f"{head.n_classes}:{head.width}".encode())
        return M.init_params(head_param_defs(head, cfg), prng.PRNGKey(seed),
                             device)
    raise KeyError(
        f"Classify weights key {head.weights!r} is neither registered "
        "(serve.heads.register_head_params) nor a checkpoint directory "
        "with saved steps"
    )
