"""Carry state between the JAX package and the port, as numpy arrays.

Every structure crosses as ``{leaf path: numpy array}``, paths joined
with ``.``, and maps one to one onto the port's tensors and back:

  * the time-surface engine's ``EngineState`` (``LEAVES``; the slot
    generations, which key the analog noise draws, included);
  * an ``ISCArray``'s ``ISCState`` (``sae``, ``droop``, ``params.<name>``
    as planes or 0-d scalars);
  * an LM's parameters (``embed``, ``layers.ln1``, ``layers.ssm.<name>``
    stacked on a leading layer dim, ``ln_f``, ``unembed``);
  * an LM's decode caches, one dict per layer (``ssm.conv.x``,
    ``ssm.conv.b``, ``ssm.conv.c``, ``ssm.state``);
  * a ``Classify`` head's CNN parameters, whose paths are joined with
    ``/`` instead (``inc1/b3a/w``), as a checkpoint names its leaves.

Nothing here imports JAX: the caller converts its arrays with
``np.asarray`` (bfloat16 ones as float32, which holds them exactly).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import edram
from repro_torch.core.isc_array import ISCState
from repro_torch.core import time_surface as ts
from repro_torch.device import resolve_device
from repro_torch.models import module as M
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.serve import heads
from repro_torch.serve.ts_engine import EngineState, ReadoutCache

#: leaf path -> dtype of the engine state's arrays (``counts`` optional)
LEAVES = {
    "surfaces.sae": np.float32,
    "surfaces.t_last": np.float32,
    "surfaces.n_events": np.int32,
    "generation": np.int32,
    "cache.tiles": np.float32,
    "cache.dirty": np.bool_,
    "counts": np.int32,
}


def decay_params_from_numpy(params, device=None) -> edram.DecayParams:
    """Decay params from five arrays or scalars (a1, tau1, a2, tau2, b):
    0-d values become float32 host scalars, planes float32 tensors on
    ``device`` (default: the CUDA device; raises when there is none)."""
    device = resolve_device(device)
    out = []
    for x in params:
        a = np.asarray(x, np.float32)
        out.append(np.float32(a) if a.ndim == 0
                   else torch.from_numpy(a.copy()).to(device))
    return edram.DecayParams(*out)


def engine_state_from_numpy(arrays: Mapping[str, np.ndarray],
                            device) -> EngineState:
    """An ``EngineState`` on ``device`` from ``{leaf path: array}``.
    ``counts`` may be missing or None (no counter plane)."""

    def get(name):
        a = np.asarray(arrays[name])
        if a.dtype != LEAVES[name]:
            raise TypeError(f"{name}: dtype {a.dtype}, expected "
                            f"{np.dtype(LEAVES[name])}")
        return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)

    counts = arrays.get("counts")
    return EngineState(
        surfaces=ts.SurfaceState(sae=get("surfaces.sae"),
                                 t_last=get("surfaces.t_last"),
                                 n_events=get("surfaces.n_events")),
        generation=get("generation"),
        cache=ReadoutCache(tiles=get("cache.tiles"),
                           dirty=get("cache.dirty")),
        counts=None if counts is None else get("counts"),
    )


def engine_state_to_numpy(state: EngineState) -> Dict[str, np.ndarray]:
    """``{leaf path: numpy array}`` of a port ``EngineState``."""
    out = {
        "surfaces.sae": state.surfaces.sae,
        "surfaces.t_last": state.surfaces.t_last,
        "surfaces.n_events": state.surfaces.n_events,
        "generation": state.generation,
        "cache.tiles": state.cache.tiles,
        "cache.dirty": state.cache.dirty,
        "counts": state.counts,
    }
    return {k: v.detach().cpu().numpy() for k, v in out.items()
            if v is not None}


def isc_state_from_numpy(arrays: Mapping[str, np.ndarray],
                         device=None) -> ISCState:
    """An ``ISCState`` on ``device`` (default: the CUDA device; raises
    when there is none) from ``{leaf path: array}``: ``sae`` and
    ``droop`` float32 (P, H, W), ``params.a1`` ... ``params.b`` planes or
    0-d values (``decay_params_from_numpy``)."""
    device = resolve_device(device)

    def plane(name):
        a = np.asarray(arrays[name])
        if a.dtype != np.float32:
            raise TypeError(f"{name}: dtype {a.dtype}, expected float32")
        return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)

    params = decay_params_from_numpy(
        [arrays[f"params.{f}"] for f in edram.DecayParams._fields], device)
    return ISCState(sae=plane("sae"), droop=plane("droop"), params=params)


def isc_state_to_numpy(state: ISCState) -> Dict[str, np.ndarray]:
    """``{leaf path: numpy array}`` of an ``ISCState`` (0-d parameters as
    0-d float32 arrays)."""
    out = {"sae": state.sae.detach().cpu().numpy(),
           "droop": state.droop.detach().cpu().numpy()}
    for f, v in zip(edram.DecayParams._fields, state.params):
        out[f"params.{f}"] = (v.detach().cpu().numpy()
                              if isinstance(v, torch.Tensor)
                              else np.asarray(v, np.float32))
    return out


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _to_numpy(tree) -> Dict[str, np.ndarray]:
    """``{leaf path: array}``; bfloat16 leaves widen to float32."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v)
            .detach().cpu().numpy() for k, v in M.flatten(tree).items()}


def lm_params_from_numpy(arrays: Mapping[str, np.ndarray], cfg: ModelConfig,
                         device) -> dict:
    """The port's parameter dict for ``cfg`` on ``device`` from the
    reference's ``{leaf path: array}``; raises on a missing, extra or
    misshapen leaf."""
    defs = M.flatten(T.param_defs(cfg))
    if set(arrays) != set(defs):
        raise KeyError(f"leaf paths differ: missing "
                       f"{sorted(set(defs) - set(arrays))}, extra "
                       f"{sorted(set(arrays) - set(defs))}")
    out = {}
    for path, d in defs.items():
        a = np.asarray(arrays[path])
        if a.shape != d.shape:
            raise ValueError(f"{path}: shape {a.shape} != {d.shape}")
        out[path] = _tensor(a, d.dtype, device)
    return M.unflatten(out)


def lm_params_to_numpy(params) -> Dict[str, np.ndarray]:
    """``{leaf path: array}`` of the port's LM parameters."""
    return _to_numpy(params)


def decode_caches_from_numpy(caches: Sequence[Mapping[str, np.ndarray]],
                             cfg: ModelConfig, device) -> List[dict]:
    """Per-layer decode caches on ``device`` from the reference's
    ``[{leaf path: array}]``: the conv rings in the activation dtype, the
    SSM state in float32."""
    want = M.flatten({"ssm": SSM.init_ssm_cache(cfg, 1, cfg.activation_dtype,
                                                "cpu")})
    if len(caches) != cfg.n_layers:
        raise ValueError(f"{len(caches)} layer caches for "
                         f"{cfg.n_layers} layers")
    out = []
    for layer in caches:
        if set(layer) != set(want):
            raise KeyError(f"cache leaf paths {sorted(layer)} != "
                           f"{sorted(want)}")
        out.append(M.unflatten({k: _tensor(layer[k], want[k].dtype, device)
                                for k in want}))
    return out


def decode_caches_to_numpy(caches: Sequence[dict]) -> List[Dict[str, np.ndarray]]:
    """``[{leaf path: array}]`` of the port's per-layer decode caches."""
    return [_to_numpy(c) for c in caches]


def head_params_from_numpy(arrays: Mapping[str, np.ndarray], head, cfg,
                           device=None) -> dict:
    """A ``Classify`` head's param tree on ``device`` (default: the CUDA
    device; raises when there is none) from the reference's ``{leaf path:
    array}``; raises on a missing, extra or misshapen leaf.  ``cfg`` is
    the engine config (its polarities size the input channels)."""
    device = resolve_device(device)
    defs = M.flatten(heads.head_param_defs(head, cfg), sep="/")
    if set(arrays) != set(defs):
        raise KeyError(f"leaf paths {sorted(arrays)} != {sorted(defs)}")
    out = {}
    for path, d in defs.items():
        a = np.asarray(arrays[path])
        if a.shape != d.shape:
            raise ValueError(f"{path}: shape {a.shape} != {d.shape}")
        out[path] = _tensor(a, d.dtype, device)
    return M.unflatten(out, sep="/")


def head_params_to_numpy(params) -> Dict[str, np.ndarray]:
    """``{leaf path: array}`` of a head's param tree, paths joined with
    ``/``."""
    return {k: v.detach().cpu().numpy()
            for k, v in M.flatten(params, sep="/").items()}
