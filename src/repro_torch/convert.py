"""Carry state between the JAX package and the port, as numpy arrays.

The JAX ``EngineState`` leaves, handed over as numpy arrays keyed by
their path (``LEAVES``), map one to one onto the port's ``EngineState``
and back.  Nothing here imports JAX: the caller converts its arrays with
``np.asarray``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core import edram
from repro_torch.core import time_surface as ts
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


def decay_params_from_numpy(params) -> edram.DecayParams:
    """Decay params from five arrays or scalars (a1, tau1, a2, tau2, b):
    0-d values become float32 host scalars, planes float32 tensors."""
    out = []
    for x in params:
        a = np.asarray(x, np.float32)
        out.append(np.float32(a) if a.ndim == 0 else torch.from_numpy(a.copy()))
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
