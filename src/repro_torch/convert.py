"""Carry state between the JAX package and the port, as numpy arrays.

Every structure crosses as ``{leaf path: numpy array}``, paths joined
with ``.``, and maps one to one onto the port's tensors and back:

  * the time-surface engine's ``EngineState`` (``LEAVES``; the slot
    generations, which key the analog noise draws, included);
  * an ``ISCArray``'s ``ISCState`` (``sae``, ``droop``, ``params.<name>``
    as planes or 0-d scalars);
  * an LM's parameters (``embed``, ``layers.ln1``, ``layers.ln2``,
    ``layers.attn.{wq,wk,wv,wo,q_norm,k_norm}``,
    ``layers.mlp.{wi_gate,wi_up,wo}``, ``layers.ssm.<name>``, each
    stacked on a leading layer dim, ``ln_f``, ``unembed``);
  * an LM's decode caches, one dict per layer: an attention layer's
    ``k``, ``v``, ``pos`` (with ``k_scale``, ``v_scale`` for an int8
    cache), an SSM layer's ``ssm.conv.x``, ``ssm.conv.b``,
    ``ssm.conv.c``, ``ssm.state``;
  * a ``Classify`` head's CNN parameters, whose paths are joined with
    ``/`` instead (``inc1/b3a/w``), as a checkpoint names its leaves;
  * any model's parameters against its ``ParamDef`` tree (the UNet's,
    the CNN's), and an optimizer's state against a state tree of the
    same structure (AdamW's ``m.<path>`` / ``v.<path>``, Adafactor's
    ``<path>.vr`` / ``.vc`` / ``.v`` and its bfloat16 ``<path>.m``).

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
    """``a`` as a tensor; a bfloat16 array (the reference's, which numpy
    knows only through ``ml_dtypes``) crosses exactly through float32."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _to_numpy(tree) -> Dict[str, np.ndarray]:
    """``{leaf path: array}``; bfloat16 leaves widen to float32."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v)
            .detach().cpu().numpy() for k, v in M.flatten(tree).items()}


def _same_paths(arrays, want) -> None:
    if set(arrays) != set(want):
        raise KeyError(f"leaf paths differ: missing "
                       f"{sorted(set(want) - set(arrays))}, extra "
                       f"{sorted(set(arrays) - set(want))}")


def params_from_numpy(arrays: Mapping[str, np.ndarray], defs, device=None,
                      sep: str = ".") -> dict:
    """The param tree of ``defs`` (a nested dict of ``ParamDef``) on
    ``device`` (default: the CUDA device; raises when there is none) from
    ``{leaf path: array}``, each leaf in its def's dtype; raises on a
    missing, extra or misshapen leaf."""
    device = resolve_device(device)
    defs = M.flatten(defs, sep=sep)
    _same_paths(arrays, defs)
    out = {}
    for path, d in defs.items():
        a = np.asarray(arrays[path])
        if a.shape != d.shape:
            raise ValueError(f"{path}: shape {a.shape} != {d.shape}")
        out[path] = _tensor(a, d.dtype, device)
    return M.unflatten(out, sep=sep)


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """``{leaf path: array}`` of a param tree (bfloat16 leaves as
    float32)."""
    return _to_numpy(params)


def lm_params_from_numpy(arrays: Mapping[str, np.ndarray], cfg: ModelConfig,
                         device) -> dict:
    """The port's parameter dict for ``cfg`` on ``device`` from the
    reference's ``{leaf path: array}``; raises on a missing, extra or
    misshapen leaf."""
    return params_from_numpy(arrays, T.param_defs(cfg), device)


def lm_params_to_numpy(params) -> Dict[str, np.ndarray]:
    """``{leaf path: array}`` of the port's LM parameters."""
    return _to_numpy(params)


def decode_caches_from_numpy(caches: Sequence[Mapping[str, np.ndarray]],
                             cfg: ModelConfig, device) -> List[dict]:
    """Per-layer decode caches on ``device`` from the reference's
    ``[{leaf path: array}]``, each leaf in the dtype ``init_decode_caches``
    gives it: an SSM layer's conv rings in the activation dtype and its
    state in float32; an attention layer's ``k`` / ``v`` in the
    activation dtype, or int8 with bf16 scales for an int8 cache, and
    ``pos`` int32; a hybrid layer's both, in one dict.  A prefilled int8 config's caches hold unquantized
    ``k`` / ``v`` and no scales (the reference's prefill builds them so)
    and cross as such."""
    if len(caches) != cfg.n_layers:
        raise ValueError(f"{len(caches)} layer caches for "
                         f"{cfg.n_layers} layers")
    out = []
    for layer, like in zip(caches, T.init_decode_caches(cfg, 1, 1,
                                                        device="cpu")):
        want = {k: t.dtype for k, t in M.flatten(like).items()}
        if "k_scale" in want and "k_scale" not in layer:
            del want["k_scale"], want["v_scale"]
            want.update(k=cfg.activation_dtype, v=cfg.activation_dtype)
        if set(layer) != set(want):
            raise KeyError(f"cache leaf paths {sorted(layer)} != "
                           f"{sorted(want)}")
        out.append(M.unflatten({k: _tensor(layer[k], dt, device)
                                for k, dt in want.items()}))
    return out


def decode_caches_to_numpy(caches: Sequence[dict]) -> List[Dict[str, np.ndarray]]:
    """``[{leaf path: array}]`` of the port's per-layer decode caches."""
    return [_to_numpy(c) for c in caches]


def opt_state_from_numpy(arrays: Mapping[str, np.ndarray], like) -> dict:
    """An optimizer state from ``{leaf path: array}``, each leaf in the
    dtype and on the device of the same path in ``like`` (the optimizer's
    ``init`` of the parameters: bfloat16 where Adafactor keeps its first
    moment); raises on a missing, extra or misshapen leaf."""
    like = M.flatten(like)
    _same_paths(arrays, like)
    out = {}
    for path, t in like.items():
        a = np.asarray(arrays[path])
        if a.shape != tuple(t.shape):
            raise ValueError(f"{path}: shape {a.shape} != {tuple(t.shape)}")
        out[path] = _tensor(a, t.dtype, t.device)
    return M.unflatten(out)


def opt_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """``{leaf path: array}`` of an optimizer state (bfloat16 moments as
    float32, which holds them exactly)."""
    return _to_numpy(state)


def head_params_from_numpy(arrays: Mapping[str, np.ndarray], head, cfg,
                           device=None) -> dict:
    """A ``Classify`` head's param tree on ``device`` (default: the CUDA
    device; raises when there is none) from the reference's ``{leaf path:
    array}``; raises on a missing, extra or misshapen leaf.  ``cfg`` is
    the engine config (its polarities size the input channels)."""
    return params_from_numpy(arrays, heads.head_param_defs(head, cfg),
                             device, sep="/")


def head_params_to_numpy(params) -> Dict[str, np.ndarray]:
    """``{leaf path: array}`` of a head's param tree, paths joined with
    ``/``."""
    return {k: v.detach().cpu().numpy()
            for k, v in M.flatten(params, sep="/").items()}
