"""Modality frontends: the vlm / audio stubs and the paper's time
surfaces as model inputs.

The port of ``repro.models.frontends``:

  * ``stub_embeddings_spec`` -- the shape and dtype of the precomputed
    patch / frame embeddings that stand in for the vlm and audio
    families' frontends (the backbone is what those configs specify);
  * ``event_ts_frontend`` -- SAE -> (eDRAM or ideal) TS -> non-overlapping
    patches -> LM token embeddings;
  * ``ts_stack_frontend`` -- K surface reads stacked on the channel axis
    of a conv head (``models.cnn``), the input of the ``Classify`` head.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import edram
from repro_torch.core import time_surface as ts
from repro_torch.models.cnn import float32_math
from repro_torch.models.module import ParamDef


def stub_embeddings_spec(cfg: ModelConfig, batch: int
                         ) -> Tuple[Tuple[int, int, int], torch.dtype]:
    """(shape, dtype) of precomputed frontend embeddings (vlm/audio):
    ``(batch, frontend_seq, d_model)`` in the activation dtype, what
    ``transformer.forward`` takes as ``embeds``."""
    return (batch, cfg.frontend_seq, cfg.d_model), cfg.activation_dtype


def event_ts_frontend_defs(cfg: ModelConfig, patch: int = 8,
                           polarities: int = 1) -> dict:
    return {
        "proj": ParamDef((patch * patch * polarities, cfg.d_model),
                         (None, "embed")),
        "pos": ParamDef((cfg.frontend_seq, cfg.d_model), (None, "embed"),
                        init="embed", scale=0.02),
    }


def event_ts_frontend(params, sae: torch.Tensor, t_read, cfg: ModelConfig,
                      decay: Optional[edram.DecayParams] = None,
                      tau: float = 24e-3, patch: int = 8) -> torch.Tensor:
    """(B, P, H, W) SAE -> (B, n, d_model) patch embeddings in the
    config's activation dtype, n = min(patches, frontend_seq)."""
    if decay is None:
        frame = ts.ts_ideal(sae, t_read, tau)
    else:
        frame = ts.ts_edram(sae, t_read, decay)
    b, p, h, w = frame.shape
    hp, wp = h // patch, w // patch
    x = frame[:, :, :hp * patch, :wp * patch]
    x = x.reshape(b, p, hp, patch, wp, patch)
    x = x.movedim((2, 4), (1, 2)).reshape(b, hp * wp, p * patch * patch)
    proj = params["proj"]
    with float32_math():
        emb = torch.einsum("bne,ed->bnd", x.to(proj.dtype), proj)
    n = min(emb.shape[1], params["pos"].shape[0])
    return (emb[:, :n] + params["pos"][None, :n]).to(cfg.activation_dtype)


def ts_stack_frontend(surfaces: Sequence[torch.Tensor]) -> torch.Tensor:
    """K decayed surfaces -> one NHWC stack for a conv head.

    Each surface is a (S, P, H, W) pool read; the output is (S, H, W, K*P)
    with the k-th surface's polarities at channels ``[k*P, (k+1)*P)``.
    Pure layout -- no arithmetic -- so the stacked channels hold exactly
    the bits the surface products were read with.
    """
    x = torch.stack(list(surfaces), dim=1)          # (S, K, P, H, W)
    s, k, p, h, w = x.shape
    return x.reshape(s, k * p, h, w).movedim(1, -1)
