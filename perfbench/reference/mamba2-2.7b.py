"""Plain float32 reference of mamba2-2.7b as the program serves it.

Mamba-2 (arXiv:2405.21060, state-spaces/mamba2-2.7b): an embedding, then
``n_layers`` residual blocks ``x + mamba2(rms_norm(x))``, a final
RMSNorm and the unembedding.  The departures from the published model
that the program makes are listed under ``assumed`` in
``configs/mamba2-2.7b.json``; this file follows the program's choice in
each.  Imports nothing of the program (only ``common`` beside it).
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

_spec = importlib.util.spec_from_file_location(
    "perfbench_reference_common", Path(__file__).with_name("common.py"))
C = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(C)


def dims(m: dict):
    """(d_inner, SSD heads, head size, state size)."""
    di = m["ssm_expand"] * m["d_model"]
    return di, m["ssm_heads"], m["ssm_headdim"], m["ssm_state"]


def ssm_leaves(m: dict, prefix: str, d_inner: int):
    d, L, k = m["d_model"], m["n_layers"], m["conv_kernel"]
    h, n = m["ssm_heads"], m["ssm_state"]
    lf = C.leaf
    return [
        lf(prefix + "z_proj", (L, d, d_inner), "normal", d),
        lf(prefix + "x_proj", (L, d, d_inner), "normal", d),
        lf(prefix + "b_proj", (L, d, n), "normal", d),
        lf(prefix + "c_proj", (L, d, n), "normal", d),
        lf(prefix + "dt_proj", (L, d, h), "normal", d),
        lf(prefix + "conv_x_w", (L, k, d_inner), "normal", k),
        lf(prefix + "conv_x_b", (L, d_inner), "bias"),
        lf(prefix + "conv_b_w", (L, k, n), "normal", k),
        lf(prefix + "conv_b_b", (L, n), "bias"),
        lf(prefix + "conv_c_w", (L, k, n), "normal", k),
        lf(prefix + "conv_c_b", (L, n), "bias"),
        lf(prefix + "a_log", (L, h), "a_log"),
        lf(prefix + "d_skip", (L, h), "d_skip"),
        lf(prefix + "dt_bias", (L, h), "dt_bias"),
        lf(prefix + "norm", (L, d_inner), "norm"),
        lf(prefix + "out_proj", (L, d_inner, d), "normal", d_inner),
    ]


def leaves(m: dict):
    """Every weight: leaf path, shape, how it is drawn."""
    d, L, vp = m["d_model"], m["n_layers"], m["vocab_padded"]
    return ([C.leaf("embed", (vp, d), "embed"),
             C.leaf("layers.ln1", (L, d), "norm")]
            + ssm_leaves(m, "layers.ssm.", dims(m)[0])
            + [C.leaf("ln_f", (d,), "norm"),
               C.leaf("unembed", (d, vp), "normal", d)])


def logits(m: dict, w: dict, tokens: torch.Tensor, positions,
           fp8: bool = False) -> torch.Tensor:
    """Float32 logits over the true vocab at ``positions`` of every row of
    ``tokens`` (R, T): (R, len(positions), vocab)."""
    eps = m["norm_eps"]
    x = C.embed(w["embed"], tokens, fp8)
    for i in range(m["n_layers"]):
        lw = C.layer_weights(w, i, "layers.")
        sw = {k[len("ssm."):]: v for k, v in lw.items() if k.startswith("ssm.")}
        x = x + C.ssm_branch(sw, C.rms_norm(x, lw["ln1"], eps),
                             m["ssm_heads"], m["ssm_headdim"], eps, fp8)
    x = C.rms_norm(x[:, list(positions)], w["ln_f"], eps)
    return C.linear(x, w["unembed"][:, :m["vocab"]], fp8)
