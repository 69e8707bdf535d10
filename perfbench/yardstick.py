"""The benchmark's frozen yardstick: the card's published peaks and the
work counts that rooflines and MFU divide by.

Copied, not imported, so that a change to the program cannot move the
yardstick: the peaks from ``repro_torch.hw.constants.H100_SXM``, the
``decay_scan`` byte count from its meta route (``kernels.decay_scan``,
``_lib.META_COSTS``), and a per-request version of
``repro_torch.launch.roofline.model_flops`` that counts only real tokens
(no left padding), the unembedding only where logits are produced, and
adds attention's and the SSD recurrence's own products.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at 700 W
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # outside the tensor cores


def decay_scan_bytes(batch: int, steps: int, channels: int,
                     has_s0: bool) -> int:
    """Bytes a ``decay_scan`` call needs at (B, T, C) in float32: a and x
    read once, the states written once, the final state written, and s0
    read when given."""
    return 4 * (3 * batch * steps * channels
                + batch * channels * (1 + int(has_s0)))


def decay_scan_flops(batch: int, steps: int, channels: int) -> int:
    """One multiply and one add a cell: ``s_t = a_t s_{t-1} + x_t``."""
    return 2 * batch * steps * channels


def _ssm_weights(m: dict, d_inner: int) -> int:
    """Weights a token multiplies in one SSM block (projections in and
    out, the depthwise convolutions)."""
    d, n, h, k = m["d_model"], m["ssm_state"], m["ssm_heads"], m["conv_kernel"]
    return d * (2 * d_inner + 2 * n + h) + k * (d_inner + 2 * n) + d_inner * d


def _layer_weights(m: dict) -> int:
    d = m["d_model"]
    if m["family"] == "ssm":
        return _ssm_weights(m, m["ssm_expand"] * d)
    attn = d * (m["n_heads"] + 2 * m["n_kv_heads"]) * m["head_dim"] \
        + m["n_heads"] * m["head_dim"] * d
    mlp = 3 * d * m["d_ff"]
    ssm = _ssm_weights(m, d) if m["family"] == "hybrid" else 0
    return attn + mlp + ssm


def request_flops(m: dict, prompt: int, new: int) -> float:
    """Useful FLOPs to serve one request of ``prompt`` real tokens and
    ``new`` greedy tokens: the model runs on prompt + new - 1 tokens.
    2 a weight a token in every layer; the unembedding (true vocab) at
    the ``new`` positions whose logits are read; the SSD recurrence's
    update and read-out, 4 * heads * headdim * state a token a layer;
    attention's QK and PV, 4 * heads * head_dim a visible key, where a
    token at request position j sees min(j + 1, window) keys (all j + 1
    in a global layer).  Padding, and the embedding lookup, count
    nothing."""
    tokens = prompt + new - 1
    f = 2.0 * m["n_layers"] * _layer_weights(m) * tokens
    f += 2.0 * m["d_model"] * m["vocab"] * new
    if m["family"] in ("ssm", "hybrid"):
        f += 4.0 * m["ssm_heads"] * m["ssm_headdim"] * m["ssm_state"] \
            * tokens * m["n_layers"]
    if m["family"] != "ssm":
        seen_full = tokens * (tokens + 1) / 2
        w = m.get("window")
        if w is None or w >= tokens:
            seen_local = seen_full
        else:
            seen_local = w * (w + 1) / 2 + (tokens - w) * w
        n_global = len(m.get("global_attn_layers", ()))
        seen = n_global * seen_full + (m["n_layers"] - n_global) * seen_local
        f += 4.0 * m["n_heads"] * m["head_dim"] * seen
    return f
