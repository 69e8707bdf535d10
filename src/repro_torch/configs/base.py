"""Model/run configuration schema and the input-shape registry.

The port of ``repro.configs.base``: the same ``ModelConfig`` with every
field, so an architecture file copies over unchanged;
``activation_dtype`` is a ``torch.dtype``.  The four benchmark input
shapes (train_4k, prefill_32k, decode_32k, long_500k) are global and
arch-independent.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # --- attention features ---
    attn_pattern: Tuple[str, ...] = ("global",)   # repeating layer pattern
    window: int = 4096                            # local-attention window
    qk_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    ssm_chunk: int = 128

    # --- hybrid (hymba): parallel attn+ssm heads; some layers global ---
    global_attn_layers: Tuple[int, ...] = ()

    # --- modality frontend (stub: precomputed embeddings) ---
    frontend: str = "none"          # none | patch | frames | event_ts
    frontend_seq: int = 0           # prepended embedding positions

    # --- runtime / distribution ---
    dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True
    n_microbatches: int = 1
    accum_dtype: str = "float32"    # grad-accumulator dtype (bf16 at 1T scale)
    fsdp: bool = False
    # gather FSDP params once per step instead of once per microbatch
    # (ZeRO-3 -> ZeRO-1 for the step; +params/model_shard memory)
    fsdp_gather_once: bool = False
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8 (quantized decode cache)
    optimizer: str = "adamw"        # adamw | adafactor
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # ------------------------------------------------------------------
    @property
    def activation_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, expanding the repeating pattern."""
        kinds = []
        for i in range(self.n_layers):
            k = self.attn_pattern[i % len(self.attn_pattern)]
            if self.family == "hybrid":
                k = "hybrid_global" if i in self.global_attn_layers else "hybrid"
            kinds.append(k)
        return tuple(kinds)

    @property
    def pattern_period(self) -> int:
        if self.family == "hybrid":
            return 1  # probes use the dominant (local) hybrid layer
        return len(self.attn_pattern)

    @property
    def is_sub_quadratic(self) -> bool:
        """Does this arch run long_500k?

        True for SSM/hybrid and for mixed local:global stacks (gemma2/3),
        whose per-step decode cost and cache are dominated by window-bounded
        layers; False for pure full-attention stacks.
        """
        if self.family in ("ssm", "hybrid"):
            return True
        return "local" in self.layer_kinds()

    def _ssm_params(self) -> int:
        from_family = self.d_model if self.family == "hybrid" else \
            self.ssm_expand * self.d_model
        di = from_family
        n, h = self.ssm_state, (self.ssm_heads or di // self.ssm_headdim)
        conv_dim = di + 2 * n
        return (
            self.d_model * (2 * di + 2 * n + h)      # in_proj
            + self.conv_kernel * conv_dim + conv_dim  # conv
            + 3 * h + di                              # a_log, d_skip, dt_bias, norm
            + di * self.d_model                       # out_proj
        )

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    def n_params(self) -> int:
        """Total parameter count (analytic)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = self.n_heads * self.head_dim * d * 2 \
            + self.n_kv_heads * self.head_dim * d * 2
        per_layer = 2 * d  # norms
        kinds = self.layer_kinds()
        total = 0
        for k in kinds:
            lp = per_layer
            if self.family == "ssm":
                lp += self._ssm_params()
            elif self.family == "hybrid":
                lp += attn + self._ssm_params() + 3 * d * f
            else:
                lp += attn
                if self.n_experts:
                    lp += self.n_experts * 3 * d * self.d_ff_expert
                    lp += self.n_shared_experts * 3 * d * self.d_ff_expert
                    lp += d * self.n_experts  # router
                else:
                    lp += 3 * d * f
            total += lp
        total += v * d * (1 if self.tie_embeddings else 2)
        return total

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: routed top-k only)."""
        if not self.n_experts:
            return self.n_params()
        d = self.d_model
        routed_all = self.n_experts * 3 * d * self.d_ff_expert
        routed_active = (self.top_k + self.n_shared_experts) * 3 * d * self.d_ff_expert
        return self.n_params() - self.n_layers * routed_all \
            + self.n_layers * routed_active

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized config of the same family/feature set."""
        small = dict(
            n_layers=min(self.n_layers, 2 if self.pattern_period == 1 else self.pattern_period),
            d_model=64,
            n_heads=max(2, min(4, self.n_heads)),
            n_kv_heads=1 if self.n_kv_heads < self.n_heads else 2,
            head_dim=16,
            d_ff=128,
            vocab=256,
            window=32,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            d_ff_expert=64 if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16),
            # keep heads*headdim == d_inner (= expand*d or d for hybrid)
            ssm_heads=(
                ((self.ssm_expand if self.family == "ssm" else 1) * 64) // 16
                if self.ssm_heads else 0
            ),
            ssm_headdim=16 if self.ssm_heads else 64,
            ssm_chunk=16,
            frontend_seq=min(self.frontend_seq, 16),
            global_attn_layers=(0,) if self.global_attn_layers else (),
            n_microbatches=1,
            fsdp=False,
            dtype="float32",
        )
        if self.n_kv_heads == self.n_heads:  # preserve MHA-ness
            small["n_kv_heads"] = small["n_heads"]
        small.update(overrides)
        return dataclasses.replace(self, **small)
