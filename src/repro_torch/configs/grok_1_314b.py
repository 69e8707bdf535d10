"""Grok-1 314B MoE [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) d_ff=32768, 8 experts top-2, vocab 131072.
8 experts < 16-way model axis => per-expert tensor parallelism ("tp" MoE
strategy: every expert's FFN f-sharded over model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab=131072,
    n_experts=8, top_k=2, d_ff_expert=32768,
    fsdp=True, optimizer="adafactor", n_microbatches=8,
    accum_dtype="bfloat16",
)
