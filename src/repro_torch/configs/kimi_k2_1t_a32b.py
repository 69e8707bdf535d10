"""Kimi K2 — trillion-parameter MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) MoE 384 experts top-8, d_ff=2048/expert
(+1 shared expert), vocab 163840.  head_dim=128 (MXU-aligned).
Training posture: FSDP over data + EP over model + Adafactor (factored
second moment) + 16-way microbatching — see DESIGN.md capacity analysis.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab=163840,
    n_experts=384, top_k=8, d_ff_expert=2048, n_shared_experts=1,
    fsdp=True, optimizer="adafactor", n_microbatches=8,
    accum_dtype="bfloat16",
)
