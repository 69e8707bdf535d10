"""Gemma-3 4B [hf:google/gemma-3; unverified].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144; 5:1
local(1024):global, head_dim=256 (published), 128k-class context.
34 % 6 != 0 — the scan path uses per-layer traced windows.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144,
    attn_pattern=("local",) * 5 + ("global",), window=1024,
    final_logit_softcap=30.0,
    fsdp=True, n_microbatches=8,
)
