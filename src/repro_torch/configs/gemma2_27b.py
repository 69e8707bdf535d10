"""Gemma-2 27B [arXiv:2408.00118; hf].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000; 1:1
local(4096):global alternation, attn softcap 50, final softcap 30,
head_dim=128 (published).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000,
    attn_pattern=("local", "global"), window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    fsdp=True, n_microbatches=16,
)
