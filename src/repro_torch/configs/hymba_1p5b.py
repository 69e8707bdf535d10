"""Hymba 1.5B — parallel attention + mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5, head_dim 64) d_ff=5504 vocab=32001,
ssm_state=16 (25 SSM heads x 64 = d_model, no expansion).  Sliding-window
(1024) attention everywhere except 3 full-attention layers (first/mid/
last), per the Hymba paper.  vocab padded to 32256 for sharding.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    ssm_state=16, ssm_heads=25, ssm_headdim=64, ssm_expand=1,
    window=1024, global_attn_layers=(0, 15, 31),
    fsdp=True, n_microbatches=8,
)
