"""Mamba-2 2.7B — attention-free SSD [arXiv:2405.21060; unverified].

64L d_model=2560, ssm_state=128, expand 2 -> d_inner 5120, headdim 64
-> 80 SSD heads, vocab 50280.  Runs long_500k (O(1) decode state).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_heads=80, ssm_headdim=64, ssm_expand=2,
    attn_pattern=("ssm",),
    n_microbatches=8,
)
