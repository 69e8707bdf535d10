"""GLM-4 9B [hf:THUDM/glm-4-9b].

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552; partial RoPE
(half the head dims rotate), 2 KV heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab=151552,
    rope_fraction=0.5,
    fsdp=True, n_microbatches=8,
)
