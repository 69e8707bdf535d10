"""InternVL2-26B backbone (InternLM2-20B-class LM) [arXiv:2404.16821; hf].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.  The InternViT
frontend is a STUB: input_specs() provides 1024 precomputed patch
embeddings.  vocab padded to 92672 for sharding.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92553,
    frontend="patch", frontend_seq=1024,
    fsdp=True, n_microbatches=16,
)
