"""MusicGen-large — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H (kv=32 -> MHA) d_ff=8192, vocab 2048 (EnCodec codes).
The audio frontend (EnCodec + text conditioner) is a STUB: input_specs()
provides 256 precomputed conditioning frame embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048,
    frontend="frames", frontend_seq=256,
    fsdp=True, n_microbatches=8,
)
