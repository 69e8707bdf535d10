"""Checkpoints of parameter trees, in the reference's directory layout."""
from repro_torch.checkpoint.ckpt import Checkpointer  # noqa: F401
