"""Kernel entries (``ops``), their CUDA wrappers and plain versions."""
