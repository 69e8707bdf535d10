"""PyTorch + CUDA port of the 3DS-ISC time-surface system.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``hw``, ``events``, ``core``, ``kernels``, ``serve``, ``configs``,
``models``, ``launch``) and runs two serving paths on an NVIDIA Hopper
card through hand-written CUDA kernels (``kernels/csrc``): the
single-device time-surface engine, and Mamba-2 token serving (prefill and
greedy decode).  It imports neither ``jax`` nor ``repro``.  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``; kernel
entries dispatch on the device of their tensors.
"""
