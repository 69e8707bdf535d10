"""Gradients of a loss over a param tree: the port's ``jax.value_and_grad``.

The forward and backward of a training step run in full float32
(``models.cnn.float32_math``): autograd runs a convolution's backward
after the forward's ``with`` block has exited, and cuDNN would take it in
TF32 by default, so the rule is held around the backward too.

The convolutions are cuDNN's, as at inference, unless the caller asks
for ``direct`` ones: PyTorch's direct CUDA convolution (im2col and a
cuBLAS product, cuDNN off), which keeps every exact zero of the
reference's gradients.  cuDNN's backward does not always: measured on an
H100 (``tools/train_probe.py convs``), the data gradient of the
reconstruction UNet's 72 -> 24 decoder convolution came out nonzero (up
to 3.2e-12) on 236,549 of its 675,684 cells whose exact sum is 0, and
step 1's weight gradients on 303 of 1,727 cells the reference leaves at
0, under every cuDNN setting (its heuristics, ``benchmark``,
``deterministic``).  Adam's normalised step turns such a cell into a
step of its own, and over 80 steps the protocol's held-out SSIM lands
low more often than the reference's does.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.models import module as M
from repro_torch.models.cnn import float32_math


@contextlib.contextmanager
def direct_convolutions(direct: bool = True):
    """cuDNN off for the block (PyTorch's direct convolution) when
    ``direct``, the global flag restored after."""
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = enabled and not direct
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


def value_and_grad(fn, direct: bool = False, has_aux: bool = False,
                   into=None):
    """``fn(params, *args) -> scalar loss`` (``-> (loss, aux dict)`` with
    ``has_aux``) -> a function ``(params, *args) -> (loss, grads)``
    (``((loss, aux), grads)`` with ``has_aux``, as ``jax.value_and_grad``),
    ``grads`` a tree like ``params``; forward and backward in full float32
    (on direct convolutions if ``direct``), the inputs left untouched.

    With ``into``, a tree of tensors like ``params`` (same paths, shapes
    and dtypes), each gradient is added in place into ``into``'s leaf by
    autograd's own accumulation as the backward produces it (no second
    copy of the gradients is held) and ``grads`` is ``into``.  A leaf
    that gets no gradient keeps its value."""
    def wrapped(params, *args):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in M.flatten(params).items()}
        sinks = None if into is None else M.flatten(into)
        if sinks is not None:
            for k, v in leaves.items():
                v.grad = sinks[k]
        with torch.enable_grad(), float32_math(), direct_convolutions(direct):
            out = fn(M.unflatten_like(params, leaves), *args)
            loss, aux = out if has_aux else (out, None)
            if sinks is None:
                grads = M.unflatten_like(params, dict(zip(
                    leaves, torch.autograd.grad(loss, list(leaves.values())))))
            else:
                loss.backward()
                moved = [k for k, v in leaves.items()
                         if v.grad is not sinks[k]]
                if moved:
                    raise RuntimeError(
                        f"autograd replaced the gradient buffers of {moved} "
                        "instead of accumulating into them")
                grads = into
        loss = loss.detach()
        if has_aux:
            return (loss, {k: v.detach() for k, v in aux.items()}), grads
        return loss, grads

    return wrapped
