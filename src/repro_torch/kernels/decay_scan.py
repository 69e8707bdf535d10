"""CUDA wrappers of the ``decay_scan`` kernels (``csrc/decay_scan.cu``).

``s_t = a_t * s_{t-1} + x_t`` over (B, T, C), elementwise in C, from an
optional initial state ``s0`` (B, C) (zeros when None).  ``a`` and ``x``
are cast to float32 first, as the reference's ``decay_scan_pallas`` does.

``DecayScan`` is the recurrence as a ``torch.autograd.Function``: its
forward launches ``decay_scan`` and its backward ``decay_scan_bwd``, so a
loss differentiates through the kernel on the card as ``jax.grad`` does
through the reference's scan.

On ``meta`` tensors (the dry run, ``launch.dryrun``) both wrappers take
a meta route: they compute and launch nothing, return empty meta
tensors of the kernels' shapes and dtypes, and charge
``_lib.META_COSTS`` with what the kernels do: 2 FLOPs a cell forward and
3 backward, each input read once and each output written once.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _lib

_MAX_BLOCKS = 2**31 - 1   # the kernels' 1-D grid of 256-thread blocks


def _check_grid(b: int, c: int) -> None:
    if -(-b * c // 256) > _MAX_BLOCKS:
        raise ValueError(f"B*C = {b * c} exceeds the kernel's grid")


def _f32(v: Optional[torch.Tensor], name: str, shape, dev):
    if v is None:
        return None
    if tuple(v.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(v.shape)} != {tuple(shape)}")
    v = v.to(torch.float32).contiguous()
    _lib.check(v, name, torch.float32, dev)
    return v


def decay_scan_cuda(a: torch.Tensor, x: torch.Tensor,
                    s0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the recurrence on ``a``'s device.  Returns (states (B, T, C),
    final (B, C)), both float32, with no autograd history (on meta
    tensors: empty, the kernel's work charged)."""
    dev = a.device
    if a.dim() != 3 or x.shape != a.shape:
        raise ValueError(f"a and x must be (B, T, C) of one shape; got "
                         f"{tuple(a.shape)} and {tuple(x.shape)}")
    b, t, c = a.shape
    a = _f32(a, "a", a.shape, dev)
    x = _f32(x, "x", a.shape, dev)
    s0 = _f32(s0, "s0", (b, c), dev)
    _check_grid(b, c)
    out = torch.empty((b, t, c), dtype=torch.float32, device=dev)
    final = torch.empty((b, c), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        _lib.charge("decay_scan", 2 * b * t * c,
                    4 * (3 * b * t * c + b * c * (1 + (s0 is not None))))
    elif b * c:
        _lib.launch("decay_scan", "decay_scan", dev, a.data_ptr(),
                    x.data_ptr(), _lib.ptr(s0), out.data_ptr(),
                    final.data_ptr(), b, t, c)
    return out, final


def decay_scan_bwd_cuda(a: torch.Tensor, states: torch.Tensor,
                        s0: Optional[torch.Tensor], g: torch.Tensor,
                        g_final: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor]]:
    """Launch the backward on ``a``'s device: from the forward's ``a``,
    ``states`` and ``s0`` and the gradients ``g`` of the states and
    ``g_final`` of the final state (None: zero), return ``(da, dx, ds0)``
    float32 (``ds0`` None when ``s0`` is None; on meta tensors empty, the
    kernel's work charged).  See ``ref.decay_scan_bwd_ref``."""
    dev = a.device
    if a.dim() != 3:
        raise ValueError(f"a must be (B, T, C); got {tuple(a.shape)}")
    b, t, c = a.shape
    a = _f32(a, "a", a.shape, dev)
    states = _f32(states, "states", a.shape, dev)
    g = _f32(g, "g", a.shape, dev)
    s0 = _f32(s0, "s0", (b, c), dev)
    g_final = _f32(g_final, "g_final", (b, c), dev)
    _check_grid(b, c)
    da = torch.empty((b, t, c), dtype=torch.float32, device=dev)
    dx = torch.empty((b, t, c), dtype=torch.float32, device=dev)
    if t == 0:   # final = s0: its gradient passes straight through
        ds0 = None if s0 is None else (
            torch.zeros_like(s0) if g_final is None else g_final.clone())
        return da, dx, ds0
    ds0 = None if s0 is None else torch.empty_like(s0)
    if dev.type == "meta":
        small = 2 * (s0 is not None) + (g_final is not None)
        _lib.charge("decay_scan_bwd", 3 * b * t * c,
                    4 * (5 * b * t * c + small * b * c))
    elif b * c:
        _lib.launch("decay_scan_bwd", "decay_scan_bwd", dev, a.data_ptr(),
                    states.data_ptr(), _lib.ptr(s0), g.data_ptr(),
                    _lib.ptr(g_final), da.data_ptr(), dx.data_ptr(),
                    _lib.ptr(ds0), b, t, c)
    return da, dx, ds0


class DecayScan(torch.autograd.Function):
    """``decay_scan_cuda`` with ``decay_scan_bwd_cuda`` as its backward.

    The forward saves ``a``, ``s0`` and the states it wrote; a gradient
    that autograd does not deliver (the final state, discarded in
    training; the states, unused) counts as zero.  Gradients are returned
    only for the inputs that need them, in their dtypes."""

    @staticmethod
    def forward(ctx, a, x, s0):
        states, final = decay_scan_cuda(a, x, s0)
        ctx.dtypes = (a.dtype, x.dtype, None if s0 is None else s0.dtype)
        ctx.save_for_backward(a, s0, states)
        ctx.set_materialize_grads(False)
        return states, final

    @staticmethod
    def backward(ctx, g_states, g_final):
        a, s0, states = ctx.saved_tensors
        need_a, need_x, need_s0 = ctx.needs_input_grad
        if not (need_a or need_x or need_s0):
            return None, None, None
        if g_states is None:
            g_states = torch.zeros_like(states)
        da, dx, ds0 = decay_scan_bwd_cuda(a, states, s0, g_states, g_final)
        dt_a, dt_x, dt_s0 = ctx.dtypes
        return (da.to(dt_a) if need_a else None,
                dx.to(dt_x) if need_x else None,
                ds0.to(dt_s0) if need_s0 and ds0 is not None else None)
