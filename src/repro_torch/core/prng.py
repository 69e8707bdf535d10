"""The reference's counter-based noise stream (threefry-2x32), in torch.

The analog-fidelity reads draw their per-cell spread from ``jax.random``
keys in the JAX package (``serve/fidelity.py``: ``fold_in(fold_in(
PRNGKey(seed), step), generation)``, then ``normal``).  This module
reproduces that stream so that the port draws the same noise from the
same (seed, step, generation):

  * ``PRNGKey``, ``fold_in``, ``split`` and ``random_bits`` give jax's
    keys and bits **bitwise**, and ``uniform`` (on [0, 1)) its floats bitwise;
  * ``normal`` is ``sqrt(2) * erf_inv(u)`` on jax's uniform ``u`` in
    (-1, 1), with ``erf_inv`` written out as the float32 polynomial XLA
    lowers ``chlo.erf_inv`` to (M. Giles, "Approximating the erfinv
    function", two branches in ``w = -log1p(-x^2)``).  ``torch.log1p``
    and ``sqrt`` are not XLA's routines, so a normal may differ from
    jax's by a few ULP (the band is measured in
    ``tests/test_torch_fidelity.py``).  ``torch.erfinv`` is not used: it
    is another approximation and differs by tens of ULP.

The stream reproduced is that of jax 0.9 with
``jax_threefry_partitionable = True`` (its default): the bits of an array
are the threefry hash of each element's flat index (the 64-bit iota of
the output shape, as two 32-bit halves), xored.  jax 0.4.x, with the flag
off, hashed a split count range instead and gives other bits.

Keys are int64 tensors of shape ``(..., 2)`` holding two uint32 words
each; every uint32 operation runs in int64 and is masked back to 32 bits
(torch's uint32 lacks most operations on CUDA).  Leading key dimensions
batch: ``fold_in`` of one key with an (S,) tensor of data gives S keys,
and ``normal`` of S keys gives S independent arrays.  Everything runs on
the keys' device.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import f32

__all__ = ["PRNGKey", "fold_in", "split", "threefry2x32", "random_bits",
           "uniform", "normal", "normal_at", "erf_inv"]

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's float32 ErfInv coefficients (highest degree first), for
# w = -log1p(-x^2) < 5 and >= 5
_ERFINV_LT5 = tuple(np.float32(c) for c in (
    "2.81022636e-08", "3.43273939e-07", "-3.5233877e-06", "-4.39150654e-06",
    "0.00021858087", "-0.00125372503", "-0.00417768164", "0.246640727",
    "1.50140941"))
_ERFINV_GE5 = tuple(np.float32(c) for c in (
    "-0.000200214257", "0.000100950558", "0.00134934322", "-0.00367342844",
    "0.00573950773", "-0.0076224613", "0.00943887047", "1.00167406",
    "2.83297682"))


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The key of an integer seed: ``(0, seed mod 2^32)``, as jax builds
    it from a 32-bit seed.  ``device`` defaults to the CPU (a key is two
    words; its draws run wherever it lies)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))).bitwise_and_(_MASK)


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 block function (20 rounds) on uint32 words held
    in int64 tensors; all four broadcast.  Returns the two output words."""
    k1, k2, x1, x2 = torch.broadcast_tensors(k1, k2, x1, x2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    y0 = (x1 + ks[0]).bitwise_and_(_MASK)
    y1 = (x2 + ks[1]).bitwise_and_(_MASK)
    for i in range(1, 6):
        for r in _ROTATIONS[(i - 1) % 2]:
            y0.add_(y1).bitwise_and_(_MASK)
            y1 = _rotl(y1, r).bitwise_xor_(y0)
        y0.add_(ks[i % 3]).bitwise_and_(_MASK)
        y1.add_(ks[(i + 1) % 3]).add_(i).bitwise_and_(_MASK)
    return y0, y1


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the count pair ``(0, data)``
    (data cast to uint32) under ``key``.  ``data`` may be an int or an
    integer tensor; its shape batches against the key's leading dims."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack((y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one key into ``num`` keys ((num, 2)): key
    ``i`` is the two threefry output words of the count pair (high,
    low) of ``i`` under ``key``, not xored."""
    idx = torch.arange(int(num), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None], idx >> 32,
                          idx & _MASK)
    return torch.stack((y0, y1), dim=-1)


def _bits_at(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The 32 random bits of the elements at flat indices ``idx`` (int64,
    any shape) of an array drawn under each key: output shape
    ``key.shape[:-1] + idx.shape``.  Each element hashes its flat index's
    (high, low) words; the two output words are xored."""
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * idx.dim())
    k2 = key[..., 1].reshape(lead + (1,) * idx.dim())
    y0, y1 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return y0.bitwise_xor_(y1)


def _flat_indices(shape: Sequence[int], device) -> torch.Tensor:
    shape = tuple(int(n) for n in shape)
    return torch.arange(math.prod(shape), dtype=torch.int64,
                        device=device).reshape(shape)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` (values in [0, 2^32), as
    int64), for each key: output shape ``key.shape[:-1] + shape``."""
    return _bits_at(key, _flat_indices(shape, key.device))


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """Floats in [0, 1): the top 23 bits as the mantissa of [1, 2), minus
    one (jax's construction, exact)."""
    mant = (bits >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - f32(1.0, bits.device)


def _uniform_bits(bits: torch.Tensor, minval: float,
                  maxval: float) -> torch.Tensor:
    dev = bits.device
    lo, hi = f32(minval, dev), f32(maxval, dev)
    return torch.maximum(lo, _unit_floats(bits) * (hi - lo) + lo)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: ``max(minval, floats *
    (maxval - minval) + minval)`` (bitwise jax's on [0, 1))."""
    return _uniform_bits(random_bits(key, shape), minval, maxval)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 inverse error function: Giles' polynomial in
    ``w - 2.5`` (w < 5) or ``sqrt(w) - 3`` (w >= 5), ``w = -log1p(-x^2)``,
    evaluated as XLA's decomposition orders it; +-1 maps to +-inf."""
    dev = x.device
    w = -torch.log1p(x * -x)
    lt = w < f32(5.0, dev)
    w = torch.where(lt, w - f32(2.5, dev), torch.sqrt(w) - f32(3.0, dev))
    coef = [torch.where(lt, f32(a, dev), f32(b, dev))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = c + p * w
    out = p * x
    return torch.where(x.abs() == f32(1.0, dev), x * f32(math.inf, dev), out)


def normal_at(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The normals at flat indices ``idx`` of ``normal(key, shape)``: a
    large array can be drawn slice by slice, with the same numbers."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = _uniform_bits(_bits_at(key, idx), lo, 1.0)
    return f32(np.float32(np.sqrt(2)), key.device) * erf_inv(u)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)``, ``u``
    uniform on [nextafter(-1, 0), 1)."""
    return normal_at(key, _flat_indices(shape, key.device))
