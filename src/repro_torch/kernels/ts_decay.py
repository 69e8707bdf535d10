"""CUDA wrapper of the ``ts_decay`` kernel (``csrc/ts_decay.cu``).

The time-surface decay read of every cell of an SAE tensor of any shape
(an (S, P, H, W) pool, or a (K, bh, bw) stack of dirty tiles), with the
comparator mask ``v > v_tw`` optionally written in the same pass.
Uniform parameters go to the kernel by value; per-cell (H, W) planes by
pointer, broadcast over the leading dims, on a launch shape chosen here
(``planes_launch``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _lib

THREADS = 256          # csrc/ts_decay.cu kThreads
PLANE_GROUP = 8        # leading planes a block walks, at most
TARGET_BLOCKS = 1024   # about one wave of resident blocks on an H100
MAX_GRID_Y = 65535


class PlanesLaunch(NamedTuple):
    vec4: bool     # a thread owns 4 neighbouring cells (16-byte accesses)
    group: int     # leading planes per block
    grid: tuple    # (columns of THREADS threads, groups of leading planes)


def planes_launch(lead: int, plane: int, aligned: bool) -> PlanesLaunch:
    """The plane form's launch for ``lead`` leading planes of ``plane``
    cells.  Four cells a thread where the plane length is a multiple of 4
    and every pointer ``aligned`` (16 bytes for the floats, 4 for the
    mask), else one; ``grid[0]`` blocks cover the plane, the last one
    ragged.  Each block walks ``group`` leading planes with its threads'
    parameters held in registers: up to ``PLANE_GROUP``, fewer where that
    would leave fewer than ``TARGET_BLOCKS`` blocks, more where the
    groups would outnumber the grid's y limit."""
    vec4 = aligned and plane % 4 == 0
    cols = plane // 4 if vec4 else plane
    gx = max(1, -(-cols // THREADS))
    group = max(1, min(PLANE_GROUP, lead * gx // TARGET_BLOCKS),
                -(-lead // MAX_GRID_Y))
    return PlanesLaunch(vec4, group, (gx, max(1, -(-lead // group))))


def _aligned(ptrs, mask_ptr) -> bool:
    return all(p % 16 == 0 for p in ptrs) and (mask_ptr is None
                                               or mask_ptr % 4 == 0)


def ts_decay_cuda(sae: torch.Tensor, t_now, params,
                  v_tw: Optional[float] = None):
    """Launch the decay read on ``sae``'s device.  Returns ``v``, or
    ``(v, mask)`` when ``v_tw`` is given."""
    dev = sae.device
    _lib.check(sae, "sae", torch.float32, dev)
    out = torch.empty_like(sae)
    mask = None if v_tw is None else torch.empty(sae.shape, dtype=torch.bool,
                                                 device=dev)
    n = sae.numel()
    thr = 0.0 if v_tw is None else float(v_tw)
    if n:
        if params.varied:
            plane = params.tau1.shape
            if sae.shape[-len(plane):] != plane:
                raise ValueError(
                    f"parameter planes {tuple(plane)} do not match the SAE's "
                    f"trailing dims {tuple(sae.shape)}")
            for name, x in zip(params._fields, params):
                _lib.check(x, name, torch.float32, dev)
                if x.shape != plane:
                    raise ValueError(f"{name}: shape {tuple(x.shape)} != "
                                     f"{tuple(plane)}")
            cells = params.tau1.numel()
            ptrs = [sae.data_ptr(), out.data_ptr()] + [x.data_ptr()
                                                       for x in params]
            shape = planes_launch(n // cells, cells,
                                  _aligned(ptrs, _lib.ptr(mask)))
            _lib.launch("ts_decay", "ts_decay_planes", dev, sae.data_ptr(),
                        out.data_ptr(), _lib.ptr(mask), n // cells, cells,
                        float(t_now), *(x.data_ptr() for x in params), thr,
                        int(shape.vec4), shape.group, *shape.grid)
        else:
            _lib.launch("ts_decay", "ts_decay_uniform", dev, sae.data_ptr(),
                        out.data_ptr(), _lib.ptr(mask), n, float(t_now),
                        *(float(x) for x in params), thr)
    return out if mask is None else (out, mask)


def gate_taus() -> list:
    """The time constants the division gate runs over every dividend:
    both constants of the 20 fF fit and of the sweep's other default
    cmem (10 fF), the ideal 5 ms and 24 ms surfaces (whose second
    constant is 1.0, a power of two), the 1e-9 s clamp, and a significand
    of all ones."""
    from repro_torch.core import edram, representations

    fits = [edram.decay_params_for_cmem(c) for c in (20e-15, 10e-15)]
    taus = [float(t) for p in fits for t in (p.tau1, p.tau2)]
    taus += [float(representations.edram_ideal_params(t).tau1)
             for t in (0.005, 0.024)]
    return taus + [1.0, 1e-9, 1.9999998807907104]


def division_gate(device, tau=None, count: int = 1 << 32, seed: int = 0):
    """The card check of the decay's corrected-reciprocal quotient
    (``csrc/decay.cuh``) against the ``__fdiv_rn`` arithmetic, on
    ``v = e^(x/tau1) + e^(x/tau2)``.  With ``tau``: the first ``count``
    float bit patterns (all 2^32 by default) as the dividend ``x``, the
    uniform form's constants with ``tau`` as both time constants (its
    reciprocal taken on the host); without: ``count`` dividends and
    pairs of positive time constants drawn from ``seed`` (clamped at
    1e-9 s, reciprocals taken on the card).  Returns
    (decay values that differ bitwise, quotients that differ).  Not a
    path kernel: counts no launch."""
    lib, _ = _lib.library()
    mode, tau = (1, 1.0) if tau is None else (0, float(tau))
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = lib.decay_division_gate(
            mode, 1.0, tau, 1.0, tau, 0.0, seed, count,
            counts.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"decay_division_gate: CUDA error {err}")
    return tuple(int(x) for x in counts.cpu())
