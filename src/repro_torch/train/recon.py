"""The reconstruction protocol (paper Sec. IV-E) on the port: analog TS ->
UNet -> intensity frames, SSIM against paired ground truth.

The counterpart of ``examples/reconstruct_video.py``'s protocol: the same
data (``davis_like`` scenes, per-cell decay planes from ``PRNGKey(1)``),
weights (``unet_defs(1, width)`` from ``PRNGKey(0)``), optimizer (AdamW on
``Schedule(3e-3, warmup_steps=5, decay_steps=steps)``), batches
(``default_rng(0).choice``) and L1 loss.  ``examples/reconstruct_video_torch.py``
is its command line.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import edram, prng
from repro_torch.core import time_surface as ts
from repro_torch.device import resolve_device
from repro_torch.events import datasets
from repro_torch.models import module as M
from repro_torch.models.unet import ssim, unet_apply, unet_defs
from repro_torch.train.grad import value_and_grad
from repro_torch.train.optimizer import Schedule, adamw


class Pairs(NamedTuple):
    """The protocol's data, on one device: per ground-truth frame, the SAE
    of every event before it and its eDRAM read, and the frame."""

    x: torch.Tensor       # (N, H, W, 1) TS frames, volts
    y: torch.Tensor       # (N, H, W) frames scaled to a maximum of 1
    sae: torch.Tensor     # (N, 1, H, W) the SAEs read into ``x``
    t_read: torch.Tensor  # (N,) float32 read time of each SAE
    decay: edram.DecayParams  # (1, H, W) per-cell planes
    n_train: int          # the first 3/4 train, the rest are held out


def make_pairs(h: int = 48, w: int = 48, n_scenes: int = 3,
               duration: float = 0.4, seed: int = 9, device=None) -> Pairs:
    """``davis_like`` scenes read through per-cell decay planes drawn from
    ``PRNGKey(1)``, on ``device`` (default: the CUDA device)."""
    dev = resolve_device(device)
    scenes = datasets.davis_like(n_scenes=n_scenes, h=h, w=w,
                                 duration=duration, seed=seed)
    decay = edram.sample_variability(prng.PRNGKey(1, dev), (1, h, w),
                                     edram.decay_params_for_cmem())
    xs, ys, saes, times = [], [], [], []
    for s in scenes:
        for ft, frame in zip(s.frame_times, s.frames):
            m = s.t < ft
            ev = ts.EventBatch(*(torch.from_numpy(a).to(dev) for a in (
                s.x[m], s.y[m], s.t[m], s.p[m], np.ones(int(m.sum()), bool))))
            sae = ts.sae_update(ts.empty_sae(h, w, device=dev), ev)
            xs.append(ts.ts_edram(sae, float(ft), decay)[0])
            ys.append(frame / max(frame.max(), 1e-6))
            saes.append(sae)
            times.append(ft)
    y = torch.from_numpy(np.stack(ys).astype(np.float32)).to(dev)
    return Pairs(x=torch.stack(xs)[..., None], y=y, sae=torch.stack(saes),
                 t_read=torch.from_numpy(np.array(times, np.float32)).to(dev),
                 decay=decay, n_train=int(0.75 * len(xs)))


def l1_loss(params, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    return (unet_apply(params, xb) - yb).abs().mean()


def make_step(opt, loss=l1_loss, direct: bool = True):
    """One training step, the reference's jitted ``step``: ``(params,
    state, xb, yb, i) -> (params, state, loss, grads)``, by default on
    direct convolutions, which keep the reference's exact zeros where
    cuDNN's backward of the UNet does not (``train.grad``)."""
    loss_grad = value_and_grad(loss, direct=direct)

    def step(params, state, xb, yb, i):
        value, grads = loss_grad(params, xb, yb)
        params, state = opt.update(grads, state, params, i)
        return params, state, value, grads

    return step


def init(steps: int, width: int, device):
    """The UNet's weights from ``PRNGKey(0)``, AdamW on the protocol's
    schedule, and its state."""
    params = M.init_params(unet_defs(1, width=width), prng.PRNGKey(0),
                           device)
    opt = adamw(Schedule(3e-3, warmup_steps=5, decay_steps=steps))
    return params, opt, opt.init(params)


def jitter(params, m: int):
    """Run m's initial weights: ``params`` times (1 + 1e-7 N(0, 1)), the
    normals drawn on the CPU from seed m; run 0 is ``params`` itself."""
    if m == 0:
        return params
    g = torch.Generator().manual_seed(m)
    return M.unflatten({
        k: v * (1 + 1e-7 * torch.randn(v.shape, generator=g)).to(v.device)
        for k, v in M.flatten(params).items()})


@contextlib.contextmanager
def cpu_threads(n: int):
    """PyTorch's CPU thread count ``n`` for the block, restored after.  The
    CPU's reductions split their sums by thread, so the count moves a
    run's rounding, and the protocol, which parts from any 1e-7
    perturbation within ~6 steps, carries that into its held-out SSIM."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def batches(n_train: int, steps: int, batch: int):
    """The protocol's batch indices, ``default_rng(0).choice`` per step."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.choice(n_train, batch)) for _ in range(steps)]


def train(pairs: Pairs, steps: int, params, opt, state, batch: int = 16,
          log=None, loss=l1_loss, direct: bool = True):
    """The protocol's loop: ``steps`` AdamW steps on batches of the
    training pairs.  Returns (params, losses, the first step's grads);
    ``log`` gets the reference's line every 20 steps."""
    step = make_step(opt, loss, direct)
    losses, first_grads = [], None
    for i, idx in enumerate(batches(pairs.n_train, steps, batch)):
        idx = idx.to(pairs.x.device)
        params, state, value, grads = step(params, state, pairs.x[idx],
                                           pairs.y[idx], i)
        losses.append(value)
        if i == 0:
            first_grads = grads
        if log is not None and i % 20 == 0:
            log(f"step {i:3d} L1 {float(value):.4f}")
    return params, losses, first_grads


def held_out_ssim(params, pairs: Pairs) -> float:
    with torch.no_grad():
        return float(ssim(unet_apply(params, pairs.x[pairs.n_train:]),
                          pairs.y[pairs.n_train:]))


def run(steps: int = 80, device=None, width: int = 12, m: int = 0,
        pairs: Pairs = None, log=None, loss=l1_loss,
        direct: bool = True) -> dict:
    """The whole protocol once: run ``m``'s weights (``jitter``) trained
    ``steps`` steps on ``pairs`` (default: the example's 48x48 data) and
    the held-out SSIM.  ``log`` gets the example's lines."""
    dev = resolve_device(device)
    pairs = make_pairs(device=dev) if pairs is None else pairs
    if log is not None:
        n, n_tr = len(pairs.x), pairs.n_train
        log(f"pairs: {n} ({n - n_tr} held out)")
    params, opt, _ = init(steps, width, dev)
    params = jitter(params, m)
    params, losses, first_grads = train(pairs, steps, params, opt,
                                        opt.init(params), log=log, loss=loss,
                                        direct=direct)
    held = held_out_ssim(params, pairs)
    if log is not None:
        log(f"held-out SSIM: {held:.3f}")
    return dict(ssim=held, losses=[float(v) for v in losses],
                first_grads=first_grads, params=params)
