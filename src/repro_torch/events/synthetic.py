"""v2e-style synthetic event-camera simulator (host-side, numpy).

The paper's datasets (DND21, N-MNIST, N-Caltech101, CIFAR10-DVS, DVS128,
DAVIS240C) are not available offline, so we generate labeled event streams
with the same physics the v2e tool [56] uses: per-pixel log-intensity
reference levels, +-theta threshold crossings with timestamp interpolation,
plus Poisson background noise at a configurable rate (the DND21 protocol
injects 5 Hz/px [51]).  Every emitted event carries a ground-truth
signal/noise flag, and paired ground-truth intensity frames are returned
for the reconstruction task.

This module is intentionally numpy (the host data path of the framework);
the JAX side consumes fixed-size `EventBatch` buffers produced by
``events.pipeline``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class EventStream:
    x: np.ndarray          # (N,) int32
    y: np.ndarray          # (N,) int32
    t: np.ndarray          # (N,) float32 seconds, sorted
    p: np.ndarray          # (N,) int32 {0,1}
    is_signal: np.ndarray  # (N,) bool ground truth (False = injected noise)
    h: int = 0
    w: int = 0
    label: int = -1        # class label for classification streams
    frames: Optional[np.ndarray] = None   # (F, H, W) float32 GT intensity
    frame_times: Optional[np.ndarray] = None  # (F,) float32

    @property
    def n(self) -> int:
        return int(self.x.shape[0])

    def sorted(self) -> "EventStream":
        o = np.argsort(self.t, kind="stable")
        return self.take(o)

    def take(self, idx) -> "EventStream":
        """Select events by index/mask (other fields pass through)."""
        return dataclasses.replace(
            self, x=self.x[idx], y=self.y[idx], t=self.t[idx],
            p=self.p[idx], is_signal=self.is_signal[idx],
        )

    def window(self, lo: float, hi: float) -> "EventStream":
        """Events with t in [lo, hi) — the burst/window slicing every
        streaming driver uses."""
        return self.take((self.t >= lo) & (self.t < hi))


# ----------------------------------------------------------------------------
# Scene intensity fields
# ----------------------------------------------------------------------------

_GLYPHS = {  # 5x7 bitmap font for digit-like classification classes
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00110", "01000", "10000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def glyph_bitmap(cls: int, scale: int = 6) -> np.ndarray:
    rows = _GLYPHS[cls % 10]
    bm = np.array([[int(c) for c in row] for row in rows], np.float32)
    return np.kron(bm, np.ones((scale, scale), np.float32))


def moving_glyph_scene(
    h: int, w: int, cls: int, rng: np.random.Generator,
    saccade_hz: float = 10.0, scale: int = 6,
) -> Callable[[float], np.ndarray]:
    """N-MNIST-like: a bright glyph under saccadic motion on dark background."""
    bm = glyph_bitmap(cls, scale)
    gh, gw = bm.shape
    if gh > h - 2 or gw > w - 2:  # shrink to fit small canvases
        scale = max(1, min((h - 2) // 7, (w - 2) // 5))
        bm = glyph_bitmap(cls, scale)
        gh, gw = bm.shape
    cx0 = rng.uniform(0, max(w - gw, 1))
    cy0 = rng.uniform(0, max(h - gh, 1))
    ax = rng.uniform(4, 10)
    ay = rng.uniform(4, 10)
    phase = rng.uniform(0, 2 * np.pi)

    def intensity(t: float) -> np.ndarray:
        img = np.full((h, w), 0.08, np.float32)
        dx = int(cx0 + ax * np.sin(2 * np.pi * saccade_hz * t + phase))
        dy = int(cy0 + ay * np.sin(4 * np.pi * saccade_hz * t))
        dx = int(np.clip(dx, 0, w - gw))
        dy = int(np.clip(dy, 0, h - gh))
        img[dy : dy + gh, dx : dx + gw] += bm * 0.9
        return img

    return intensity


def driving_scene(
    h: int, w: int, rng: np.random.Generator, speed_px_s: float = 120.0,
    block: int = 8,
) -> Callable[[float], np.ndarray]:
    """DND21-'driving'-like: a translating piecewise-constant scene.

    Block-constant "buildings/road" texture => events fire on the moving
    *edges* only (like real driving footage), not on every pixel.
    """
    bh, bw = h // block + 2, (2 * w) // block + 2
    blocks = rng.uniform(0.1, 1.0, size=(bh, bw)).astype(np.float32)
    tex = np.kron(blocks, np.ones((block, block), np.float32))[: h, : 2 * w]

    def intensity(t: float) -> np.ndarray:
        shift = int(speed_px_s * t) % w
        return tex[:, shift : shift + w]

    return intensity


def hotel_bar_scene(
    h: int, w: int, rng: np.random.Generator,
) -> Callable[[float], np.ndarray]:
    """DND21-'hotel-bar'-like: static background, a few moving objects."""
    bg = rng.uniform(0.3, 0.5, size=(h, w)).astype(np.float32)
    n_obj = 3
    obj = [
        dict(
            cx=rng.uniform(0.2 * w, 0.8 * w), cy=rng.uniform(0.2 * h, 0.8 * h),
            vx=rng.uniform(-60, 60), vy=rng.uniform(-30, 30),
            r=rng.uniform(4, 9), amp=rng.uniform(0.4, 0.6),
        )
        for _ in range(n_obj)
    ]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def intensity(t: float) -> np.ndarray:
        img = bg.copy()
        for o in obj:
            cx = (o["cx"] + o["vx"] * t) % w
            cy = (o["cy"] + o["vy"] * t) % h
            d2 = (xx - cx) ** 2 + (yy - cy) ** 2
            img += o["amp"] * np.exp(-d2 / (2 * o["r"] ** 2)).astype(np.float32)
        return img

    return intensity


# ----------------------------------------------------------------------------
# DVS physics: threshold crossings of log intensity (v2e-style)
# ----------------------------------------------------------------------------

def dvs_from_intensity(
    intensity: Callable[[float], np.ndarray],
    h: int,
    w: int,
    duration: float,
    rng: np.random.Generator,
    theta: float = 0.2,
    fps: float = 1000.0,
    noise_hz: float = 0.0,
    eps: float = 1e-3,
    max_events_per_px_per_step: int = 4,
) -> EventStream:
    """Emit +-theta log-intensity crossings with linear time interpolation.

    Each pixel holds a reference level L_ref; when |L - L_ref| crosses
    k*theta, k events are emitted at interpolated timestamps (capped).
    Background noise is added as a Poisson process at ``noise_hz`` per pixel
    with random polarity — the DND21 injection protocol.
    """
    n_steps = int(round(duration * fps))
    dt = 1.0 / fps
    l_ref = np.log(intensity(0.0) + eps)
    xs: List[np.ndarray] = []
    ys: List[np.ndarray] = []
    tss: List[np.ndarray] = []
    ps: List[np.ndarray] = []

    for s in range(1, n_steps + 1):
        t1 = s * dt
        l1 = np.log(intensity(t1) + eps)
        diff = l1 - l_ref
        k = np.floor(np.abs(diff) / theta).astype(np.int32)
        k = np.minimum(k, max_events_per_px_per_step)
        fired = k > 0
        if fired.any():
            yy, xx = np.nonzero(fired)
            kk = k[yy, xx]
            pol = (diff[yy, xx] > 0).astype(np.int32)
            # emit kk events per pixel at interpolated sub-step times
            reps = np.repeat(np.arange(len(yy)), kk)
            order = np.concatenate([np.arange(c) for c in kk]) if len(kk) else np.zeros(0, int)
            frac = (order + 1).astype(np.float32) / (kk[reps] + 1).astype(np.float32)
            tss.append((t1 - dt) + frac * dt)
            xs.append(xx[reps].astype(np.int32))
            ys.append(yy[reps].astype(np.int32))
            ps.append(pol[reps])
            l_ref[yy, xx] += np.sign(diff[yy, xx]) * kk * theta
    n_sig = sum(len(a) for a in xs)

    if noise_hz > 0:
        lam = noise_hz * h * w * duration
        n_noise = rng.poisson(lam)
        xs.append(rng.integers(0, w, n_noise).astype(np.int32))
        ys.append(rng.integers(0, h, n_noise).astype(np.int32))
        tss.append(rng.uniform(0, duration, n_noise).astype(np.float32))
        ps.append(rng.integers(0, 2, n_noise).astype(np.int32))
    else:
        n_noise = 0

    x = np.concatenate(xs) if xs else np.zeros(0, np.int32)
    y = np.concatenate(ys) if ys else np.zeros(0, np.int32)
    t = np.concatenate(tss).astype(np.float32) if tss else np.zeros(0, np.float32)
    p = np.concatenate(ps).astype(np.int32) if ps else np.zeros(0, np.int32)
    is_signal = np.concatenate(
        [np.ones(n_sig, bool), np.zeros(n_noise, bool)]
    )
    return EventStream(x=x, y=y, t=t, p=p, is_signal=is_signal, h=h, w=w).sorted()


def render_frames(
    intensity: Callable[[float], np.ndarray], times: np.ndarray
) -> np.ndarray:
    return np.stack([intensity(float(t)) for t in times]).astype(np.float32)
