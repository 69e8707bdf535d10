"""Synthetic stand-ins for the paper's datasets (offline environment).

  * ``dnd21_like(kind)``      — denoise streams with signal/noise GT (Fig. 10)
  * ``nmnist_like()``         — K-class saccadic glyph streams (Table II)
  * ``davis_like()``          — event streams + paired GT frames (Table III)

Deterministic given the seed.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.events import synthetic as syn


def dnd21_like(
    kind: str = "hotel_bar",
    h: int = 96,
    w: int = 128,
    duration: float = 0.3,
    noise_hz: float = 5.0,
    seed: int = 0,
) -> syn.EventStream:
    """A denoise benchmark stream: clean scene events + 5 Hz/px noise."""
    rng = np.random.default_rng(seed)
    if kind == "hotel_bar":
        scene = syn.hotel_bar_scene(h, w, rng)
    elif kind == "driving":
        scene = syn.driving_scene(h, w, rng)
    else:
        raise ValueError(kind)
    return syn.dvs_from_intensity(
        scene, h, w, duration, rng, noise_hz=noise_hz, fps=500.0
    )


def nmnist_like(
    n_classes: int = 10,
    per_class: int = 4,
    h: int = 64,
    w: int = 64,
    duration: float = 0.3,
    noise_hz: float = 1.0,
    seed: int = 0,
) -> List[syn.EventStream]:
    """Classification streams: one saccading glyph per stream."""
    streams = []
    for c in range(n_classes):
        for i in range(per_class):
            rng = np.random.default_rng(seed * 100003 + c * 97 + i)
            scene = syn.moving_glyph_scene(h, w, c, rng)
            s = syn.dvs_from_intensity(
                scene, h, w, duration, rng, noise_hz=noise_hz, fps=500.0
            )
            s.label = c
            streams.append(s)
    return streams


def davis_like(
    n_scenes: int = 3,
    h: int = 64,
    w: int = 64,
    duration: float = 0.4,
    frame_fps: float = 25.0,
    seed: int = 0,
) -> List[syn.EventStream]:
    """Reconstruction streams with paired ground-truth APS-style frames."""
    out = []
    for i in range(n_scenes):
        rng = np.random.default_rng(seed * 7919 + i)
        scene = (
            syn.hotel_bar_scene(h, w, rng)
            if i % 2 == 0
            else syn.driving_scene(h, w, rng, speed_px_s=80.0)
        )
        s = syn.dvs_from_intensity(scene, h, w, duration, rng, fps=500.0)
        ft = np.arange(1, int(duration * frame_fps) + 1, dtype=np.float32) / frame_fps
        s.frames = syn.render_frames(scene, ft)
        s.frame_times = ft
        out.append(s)
    return out
