"""Streaming denoise on the PyTorch port: a long event stream with
windowed chunking and the 2D-vs-3D fidelity comparison (the half-select
story of paper Fig. 4).  The port's counterpart of
``examples/denoise_stream.py``: the same stream, windows, arrays and
printed lines, on the CUDA device unless ``--device`` names another.

    PYTHONPATH=src python examples/denoise_stream_torch.py
    PYTHONPATH=src python examples/denoise_stream_torch.py --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import prng, stcf
from repro_torch.core import time_surface as ts
from repro_torch.core.isc_array import ISCArray
from repro_torch.device import resolve_device
from repro_torch.events import datasets, pipeline

H, W = 64, 86
WINDOW_S = 0.02


def main(argv=None) -> dict:
    """Returns each mode's stacked window masks (``masks``, {mode: (K, P,
    H, W) bool}), the full-stream ``support`` and its ``auc``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    dev = resolve_device(ap.parse_args(argv).device)

    stream = datasets.dnd21_like("driving", h=H, w=W, duration=0.3, seed=4)
    print(f"driving-like stream: {stream.n} events")

    # window the stream: each event is written exactly once (hardware
    # semantics)
    chunks = pipeline.window_chunks(stream, window_s=WINDOW_S,
                                    capacity_per_window=4096, device=dev)
    n_win = chunks.x.shape[0]

    masks = {}
    for mode in ("3d", "2d"):
        arr = ISCArray(h=H, w=W, mode=mode, device=dev)
        state = arr.init(prng.PRNGKey(0))
        per_window = []
        for i in range(n_win):
            state = arr.write(state, ts.EventBatch(*(f[i] for f in chunks)))
            per_window.append(arr.read_mask(state, (i + 1) * WINDOW_S))
        masks[mode] = torch.stack(per_window)
        active = float(masks[mode].float().mean())
        print(f"mode={mode}: mean within-window occupancy {active:.4f}")

    # event-level ROC on the full stream (analog comparator path)
    cap = 1 << int(np.ceil(np.log2(stream.n)))
    batch = pipeline.to_event_batch(stream, cap, device=dev)
    labels = torch.from_numpy(np.pad(stream.is_signal,
                                     (0, cap - stream.n))).to(dev)
    sup, _ = stcf.stcf_chunked(batch, H, W, chunk=128, mode="edram")
    _, _, auc = stcf.roc_curve(sup, labels, batch.valid)
    print(f"streaming STCF AUC (analog): {float(auc):.3f}")
    return dict(masks=masks, support=sup, auc=float(auc))


if __name__ == "__main__":
    main()
