"""Quickstart on the PyTorch port: events -> 3DS-ISC analog time surface
-> STCF denoise.  The port's counterpart of ``examples/quickstart.py``:
the same stream, array, cell draws, filter and printed lines, on the CUDA
device unless ``--device`` names another.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import prng, stcf
from repro_torch.core.isc_array import ISCArray
from repro_torch.device import resolve_device
from repro_torch.events import datasets, pipeline

H, W, CAP = 64, 86, 8192


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1) a synthetic DND21-like event stream (signal + 5 Hz/px noise)
    stream = datasets.dnd21_like("hotel_bar", h=H, w=W, duration=0.2, seed=0)
    print(f"events: {stream.n}  (signal fraction "
          f"{stream.is_signal.mean():.2f})")

    # 2) the ISC array: write events (O(E)), read the decayed surface (lazy)
    arr = ISCArray(h=H, w=W, mode="3d", device=dev)  # 6T-1C, 20 fF, MC spread
    state = arr.init(prng.PRNGKey(0))
    batch = pipeline.to_event_batch(stream, CAP, device=dev)
    state = arr.write(state, batch)
    surface = arr.read(state, t_now=0.2)          # analog voltages, volts
    print(f"surface: {tuple(surface.shape)}, V in "
          f"[{float(surface.min()):.2f}, {float(surface.max()):.2f}]")

    # 3) STCF denoise with the comparator threshold V_tw (Fig. 10b)
    support, _ = stcf.stcf_chunked(batch, H, W, chunk=128, mode="edram")
    labels = torch.from_numpy(np.pad(stream.is_signal[:CAP],
                                     (0, max(0, CAP - stream.n)))).to(dev)
    _, _, auc = stcf.roc_curve(support, labels, batch.valid)
    print(f"STCF denoise AUC (analog TS): {float(auc):.3f}")

    # 4) same filter on the ideal digital TS -- the paper's equivalence claim
    support_i, _ = stcf.stcf_chunked(batch, H, W, chunk=128, mode="ideal")
    _, _, auc_i = stcf.roc_curve(support_i, labels, batch.valid)
    print(f"STCF denoise AUC (ideal TS):  {float(auc_i):.3f}  "
          f"(gap {abs(float(auc_i) - float(auc)):.4f})")
    return dict(support=support, support_i=support_i, surface=surface,
                auc=float(auc), auc_i=float(auc_i))


if __name__ == "__main__":
    main()
