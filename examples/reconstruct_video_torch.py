"""Event-to-video reconstruction (paper Sec. IV-E) on the PyTorch port:
analog TS -> UNet -> intensity frames, SSIM against paired ground truth.
The port's counterpart of ``examples/reconstruct_video.py``: the same
data, keys, training and output lines (``repro_torch.train.recon``), on
the CUDA device unless ``--device`` names another.

    PYTHONPATH=src python examples/reconstruct_video_torch.py --steps 80
    PYTHONPATH=src python examples/reconstruct_video_torch.py --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.train import recon


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    return recon.run(args.steps, args.device, log=print)


if __name__ == "__main__":
    main()
