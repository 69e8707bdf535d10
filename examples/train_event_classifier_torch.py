"""Event classification with an LM over ISC time surfaces, on the PyTorch
port: events -> SAE -> eDRAM time surface -> patch embeddings -> a dense
decoder -> class logits.  The port's counterpart of
``examples/train_event_classifier.py``: the same data, keys, model,
optimizer and output lines (``repro_torch.train.event_lm``), on the CUDA
device unless ``--device`` names another.

    PYTHONPATH=src python examples/train_event_classifier_torch.py --steps 30
    PYTHONPATH=src python examples/train_event_classifier_torch.py --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.train import event_lm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--classes", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    return event_lm.run(args.steps, args.device, args.d_model, args.layers,
                        args.classes, args.batch, log=print)


if __name__ == "__main__":
    main()
