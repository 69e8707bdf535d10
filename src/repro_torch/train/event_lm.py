"""The event-classification LM protocol of
``examples/train_event_classifier.py`` on the port: the paper's time
surface as an LM frontend.

Saccading-glyph event streams (``datasets.nmnist_like``) become one SAE
each (``time_surface.sae_update``); ``frontends.event_ts_frontend``
reads them through the eDRAM decay at t = 0.2 s and cuts them into 8x8
patch embeddings, which a dense decoder (``transformer.forward`` with
``embeds``) reads before one [CLS]-style token whose logits over the
first ``classes`` entries are the prediction.  AdamW (lr 1e-3, 10
warm-up steps) trains the decoder and the frontend together on batches
drawn with ``default_rng(0).choice``; every fifth stream is held out.
Weights come from the reference's ``PRNGKey(0)``, for the LM and for
the frontend alike, as the example draws them.  Everything runs in
float32 on ``device`` (default: the CUDA device).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import edram, prng
from repro_torch.core import time_surface as ts
from repro_torch.device import resolve_device
from repro_torch.events import datasets, pipeline
from repro_torch.models import frontends
from repro_torch.models import module as M
from repro_torch.models import transformer as T
from repro_torch.train.grad import value_and_grad
from repro_torch.train.optimizer import Schedule, adamw

HW = 48
PATCH = 8
T_READ = 0.2


def config(d_model: int = 128, layers: int = 4,
           classes: int = 6) -> ModelConfig:
    """The example's backbone: ``--d-model``, ``--layers``, ``--classes``."""
    return ModelConfig(
        name="event-lm", family="dense",
        n_layers=layers, d_model=d_model,
        n_heads=max(4, d_model // 64), n_kv_heads=max(2, d_model // 128),
        head_dim=32, d_ff=4 * d_model, vocab=classes + 2,
        frontend="event_ts", frontend_seq=(HW // PATCH) ** 2,
        dtype="float32", remat=False,
    )


def dataset(classes: int, device):
    """(SAEs (N, 1, 48, 48), labels (N,) int64, held-out count N // 5)."""
    streams = datasets.nmnist_like(n_classes=classes, per_class=5, h=HW,
                                   w=HW, duration=0.2, seed=1)
    saes = torch.stack([
        ts.sae_update(ts.empty_sae(HW, HW, device=device),
                      pipeline.to_event_batch(s, 8192, device))
        for s in streams])
    labels = torch.tensor([s.label for s in streams], device=device)
    return saes, labels, len(streams) // 5


def init(cfg: ModelConfig, device) -> dict:
    key = prng.PRNGKey(0)
    return {"lm": M.init_params(T.param_defs(cfg), key, device),
            "frontend": M.init_params(
                frontends.event_ts_frontend_defs(cfg, patch=PATCH), key,
                device)}


def apply(params, saes, labels, cfg: ModelConfig, classes: int):
    """(mean NLL of the labels, {"cls": (B, classes) logits})."""
    embeds = frontends.event_ts_frontend(
        params["frontend"], saes, T_READ, cfg,
        decay=edram.decay_params_for_cmem(), patch=PATCH)
    tokens = torch.full((saes.shape[0], 1), cfg.vocab - 1, dtype=torch.int32,
                        device=saes.device)
    logits, _ = T.forward(params["lm"], tokens, cfg, embeds=embeds)
    cls = logits[:, -1, :classes]
    lp = torch.log_softmax(cls, dim=-1)
    loss = -torch.gather(lp, 1, labels[:, None]).mean()
    return loss, {"cls": cls}


def run(steps: int = 30, device=None, d_model: int = 128, layers: int = 4,
        classes: int = 6, batch: int = 8, log=None) -> dict:
    """The example once.  ``log`` gets its lines.  Returns the losses, the
    held-out accuracy, the seconds per step and the parameters."""
    dev = resolve_device(device)
    cfg = config(d_model, layers, classes)
    if log is not None:
        log(f"backbone params: {cfg.n_params() / 1e6:.1f}M "
            f"({cfg.n_layers}L d={cfg.d_model}) on {dev}")
    params = init(cfg, dev)
    saes, labels, n_test = dataset(classes, dev)
    if log is not None:
        log(f"streams: {len(labels)} ({n_test} held out)")
    opt = adamw(Schedule(1e-3, warmup_steps=10, decay_steps=steps))
    state = opt.init(params)
    grad_fn = value_and_grad(
        lambda p, x, y: apply(p, x, y, cfg, classes), has_aux=True)
    rng = np.random.default_rng(0)
    tr_idx = np.arange(n_test, len(labels))
    losses, t0 = [], time.perf_counter()
    for i in range(steps):
        sel = torch.from_numpy(rng.choice(tr_idx, batch)).to(dev)
        (loss, _), grads = grad_fn(params, saes[sel], labels[sel])
        opt.update_(grads, state, params, i)
        losses.append(float(loss))
        if log is not None and (i % 10 == 0 or i == steps - 1):
            log(f"step {i:4d} loss {losses[-1]:.3f} "
                f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)")
    s_per_step = (time.perf_counter() - t0) / max(steps, 1)
    with torch.no_grad():
        _, aux = apply(params, saes[:n_test], labels[:n_test], cfg, classes)
    acc = float((aux["cls"].argmax(-1) == labels[:n_test]).float().mean())
    if log is not None:
        log(f"held-out accuracy after {steps} steps: {acc:.2f}")
    return dict(losses=losses, accuracy=acc, s_per_step=s_per_step,
                params=params, cfg=cfg)
