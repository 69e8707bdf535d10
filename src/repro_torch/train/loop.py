"""LM training loop: a step with microbatch gradient accumulation,
checkpointing (atomic, optionally asynchronous), preemption capture and a
straggler watchdog.

The port of ``repro.train.loop`` on one device.  The step is eager
PyTorch: each microbatch's backward adds its gradients into one float32
accumulator as autograd produces them (``grad.value_and_grad(...,
into=)``), and the optimizer updates the parameters and its state in
place (``Optimizer.update_``) -- the port's counterpart of the
reference's ``jit(..., donate_argnums=(0, 1))``, without which a
2.8 B-parameter model's old and new parameters, moments and gradients
would not fit one 80 GB card together.  The layers are differentiated
one by one (``transformer.unstack_layers``): the gradient of the stacked
tensor is its layers' gradients side by side, as the reference's scan
stacks them.

A mesh raises ``NotImplementedError`` (model sharding is ROADMAP.md,
queue 1).  ``fsdp`` and ``fsdp_gather_once`` change nothing without a
mesh, as in the reference, which shards only over one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.device import f32, resolve_device
from repro_torch.distributed import fault
from repro_torch.models import module as M
from repro_torch.models import transformer as T
from repro_torch.train import compression
from repro_torch.train.grad import value_and_grad
from repro_torch.train.optimizer import (Optimizer, Schedule, _leafwise,
                                         _map, make_optimizer)

_METRICS = ("loss", "lb_loss", "z_loss")


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    async_ckpt: bool = True
    lr: float = 3e-4
    warmup_steps: int = 20
    decay_steps: int = 1000
    grad_compression: Optional[str] = None   # None | int8 | topk
    straggler_threshold: float = 3.0


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh: repro_torch trains on one device; model sharding is "
            "ROADMAP.md, queue 1")


def make_grad_fn(cfg: ModelConfig, mesh=None) -> Callable:
    """``(params, tokens, labels, embeds=None) -> (grads, metrics)``: the
    gradient of ``loss_fn`` averaged over ``cfg.n_microbatches`` strided
    microbatches (microbatch i takes rows i, i + n, i + 2n, ... of the
    tokens, the labels and a frontend's ``embeds``), summed from zeros in
    ``cfg.accum_dtype`` and divided by n in float32, and the metrics
    averaged the same way, as the reference's step computes them."""
    _refuse_mesh(mesh)
    acc_dt = torch.bfloat16 if cfg.accum_dtype == "bfloat16" else torch.float32

    def lf(p, tokens, labels, embeds):
        return T.loss_fn(p, tokens, labels, cfg, embeds=embeds)

    def grads_and_metrics(params, tokens, labels, embeds=None):
        n = max(cfg.n_microbatches, 1)
        b = tokens.shape[0]
        if b % n:
            raise ValueError(f"batch {b} is not a multiple of "
                             f"n_microbatches = {n}")
        # one microbatch: the reference takes its gradients as they are,
        # which equal zeros + gradients in float32
        dt = acc_dt if n > 1 else torch.float32
        acc = _map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device),
                   params)
        into = T.unstack_layers(acc) if dt == torch.float32 else None
        vg = value_and_grad(lf, has_aux=True, into=into)
        layers = T.unstack_layers(params)
        dev = tokens.device
        mets = {k: f32(0.0, dev) for k in _METRICS}
        for i in range(n):
            (_, m), g = vg(layers, tokens[i::n], labels[i::n],
                           None if embeds is None else embeds[i::n])
            if n == 1:
                return acc, m
            if into is None:
                for a, gg in _leafwise(T.unstack_layers(acc), g):
                    a.add_(gg.to(dt))
            mets = {k: mets[k] + m[k] for k in _METRICS}
        # the reference divides by the constant n under jit, which XLA
        # turns into a product with its float32 reciprocal
        inv = f32(1.0, dev) / f32(n, dev)
        if dt == torch.float32:
            grads = _map(lambda a: a.mul_(inv), acc)
        else:
            grads = _map(lambda a: a.to(torch.float32) * inv, acc)
        return grads, {k: v * inv for k, v in mets.items()}

    return grads_and_metrics


def make_train_step(cfg: ModelConfig, opt: Optimizer, mesh=None
                    ) -> Callable:
    """``(params, opt_state, tokens, labels, step, embeds=None) ->
    (params, opt_state, metrics)``.  The parameters and state are updated in place and
    returned (the inputs are consumed, as the reference's donated buffers
    are)."""
    grads_and_metrics = make_grad_fn(cfg, mesh)

    def train_step(params, opt_state, tokens, labels, step, embeds=None):
        grads, metrics = grads_and_metrics(params, tokens, labels, embeds)
        opt.update_(grads, opt_state, params, step)
        return params, opt_state, metrics

    return train_step


class Trainer:
    """Trains ``cfg`` from ``init_params`` on the reference's
    ``PRNGKey(seed)`` stream, on ``device`` (default: the CUDA device;
    raises when there is none)."""

    def __init__(self, cfg: ModelConfig,
                 tcfg: TrainerConfig = TrainerConfig(), mesh=None,
                 seed: int = 0, device=None):
        _refuse_mesh(mesh)
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.device = resolve_device(device)
        sched = Schedule(tcfg.lr, tcfg.warmup_steps, tcfg.decay_steps)
        opt = make_optimizer(cfg.optimizer, sched)
        if tcfg.grad_compression:
            opt = compression.compressed(opt, tcfg.grad_compression)
        self.opt = opt
        self.params = M.init_params(T.param_defs(cfg), prng.PRNGKey(seed),
                                    self.device)
        self.opt_state = opt.init(self.params)
        self.step = 0
        self._step_fn = make_train_step(cfg, opt, mesh)
        self.ckpt = Checkpointer(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
        self.watchdog = fault.StragglerWatchdog(tcfg.straggler_threshold)
        self.preempt = None
        self.history: list = []

    def maybe_restore(self, pipeline=None) -> bool:
        """Load the latest checkpoint into the parameters and optimizer
        state (leaf by leaf, in place); False when there is none."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        _, extra = self.ckpt.restore((self.params, self.opt_state),
                                     device=self.device, into=True)
        self.step = int(extra.get("step", 0))
        if pipeline is not None and "pipeline" in extra:
            pipeline.load_state_dict(extra["pipeline"])
        return True

    def save(self, pipeline=None, block: bool = True) -> None:
        if self.ckpt is None:
            return
        extra = {"step": self.step}
        if pipeline is not None:
            extra["pipeline"] = pipeline.state_dict()
        self.ckpt.save(self.step, (self.params, self.opt_state), extra,
                       block=block)

    def train(self, data_iter, n_steps: int, pipeline=None,
              install_preemption_handler: bool = False) -> Dict[str, Any]:
        if install_preemption_handler:
            self.preempt = fault.PreemptionHandler()
        target = self.step + n_steps
        while self.step < target:
            tokens, labels = (torch.from_numpy(np.asarray(v)).to(self.device)
                              for v in next(data_iter))
            t0 = time.time()
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, tokens, labels, self.step)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            straggler = self.watchdog.observe(self.step, dt)
            self.history.append({"step": self.step, "dt": dt,
                                 "straggler": straggler, **metrics})
            self.step += 1
            if self.ckpt and self.step % self.tcfg.ckpt_every == 0:
                self.save(pipeline, block=not self.tcfg.async_ckpt)
            if self.preempt is not None and self.preempt.should_stop:
                self.save(pipeline, block=True)
                break
        if self.ckpt:
            self.ckpt.wait()
        return {"final_step": self.step, "history": self.history}
