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

Over a mesh (``distributed.mesh.ProcessMesh``: one process per device, each
running the same ``Trainer``) every rank holds its block of each leaf
of the parameters, the optimizer state and the gradient accumulator
(``distributed.sharding.placements``), drawn from the same
``PRNGKey(seed)`` stream with only the block's counters.  Every rank is
handed the whole batch; microbatch i takes every n-th row, as on one
device, then each rank its block of those rows (the data axes).  Where
the D data ranks do not divide a microbatch's r rows, each rank's block
holds ceil(r / D) rows, filled up with pad rows as GSPMD pads a dim: every
rank runs the same shapes and collectives, and the loss counts the real
rows only (``transformer.loss_fn``'s ``row_weights``).  An expert layer
refuses such a microbatch, as the reference's ``shard_map`` does.  Each
layer gathers its FSDP leaves inside its checkpoint, and their
gradients reduce-scatter into the accumulator, which stays in the FSDP
layout; the leaves no data axis splits sum their gradients over the data
ranks once a step.  With ``fsdp_gather_once`` the leaves are gathered
once a step instead, the gradients accumulate gathered, and one
reduce-scatter returns them.  The metrics are the global batch's.
``fsdp`` and ``fsdp_gather_once`` change nothing without a mesh, as in
the reference.
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
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import check_mesh
from repro_torch.models import module as M
from repro_torch.models import moe as MOE
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


def make_grad_fn(cfg: ModelConfig, mesh=None) -> Callable:
    """``(params, tokens, labels, embeds=None) -> (grads, metrics)``: the
    gradient of ``loss_fn`` averaged over ``cfg.n_microbatches`` strided
    microbatches (microbatch i takes rows i, i + n, i + 2n, ... of the
    tokens, the labels and a frontend's ``embeds``), summed from zeros in
    ``cfg.accum_dtype`` and divided by n in float32, and the metrics
    averaged the same way, as the reference's step computes them.  Over
    a mesh ``params`` are this rank's blocks, the batch is the whole
    batch, and each rank takes its block of each microbatch's rows,
    padded where the data ranks do not divide them.  A batch that the
    microbatches do not divide is refused, as the reference asserts."""
    check_mesh(mesh)
    acc_dt = torch.bfloat16 if cfg.accum_dtype == "bfloat16" else torch.float32
    axes = SH.data_axes(mesh) if mesh is not None else ()
    n_data = mesh.count(axes) if mesh is not None else 1
    gather_once = mesh is not None and cfg.fsdp and cfg.fsdp_gather_once
    # gathered once, the leaves hold no FSDP split in the loop
    loop_cfg = (dataclasses.replace(cfg, fsdp=False) if gather_once
                else cfg)
    pls = M.flatten(SH.placements(cfg, mesh)) if mesh is not None else {}
    layer_pls = _layer_placements(M.unflatten(pls)) if pls else None

    def lf(p, tokens, labels, embeds, weights, n_rows):
        return T.loss_fn(p, tokens, labels, loop_cfg, embeds=embeds,
                         mesh=mesh, data_axes=axes or ("data",),
                         row_weights=weights, n_rows=n_rows)

    def rows(a, i, n, c):
        """Microbatch i's rows of ``a`` that this rank takes: its block of
        ``c`` rows, filled up with copies of the microbatch's first row
        where the data ranks do not divide the rows (GSPMD's pad)."""
        a = a[i::n]
        if n_data == 1:
            return a
        k = mesh.index(axes)
        own = a[k * c:(k + 1) * c]
        if own.shape[0] == c:
            return own
        return torch.cat([own, a[:1].expand(c - own.shape[0], *a.shape[1:])])

    def grads_and_metrics(params, tokens, labels, embeds=None):
        n = max(cfg.n_microbatches, 1)
        b = tokens.shape[0]
        if b % n:
            raise ValueError(
                f"batch {b} is not a multiple of n_microbatches = {n}")
        r = b // n
        c = -(-r // n_data)
        if cfg.n_experts:
            MOE.check_rows(cfg, r, n_data, b)
        weights = None
        if r % n_data:
            # 1 on this rank's real rows, 0 on its pad rows
            first = mesh.index(axes) * c
            weights = (torch.arange(first, first + c, device=tokens.device)
                       < r).to(torch.float32)
        # one microbatch: the reference takes its gradients as they are,
        # which equal zeros + gradients in float32
        dt = acc_dt if n > 1 else torch.float32
        # a bfloat16 accumulator rounds each microbatch's gradient summed
        # over the data ranks, as the reference's does: each is reduced
        # before it is added (a float32 one is reduced once, after)
        each = mesh is not None and dt != torch.float32
        blocks = params
        if gather_once:
            params = M.unflatten({k: _gather_data(x, pls[k], axes)
                                  for k, x in M.flatten(params).items()})
        acc = _map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device),
                   blocks if each else params)
        into = T.unstack_layers(acc) if dt == torch.float32 else None
        vg = value_and_grad(lf, has_aux=True, into=into)
        layers = T.unstack_layers(params)
        dev = tokens.device
        mets = {k: f32(0.0, dev) for k in _METRICS}
        for i in range(n):
            (_, m), g = vg(layers, rows(tokens, i, n, c),
                           rows(labels, i, n, c),
                           None if embeds is None else rows(embeds, i, n, c),
                           weights, r)
            if n == 1:
                mets = m
                break
            if into is None:
                trees = (T.unstack_layers(acc), g) + ((layer_pls,) if each
                                                      else ())
                for a, gg, *pl in _leafwise(*trees):
                    if pl:
                        gg = SH.reduce_data(gg, pl[0], axes, gather_once)
                    a.add_(gg.to(dt))
            mets = {k: mets[k] + m[k] for k in _METRICS}
        if mesh is not None and not each:
            acc = M.unflatten({k: SH.reduce_data(a, pls[k], axes, gather_once)
                               for k, a in M.flatten(acc).items()})
        if n == 1:
            return acc, mets
        # the reference divides by the constant n under jit, which XLA
        # turns into a product with its float32 reciprocal
        inv = f32(1.0, dev) / f32(n, dev)
        if dt == torch.float32:
            grads = _map(lambda a: a.mul_(inv), acc)
        else:
            grads = _map(lambda a: a.to(torch.float32) * inv, acc)
        return grads, {k: v * inv for k, v in mets.items()}

    return grads_and_metrics


def _gather_data(x: torch.Tensor, pl, axes) -> torch.Tensor:
    """A leaf's blocks gathered over the data axes, outside autograd."""
    with torch.no_grad():
        return SH.gather_leaf(x, pl, axes).contiguous()


def _layer_placements(pls) -> dict:
    """``pls`` laid out as ``T.unstack_layers`` lays out the parameters:
    each layer's leaves placed as their stacked leaf's slices."""
    def one(t):
        return {k: one(v) if isinstance(v, dict) else
                SH.Placement(v.shape[1:], v.spec[1:], v.mesh)
                for k, v in t.items()}
    n = next(iter(M.flatten(pls["layers"]).values())).shape[0]
    return {**pls, "layers": [one(pls["layers"])] * n}


def make_train_step(cfg: ModelConfig, opt: Optimizer, mesh=None
                    ) -> Callable:
    """``(params, opt_state, tokens, labels, step, embeds=None) ->
    (params, opt_state, metrics)``.  The parameters and state are updated in place and
    returned (the inputs are consumed, as the reference's donated buffers
    are)."""
    grads_and_metrics = make_grad_fn(cfg, mesh)
    if mesh is not None and opt.shards is None:
        raise ValueError("a step over a mesh needs an optimizer placed on "
                         "it (make_optimizer(..., shards=placements(cfg, "
                         "mesh)))")

    def train_step(params, opt_state, tokens, labels, step, embeds=None):
        grads, metrics = grads_and_metrics(params, tokens, labels, embeds)
        opt.update_(grads, opt_state, params, step)
        return params, opt_state, metrics

    return train_step


class Trainer:
    """Trains ``cfg`` from ``init_params`` on the reference's
    ``PRNGKey(seed)`` stream, on ``device`` (default: the CUDA device;
    raises when there is none), or over ``mesh`` on its device."""

    def __init__(self, cfg: ModelConfig,
                 tcfg: TrainerConfig = TrainerConfig(), mesh=None,
                 seed: int = 0, device=None):
        check_mesh(mesh)
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            self.device = mesh.device
            self.shards = SH.placements(cfg, mesh)
            blocks = {k: pl.block()
                      for k, pl in M.flatten(self.shards).items()}
        else:
            self.device = resolve_device(device)
            self.shards, blocks = None, None
        sched = Schedule(tcfg.lr, tcfg.warmup_steps, tcfg.decay_steps)
        opt = make_optimizer(cfg.optimizer, sched, shards=self.shards)
        if tcfg.grad_compression:
            opt = compression.compressed(opt, tcfg.grad_compression)
        self.opt = opt
        self.params = M.init_params(T.param_defs(cfg), prng.PRNGKey(seed),
                                    self.device, blocks=blocks)
        self.opt_state = opt.init(self.params)
        self.step = 0
        self._step_fn = make_train_step(cfg, opt, mesh)
        self.ckpt = Checkpointer(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
        self.watchdog = fault.StragglerWatchdog(tcfg.straggler_threshold)
        self.preempt = None
        self.history: list = []

    def _shardings(self):
        """The placements of ``(params, opt_state)``, None on one
        device."""
        if self.shards is None:
            return None
        return (self.shards, self.opt.state_shards(self.shards))

    def maybe_restore(self, pipeline=None) -> bool:
        """Load the latest checkpoint into the parameters and optimizer
        state (leaf by leaf, in place; over a mesh each rank its blocks,
        whatever mesh wrote it); False when there is none."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        _, extra = self.ckpt.restore((self.params, self.opt_state),
                                     device=self.device, into=True,
                                     shardings=self._shardings())
        self.step = int(extra.get("step", 0))
        if pipeline is not None and "pipeline" in extra:
            pipeline.load_state_dict(extra["pipeline"])
        return True

    def save(self, pipeline=None, block: bool = True) -> None:
        """Checkpoint the parameters and optimizer state (over a mesh:
        whole leaves, gathered to rank 0, which writes them; every rank
        calls this)."""
        if self.ckpt is None:
            return
        extra = {"step": self.step}
        if pipeline is not None:
            extra["pipeline"] = pipeline.state_dict()
        self.ckpt.save(self.step, (self.params, self.opt_state), extra,
                       block=block, shardings=self._shardings())

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
