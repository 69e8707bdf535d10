"""Optimizers built from scratch: AdamW and Adafactor.

The port of ``repro.train.optimizer``.  Both are (init, update) pairs over
nested dicts of tensors, functional like the reference's: ``update``
returns new parameter and state trees under ``torch.no_grad()``.

Every scalar operand is a float32 tensor on the parameters' device
(``device.f32``), computed in the reference's order: ``b1 ** t`` with
``t`` a float32 tensor (a Python ``0.9 ** step`` would round once, in
float64), and no host-scalar divisor, which PyTorch's CUDA division takes
through its reciprocal.  The clip is the reference's ``max_norm /
max(norm, 1e-9)``, not ``torch.nn.utils.clip_grad_norm_`` (which adds
1e-6 to the norm).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.device import f32
from repro_torch.models import module as M


class Schedule(NamedTuple):
    base_lr: float
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_ratio: float = 0.1

    def __call__(self, step) -> torch.Tensor:
        """Linear warm-up then cosine decay to ``min_ratio``, in float32 on
        ``step``'s device (a Python int: the CPU).

        The reference trains with this inside ``jax.jit``, where XLA
        turns each division by a constant into a product with the
        constant's float32 reciprocal; the port computes those products.
        """
        step = torch.as_tensor(step)
        c = lambda x: f32(x, step.device)
        inv = lambda n: c(1.0) / c(n)
        s = step.to(torch.float32)
        warm = torch.minimum(s * inv(max(self.warmup_steps, 1)), c(1.0))
        prog = torch.clamp(
            (s - c(self.warmup_steps))
            * inv(max(self.decay_steps - self.warmup_steps, 1)), 0.0, 1.0)
        cos = c(0.5) * (c(1.0) + torch.cos(c(math.pi) * prog))
        return c(self.base_lr) * warm * (
            c(self.min_ratio) + c(1 - self.min_ratio) * cos)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]
    # update(grads, state, params, step) -> (new_params, new_state)


def _map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree``, with the same path's
    entry of each tree in ``rest`` (a whole subtree where ``tree`` has a
    leaf, as an Adafactor state does)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _unzip(tree, n: int):
    """A tree of n-tuples -> n trees."""
    if isinstance(tree, dict):
        parts = {k: _unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    return tree


def _device(tree) -> torch.device:
    return next(iter(M.flatten(tree).values())).device


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, the leaves
    summed in sorted path order (JAX's flattening order of a dict)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in M.flatten(tree).values()))


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` by ``min(1, max_norm / max(norm, 1e-9))``; returns
    (clipped grads, norm)."""
    norm = global_norm(grads)
    dev = norm.device
    scale = torch.minimum(
        f32(1.0, dev), f32(max_norm, dev) / torch.maximum(norm, f32(1e-9, dev)))
    return _map(lambda g: g * scale, grads), norm


def adamw(
    schedule: Schedule,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    max_grad_norm: float = 1.0,
) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": _map(zeros, params), "v": _map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, _ = clip_by_global_norm(grads, max_grad_norm)
        dev = _device(params)
        c = lambda x: f32(x, dev)
        step = torch.as_tensor(step, device=dev)
        lr = schedule(step)
        t = step.to(torch.float32) + c(1.0)
        c1 = c(1.0) - torch.pow(c(b1), t)
        c2 = c(1.0) - torch.pow(c(b2), t)

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            m = c(b1) * m + c(1 - b1) * g
            v = c(b2) * v + c(1 - b2) * g * g
            mh = m / c1
            vh = v / c2
            step_ = mh / (torch.sqrt(vh) + c(eps))
            if p.dim() >= 2:  # decoupled weight decay on matrices only
                step_ = step_ + c(weight_decay) * p.to(torch.float32)
            return (p.to(torch.float32) - lr * step_).to(p.dtype), m, v

        new_p, new_m, new_v = _unzip(
            _map(upd, grads, state["m"], state["v"], params), 3)
        return new_p, {"m": new_m, "v": new_v}

    return Optimizer(init, update)


def adafactor(
    schedule: Schedule,
    b1: float = 0.9,
    decay: float = 0.99,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    max_grad_norm: float = 1.0,
) -> Optimizer:
    """Factored second moment over the two largest dims; bf16 momentum
    (a round-to-nearest-even cast, as the reference's)."""

    def _factored(p) -> bool:
        return p.dim() >= 2 and p.shape[-1] >= 8 and p.shape[-2] >= 8

    def init(params):
        def one(p):
            z = lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                                 device=p.device)
            if _factored(p):
                return {"vr": z(p.shape[:-1], torch.float32),
                        "vc": z(p.shape[:-2] + p.shape[-1:], torch.float32),
                        "m": z(p.shape, torch.bfloat16)}
            return {"v": z(p.shape, torch.float32),
                    "m": z(p.shape, torch.bfloat16)}

        return _map(one, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, _ = clip_by_global_norm(grads, max_grad_norm)
        dev = _device(params)
        c = lambda x: f32(x, dev)
        lr = schedule(torch.as_tensor(step, device=dev))

        def one(g, s, p):
            g = g.to(torch.float32)
            g2 = g * g + c(eps)
            if _factored(p):
                vr = c(decay) * s["vr"] + c(1 - decay) * g2.mean(dim=-1)
                vc = c(decay) * s["vc"] + c(1 - decay) * g2.mean(dim=-2)
                denom = (vr[..., :, None] * vc[..., None, :]
                         / torch.maximum(vr.mean(dim=-1)[..., None, None],
                                         c(eps)))
                u = g * torch.rsqrt(torch.maximum(denom, c(eps)))
                new_s = {"vr": vr, "vc": vc}
            else:
                v = c(decay) * s["v"] + c(1 - decay) * g2
                u = g * torch.rsqrt(torch.maximum(v, c(eps)))
                new_s = {"v": v}
            rms_u = torch.sqrt(torch.mean(u * u) + c(eps))
            u = u / torch.maximum(c(1.0), rms_u / c(clip_threshold))
            m = c(b1) * s["m"].to(torch.float32) + c(1 - b1) * u
            new_s["m"] = m.to(torch.bfloat16)
            return (p.to(torch.float32) - lr * m).to(p.dtype), new_s

        return _unzip(_map(one, grads, state, params), 2)

    return Optimizer(init, update)


def make_optimizer(kind: str, schedule: Schedule, **kw) -> Optimizer:
    if kind == "adamw":
        return adamw(schedule, **kw)
    if kind == "adafactor":
        return adafactor(schedule, **kw)
    raise ValueError(kind)
