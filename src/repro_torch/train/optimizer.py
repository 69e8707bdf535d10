"""Optimizers built from scratch: AdamW and Adafactor.

The port of ``repro.train.optimizer``, over nested dicts of float32
tensors.  Each optimizer is written once, as ``update_``: it writes the
new parameters and state into the old tensors leaf by leaf (the gradients
are overwritten), its temporaries freed as it goes -- the port's
counterpart of the reference trainer's ``donate_argnums``, without which
a 2.8 B-parameter model's old and new parameters and moments would not
fit one card together.  ``update``, the reference's functional form, is
``update_`` on copies.

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
from typing import Any, Callable, NamedTuple

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


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update_: Callable[[Any, Any, Any, Any], None]
    # update_(grads, state, params, step): the new params and state written
    # into ``params`` and ``state`` (``grads`` are overwritten)

    @torch.no_grad()
    def update(self, grads, state, params, step):
        """(new_params, new_state), the arguments left as they were."""
        new_params, new_state = _clone(params), _clone(state)
        self.update_(_clone(grads), new_state, new_params, step)
        return new_params, new_state


def _map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree``, with the same path's
    entry of each tree in ``rest`` (a whole subtree where ``tree`` has a
    leaf, as an Adafactor state does)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _device(tree) -> torch.device:
    return next(iter(M.flatten(tree).values())).device


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, the leaves
    summed in sorted path order (JAX's flattening order of a dict)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in M.flatten(tree).values()))


def _clip_scale(grads, max_norm: float):
    norm = global_norm(grads)
    dev = norm.device
    return torch.minimum(
        f32(1.0, dev),
        f32(max_norm, dev) / torch.maximum(norm, f32(1e-9, dev))), norm


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` by ``min(1, max_norm / max(norm, 1e-9))``; returns
    (clipped grads, norm).  The updates scale their gradients in place by
    the same factor."""
    scale, norm = _clip_scale(grads, max_norm)
    return _map(lambda g: g * scale, grads), norm


def _leafwise(*trees):
    """The leaves of ``trees`` side by side, one tuple per path of the
    first (a whole subtree of the others where it has a leaf)."""
    if isinstance(trees[0], dict):
        for k in trees[0]:
            yield from _leafwise(*(t[k] for t in trees))
    elif isinstance(trees[0], list):
        for i in range(len(trees[0])):
            yield from _leafwise(*(t[i] for t in trees))
    else:
        yield trees


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
    def update_(grads, state, params, step):
        scale, _ = _clip_scale(grads, max_grad_norm)
        dev = _device(params)
        c = lambda x: f32(x, dev)
        step = torch.as_tensor(step, device=dev)
        lr = schedule(step)
        t = step.to(torch.float32) + c(1.0)
        c1 = c(1.0) - torch.pow(c(b1), t)
        c2 = c(1.0) - torch.pow(c(b2), t)
        for g, m, v, p in _leafwise(grads, state["m"], state["v"], params):
            if g.dtype != torch.float32 or p.dtype != torch.float32:
                raise TypeError("update_ takes float32 grads and params")
            g.mul_(scale)
            tmp = g * c(1 - b1)
            m.mul_(c(b1)).add_(tmp)
            torch.mul(g, c(1 - b2), out=tmp).mul_(g)
            v.mul_(c(b2)).add_(tmp)
            torch.div(v, c2, out=tmp).sqrt_().add_(c(eps))
            st = torch.div(m, c1).div_(tmp)
            if p.dim() >= 2:
                st.add_(torch.mul(p, c(weight_decay), out=tmp))
            del tmp
            p.sub_(st.mul_(lr))

    return Optimizer(init, update_)


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
    def update_(grads, state, params, step):
        scale, _ = _clip_scale(grads, max_grad_norm)
        dev = _device(params)
        c = lambda x: f32(x, dev)
        lr = schedule(torch.as_tensor(step, device=dev))
        for g, s, p in _leafwise(grads, state, params):
            if g.dtype != torch.float32 or p.dtype != torch.float32:
                raise TypeError("update_ takes float32 grads and params")
            g.mul_(scale)
            g2 = (g * g).add_(c(eps))
            if _factored(p):
                s["vr"].mul_(c(decay)).add_(g2.mean(dim=-1).mul_(c(1 - decay)))
                s["vc"].mul_(c(decay)).add_(g2.mean(dim=-2).mul_(c(1 - decay)))
                del g2
                vr = s["vr"]
                u = vr[..., :, None] * s["vc"][..., None, :]
                u.div_(torch.maximum(vr.mean(dim=-1)[..., None, None], c(eps)))
            else:
                s["v"].mul_(c(decay)).add_(g2.mul_(c(1 - decay)))
                del g2
                u = s["v"].clone()
            torch.maximum(u, c(eps), out=u).rsqrt_().mul_(g)
            rms_u = torch.sqrt(torch.mean(u * u) + c(eps))
            u.div_(torch.maximum(c(1.0), rms_u / c(clip_threshold)))
            m = s["m"].to(torch.float32).mul_(c(b1)).add_(u.mul_(c(1 - b1)))
            del u
            s["m"].copy_(m)
            p.sub_(m.mul_(lr))

    return Optimizer(init, update_)


def make_optimizer(kind: str, schedule: Schedule, **kw) -> Optimizer:
    if kind == "adamw":
        return adamw(schedule, **kw)
    if kind == "adafactor":
        return adafactor(schedule, **kw)
    raise ValueError(kind)
