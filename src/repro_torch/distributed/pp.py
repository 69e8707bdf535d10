"""Pipeline parallelism: GPipe-style microbatch pipelining over a
``"stage"`` mesh axis.

The port of ``repro.distributed.pp``.  Each rank of the stage axis runs
one stage.  Schedule: the classic (n_micro + n_stages - 1)-tick loop; at
tick t, stage s runs microbatch t - s on what stage s - 1 sent it at
tick t - 1 (``send`` / ``recv`` to the next rank, in place of the
reference's ``ppermute``), and the last stage keeps its outputs, which
it then broadcasts to every stage (in place of the reference's
``psum``).  The bubble fraction is (S - 1) / (M + S - 1), ``bubble()``.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models import module as M


def bubble(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _stage_rank(mesh, stage_axis: str, s: int) -> int:
    """The global rank of stage ``s`` among the ranks that share this
    rank's coordinates on the other axes."""
    coords = dict(mesh.coords, **{stage_axis: s})
    r = 0
    for a, n in zip(mesh.axes, mesh.dims):
        r = r * n + coords[a]
    return r


@torch.no_grad()
def pipeline_forward(stage_fn: Callable, params_stacked, x: torch.Tensor,
                     mesh, stage_axis: str = "stage") -> torch.Tensor:
    """Run the pipeline over ``mesh``'s ``stage_axis`` (a
    ``distributed.mesh.ProcessMesh``).  ``params_stacked``: a tensor or a
    dict of them, leading dim n_stages (every rank may pass them whole;
    each takes its stage's); ``x`` (n_micro, mb, ...), the same on every
    rank.  Returns the last stage's (n_micro, mb, ...) outputs on every
    rank."""
    n_stages = mesh.shape[stage_axis]
    sid = mesh.coords[stage_axis]
    n_micro = x.shape[0]
    if isinstance(params_stacked, dict):
        p_here = M.unflatten({k: v[sid] for k, v in
                              M.flatten(params_stacked).items()})
    else:
        p_here = params_stacked[sid]
    prev = _stage_rank(mesh, stage_axis, sid - 1) if sid > 0 else None
    nxt = (_stage_rank(mesh, stage_axis, sid + 1) if sid < n_stages - 1
           else None)
    last = _stage_rank(mesh, stage_axis, n_stages - 1)
    outputs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        mb = t - sid                      # the microbatch this stage runs
        if not 0 <= mb < n_micro:
            continue
        if prev is None:
            cur = x[mb]
        else:
            cur = torch.empty_like(x[0])
            dist.recv(cur, src=prev)
        out = stage_fn(p_here, cur)
        if nxt is not None:
            dist.send(out.contiguous(), dst=nxt)
        else:
            outputs[mb] = out
    if n_stages > 1:
        dist.broadcast(outputs, src=last, group=mesh.group(stage_axis))
    return outputs
