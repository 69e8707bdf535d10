"""Reading one ``torch.profiler`` trace: the device's busy time, its idle
gaps by what the host was doing, and device time by kernel.

The traced window is the ``perfbench.serve`` host region that the loop
records around the profiled call.  Busy time is the union of every
device activity (kernels, copies, sets) inside it; an idle gap is named
by the innermost ``aten::`` op open on the host when the gap began, or
else the innermost ``perfbench.*`` region (the benchmark's wrappers
around the program's calls), or ``host`` when neither is open.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

WINDOW = "perfbench.serve"
NAME_CHARS = 160


def events(prof) -> Tuple[list, list]:
    """(device activities, host ops) as (start_ns, end_ns, name), each
    sorted by start.  The profiler also lays each ``record_function``
    region onto the device's timeline as a user annotation; those are no
    device work and are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and e.is_user_annotation():
            continue      # a host region's shadow on the device's timeline
        s = e.start_ns()
        row = (s, s + e.duration_ns(), e.name())
        (dev if e.device_type() == cuda else host).append(row)
    dev.sort()
    host.sort()
    return dev, host


def _union(spans) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _label(stack) -> str:
    for prefix in ("aten::", "perfbench."):
        for _, _, name in reversed(stack):
            if name.startswith(prefix):
                return name
    return "host"


def read(dev: list, host: list) -> dict:
    """Busy and window seconds, device seconds by kernel, idle seconds by
    host activity, and the device activities themselves (for readers
    that want one kernel's time)."""
    win = [(s, e) for s, e, n in host if n == WINDOW]
    if not win:
        return {}
    w0, w1 = win[0]
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in dev
              if e > w0 and s < w1]
    busy = _union((s, e) for s, e, _ in inside)
    busy_ns = sum(e - s for s, e in busy)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    ops = [h for h in host if h[2].startswith(("aten::", "perfbench."))
           and h[2] != WINDOW]
    idle: Dict[str, float] = {}
    stack, i = [], 0
    for gs, ge in gaps:
        while i < len(ops) and ops[i][0] <= gs:
            while stack and stack[-1][1] <= ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] <= gs:
            stack.pop()
        name = _label(stack)
        idle[name] = idle.get(name, 0.0) + (ge - gs) / 1e9
    by_kernel: Dict[str, float] = {}
    for s, e, n in inside:
        by_kernel[n] = by_kernel.get(n, 0.0) + (e - s) / 1e9
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "by_kernel": by_kernel, "idle_by_host": idle, "device": inside}


def breakdown(t: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that
    took most time and the ten host activities under which the device
    idled longest, [name, seconds] each."""
    top = lambda d: [[k[:NAME_CHARS], v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(t["by_kernel"]),
            "idle_gaps": top(t["idle_by_host"])}
