"""Atomic, optionally asynchronous checkpoints of trees of tensors.

The port of ``repro.checkpoint.ckpt``, on the same directory layout, so
one checkpoint directory serves both packages::

    <dir>/step_<N:08d>/
        manifest.msgpack   step, leaf paths, shapes, dtypes, extra state
        <leaf>.npy         one file per leaf (host numpy)

A tree is nested dicts, tuples and lists.  A leaf's path joins its dict
keys and sequence indices with ``/``, keys sorted at every level and
indices in order, as JAX flattens them (``inc1/b3a/w``; a trainer's
``(params, opt_state)`` as ``0/embed``, ``1/m/embed``); its file name is
the path with ``/`` -> ``__``.  bfloat16 leaves are stored as
their uint16 bits.  Writes go to ``step_<N>.tmp`` and are renamed into
place, so a crash mid-write never shows as a checkpoint; ``keep`` bounds
how many steps stay on disk.  The manifest is msgpack, written and read by
``checkpoint.manifest`` (the ``msgpack`` package is not needed).
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import manifest as mp
from repro_torch.device import resolve_device
from repro_torch.models import module as M

#: leaf dtype -> the name a manifest gives it (numpy's, plus bfloat16)
_DTYPES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}


def _host(x: torch.Tensor) -> np.ndarray:
    """A copy of a leaf as the numpy array its file holds (bfloat16 as
    uint16 bits)."""
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16).copy()
    return x.numpy().copy()


class Checkpointer:
    """Save and restore trees of tensors under ``directory``,
    keeping the newest ``keep`` steps."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree, extra: Optional[Dict] = None,
             block: bool = True) -> None:
        """Write ``tree`` as step ``step``.  The copy to the host is
        synchronous; with ``block=False`` the files are written by a thread
        (``wait`` joins it)."""
        items = list(M.flatten(tree, sep="/").items())
        for k, v in items:
            if v.dtype not in _DTYPES:
                raise TypeError(f"{k}: cannot checkpoint dtype {v.dtype}")
        host = [(k, _host(v)) for k, v in items]
        manifest = {
            "step": int(step),
            "leaves": [{"key": k, "shape": list(v.shape),
                        "dtype": _DTYPES[v.dtype]} for k, v in items],
            "extra": extra or {},
        }
        self.wait()
        if block:
            self._write(step, host, manifest)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, manifest), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join an asynchronous save."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write(self, step, host, manifest) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for k, a in host:
            np.save(os.path.join(tmp, k.replace("/", "__") + ".npy"), a)
        with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
            f.write(mp.packb(manifest))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self) -> List[int]:
        """The complete steps on disk, ascending."""
        return sorted(int(d[5:]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None, device=None,
                into: bool = False) -> Tuple[Any, Dict]:
        """Restore step ``step`` (default: the latest) into the structure
        of ``template``, whose leaves give the shape and dtype each stored
        array must have (tensors, or ``ParamDef``s).  Leaves land on
        ``device`` (default: the CUDA device; raises when there is none);
        with ``into`` each is copied into ``template``'s own tensor, one
        leaf at a time, and ``template`` is returned.  Returns ``(tree,
        extra)``; raises ``FileNotFoundError`` when there is no such step
        or leaf file, ``ValueError`` on a shape mismatch."""
        device = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.dir}")
        path = self._step_dir(step)
        with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
            manifest = mp.unpackb(f.read())
        leaves = {}
        for k, tmpl in M.flatten(template, sep="/").items():
            arr = np.load(os.path.join(path, k.replace("/", "__") + ".npy"))
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"{k}: stored shape {arr.shape} != "
                                 f"template shape {tuple(tmpl.shape)}")
            if arr.dtype == np.uint16 and tmpl.dtype == torch.bfloat16:
                x = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                x = torch.from_numpy(arr)
            x = x.to(device=device, dtype=tmpl.dtype)
            if into:
                tmpl.copy_(x)
            leaves[k] = tmpl if into else x
        return M.unflatten_like(template, leaves, sep="/"), manifest["extra"]
