"""Build, load and launch bookkeeping of the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface: each launcher takes
device pointers, sizes and the ``cudaStream_t`` and returns the
``cudaError_t`` of ``cudaGetLastError()``.  At first use they are compiled
for Hopper (``sm_90a``) with ``nvcc`` -- one process per source, all
started together, then one link -- into a single shared library, and
loaded with ``ctypes``.  The library lives in
``build/repro_torch_kernels/<hash of the sources and flags>/`` at the root
of the checkout, so a changed source rebuilds and an unchanged one loads
at once.  ``REPRO_TORCH_BUILD_DIR`` moves that directory.

The decay arithmetic must stay IEEE: no ``--use_fast_math``, and
``-fmad=false`` so no product is contracted into an add.

Every wrapper adds one to ``LAUNCHES[<kernel>]`` where it launches its
kernel, and nowhere else.  A kernel's meta route (the dry run's step on
``meta`` tensors, ``launch.dryrun``) launches nothing: it adds the work
the kernel would do to ``META_COSTS[<kernel>]`` instead.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("ts_decay.cu", "stcf.cu", "ts_fused.cu", "decay_scan.cu")
HEADERS = ("decay.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {"ts_decay": 0, "stcf_support": 0,
                            "chunk_scatter": 0, "decay_scan": 0,
                            "decay_scan_bwd": 0}

#: kernel name -> {"calls", "flops", "bytes"} that the meta routes charged
#: since the last ``reset_meta_costs()``: what the kernel would do on the
#: card for those calls (each input read once, each output written once)
META_COSTS: Dict[str, Dict[str, int]] = {
    k: {"calls": 0, "flops": 0, "bytes": 0}
    for k in ("decay_scan", "decay_scan_bwd")}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ULL = ctypes.c_ulonglong
_SIGNATURES = {
    "ts_decay_uniform": [_P, _P, _P, _LL] + [_F] * 7 + [_P],
    "ts_decay_planes": [_P, _P, _P, _LL, _LL, _F] + [_P] * 5
    + [_F] + [_I] * 4 + [_P],
    "decay_division_gate": [_I] + [_F] * 5 + [_ULL] * 2 + [_P, _P],
    "stcf_support_mask": [_P, _P] + [_I] * 5 + [_P],
    "stcf_support_fused": [_P, _P] + [_I] * 5 + [_F] * 7 + [_P],
    "chunk_scatter": [_P] + [_I] * 4 + [_P] * 6 + [_I, _I, _P, _I, _I]
    + [_P] * 4,
    "decay_scan": [_P] * 5 + [_LL] * 3 + [_P],
    "decay_scan_bwd": [_P] * 8 + [_LL] * 3 + [_P],
    "stcf_max_radius": [],
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path          # the loaded shared library
    seconds: float      # compile + link time (0.0 when loaded from cache)
    ptxas: str          # ptxas -v register/shared-memory report


_lock = threading.Lock()
_loaded: Optional[tuple] = None   # (ctypes.CDLL, BuildInfo)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def reset_meta_costs() -> None:
    for c in META_COSTS.values():
        c.update(calls=0, flops=0, bytes=0)


def charge(kernel: str, flops: int, nbytes: int) -> None:
    """Count one call of ``kernel``'s meta route and the work it stands
    for."""
    c = META_COSTS[kernel]
    c["calls"] += 1
    c["flops"] += int(flops)
    c["bytes"] += int(nbytes)


def _root_build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the repro_torch CUDA kernels cannot be built"
        )
    return found


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: Path) -> BuildInfo:
    """Compile every source in parallel, link one library, and move it
    into ``out_dir`` with an atomic rename (concurrent builders race
    harmlessly)."""
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"tmp-{os.getpid()}-{threading.get_ident()}"
    tmp.mkdir()
    procs = []
    for src in SOURCES:
        obj = tmp / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        objs.append(str(obj))
        if proc.returncode:
            failed.append(src)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    lib_tmp = tmp / "librepro_torch_kernels.so"
    link = subprocess.run(
        [nvcc, "-shared", "-Xcompiler", "-fPIC", *objs, "-o", str(lib_tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    ptxas = "\n".join(line for line in log.splitlines()
                      if "ptxas" in line or line.startswith("=="))
    (tmp / "ptxas.txt").write_text(ptxas)
    os.replace(tmp / "ptxas.txt", out_dir / "ptxas.txt")
    os.replace(lib_tmp, out_dir / lib_tmp.name)
    shutil.rmtree(tmp, ignore_errors=True)
    return BuildInfo(out_dir / lib_tmp.name, time.perf_counter() - t0, ptxas)


def library():
    """The loaded kernel library and its ``BuildInfo``, built at first use."""
    global _loaded
    with _lock:
        if _loaded is None:
            nvcc = _nvcc()
            out_dir = _root_build_dir() / _digest(nvcc)
            lib_path = out_dir / "librepro_torch_kernels.so"
            if lib_path.exists():
                log = out_dir / "ptxas.txt"
                info = BuildInfo(lib_path, 0.0,
                                 log.read_text() if log.exists() else "")
            else:
                info = _compile(nvcc, out_dir)
            lib = ctypes.CDLL(str(info.path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _loaded = (lib, info)
        return _loaded


def launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    """Call launcher ``fn_name`` on ``device``'s current stream, raise on a
    nonzero CUDA error, and count one launch of ``kernel``."""
    lib, _ = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[kernel] += 1


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device pointer for ctypes (None -> NULL)."""
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, dtype: torch.dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
