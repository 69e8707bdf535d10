"""The card's state, read with ``nvidia-smi`` (read-only queries): name,
power limit and draw, SM clock against its maximum, temperature, memory
in use, and the compute processes on it."""
from __future__ import annotations

import subprocess

_GPU = ("index,name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
        "temperature.gpu,memory.used")
_APPS = "pid,process_name,used_memory"


def _query(args):
    try:
        out = subprocess.run(["nvidia-smi", *args, "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    if out.returncode:
        return f"nvidia-smi exit {out.returncode}: {out.stderr.strip()}"
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def read() -> dict:
    """{"gpus": one csv line a card (``_GPU``'s fields), "apps": one a
    compute process}."""
    return {"fields": _GPU, "gpus": _query([f"--query-gpu={_GPU}"]),
            "apps": _query([f"--query-compute-apps={_APPS}"])}
