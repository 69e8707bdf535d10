"""The device an entry point runs on when its caller names none, and
float32 operands placed on the data's device."""
from __future__ import annotations

import torch


def f32(x, device=None) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device`` (None: where ``x`` is, or
    the CPU): an operand on the data's device, never a host scalar.
    PyTorch's elementwise kernels may take a host-scalar operand down
    another path (a divisor through its reciprocal), which would cost the
    last bit."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device, raising when there is none;
    anything else -> that ``torch.device`` (a bare ``"cuda"`` gets the
    current index)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
