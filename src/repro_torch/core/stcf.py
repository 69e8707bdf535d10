"""Spatio-Temporal Correlation Filter configuration (paper Sec. IV-C).

The port of ``repro.core.stcf`` as far as serving needs: the config the
engine derives from its own.  An event is *signal* if at least
``threshold`` cells in the (2r+1)^2 patch around it hold a timestamp
within the correlation window ``tau_tw``; the dense support map is the
``stcf_support`` kernel (``kernels.ops``).
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.hw import constants as C


class STCFConfig(NamedTuple):
    radius: int = 3                 # (2r+1)x(2r+1) patch; r=3 -> 7x7 as in [26]
    tau_tw: float = C.MEMORY_WINDOW_S
    threshold: int = 2              # min supporting cells
    include_self: bool = False      # count the event's own cell's past write
    polarity_sensitive: bool = False
