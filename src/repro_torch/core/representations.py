"""2D event representations (paper Sec. II-B), as far as serving needs.

The port of ``repro.core.representations``: only ``edram_ideal_params``,
which the engine and the spec layer use to run the ideal exponential TS
through the same decay kernel as the eDRAM read.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import edram


def edram_ideal_params(tau: float) -> edram.DecayParams:
    """The ideal exponential TS as a degenerate double-exp transient
    (``a1=1, a2=0, b=0``): both decay modes run through one kernel."""
    f32 = np.float32
    return edram.DecayParams(a1=f32(1.0), tau1=f32(tau), a2=f32(0.0),
                             tau2=f32(1.0), b=f32(0.0))
