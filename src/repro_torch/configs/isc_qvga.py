"""The paper's own architecture: QVGA 3DS-ISC array + STCF + CNN head.

Not an LM -- an event-vision pipeline config, field for field the
reference's ``ISCConfig``, consumed by the time-surface engine and the
examples.
"""
import dataclasses

from repro_torch.hw import constants as C


@dataclasses.dataclass(frozen=True)
class ISCConfig:
    name: str = "isc-qvga"
    h: int = C.QVGA_H
    w: int = C.QVGA_W
    polarities: int = 1
    cmem_f: float = C.ISC_CMEM_F
    tau_tw: float = C.MEMORY_WINDOW_S
    stcf_radius: int = 3
    stcf_threshold: int = 2
    mode: str = "3d"            # 3d | 2d | ideal
    variability: bool = True


CONFIG = ISCConfig()
