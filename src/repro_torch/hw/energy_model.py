"""Analytic power/area/latency models reproducing the paper's Fig. 7/8.

A copy of ``repro.hw.energy_model`` (framework-free host float math) for
the port, whose stream runtime meters energy per tier with
``EnergyMeter``.

No SPICE or Synopsys runs are possible here, so the module models each
block from published constants (see ``repro_torch.hw.constants``) plus a small
number of clearly-flagged engineering estimates (65 nm wire capacitance,
crossbar routing overhead).  The paper's headline ratios — 69x power /
1.9x area / 2.2x latency vs 2D, and 1600-6761x power / 2.2-3.1x area vs
SRAM — are **outputs** of these models; tests assert they land in bands
around the published values rather than hard-coding them.

Component conventions: powers in W, areas in m^2, delays in s, energies in J.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.hw import constants as C

# --- engineering estimates (flagged; 65 nm typical values) -------------------

#: Metal wire capacitance per micron (65 nm, mid-level metal, typical).
WIRE_CAP_PER_UM_F = 0.2e-15

#: Crossbar routing/pitch overhead of a 2D cell vs the Cu-Cu-bonded 3D cell:
#: the 2D array must route WWL/WBL pairs through the cell pitch and keep
#: half-select-robust spacing; the 3D cell is capacitor-limited (Fig. 4f).
CROSSBAR_AREA_OVERHEAD = 1.8

#: Source-follower readout energy per access, relative to a cell write
#: (the SF bias burns roughly one CV^2 per sampled read).
READ_WRITE_ENERGY_RATIO = 1.0

#: Internal switching overhead of the tapered WWL/WBL driver chains over
#: the pure wire-load CV^2 (FO4-tapered chain theory gives e/(e-1) ~ 1.6;
#: we use a mid-range 1.45).
BUFFER_CHAIN_OVERHEAD = 1.45

#: AER encoder/decoder energy per event relative to the long-wire buffer
#: energy — set from the paper's own Fig. 7(c) breakdown (53.8 % enc/dec vs
#: 45.5 % buffers), the one place we calibrate to a published *breakdown*
#: (not to the headline ratio).
ENCDEC_TO_BUFFER_RATIO = C.P2D_FRAC_ENCDEC / C.P2D_FRAC_BUFFER

#: Area of the peripheral blocks (enc/dec + buffers) relative to the array
#: in the 2D design — Fig. 7(c): "only a small fraction of the total".
PERIPHERY_AREA_FRACTION_2D = 0.05


@dataclasses.dataclass
class BlockReport:
    power_w: Dict[str, float]
    area_m2: Dict[str, float]
    delay_s: Dict[str, float]

    @property
    def total_power(self) -> float:
        return sum(self.power_w.values())

    @property
    def total_area(self) -> float:
        return sum(self.area_m2.values())

    @property
    def total_delay(self) -> float:
        return sum(self.delay_s.values())


# ----------------------------------------------------------------------------
# ISC array primitives
# ----------------------------------------------------------------------------

def cell_write_energy(cmem_f: float = C.ISC_CMEM_F, vdd: float = C.VDD_V) -> float:
    """CV^2 to charge the MOMCAP through the LL switch."""
    return cmem_f * vdd**2


def cell_leakage_power(cmem_f: float = C.ISC_CMEM_F, vdd: float = C.VDD_V,
                       decay_tau_s: float = 20e-3) -> float:
    """Average leakage per cell: I_leak ~ C*Vdd/tau, P ~ I*Vdd/2 (avg V)."""
    i_leak = cmem_f * vdd / decay_tau_s
    return 0.5 * i_leak * vdd


def isc_array_power(
    h: int = C.QVGA_H, w: int = C.QVGA_W,
    rate_eps: float = C.EVENT_RATE_EPS,
    cmem_f: float = C.ISC_CMEM_F,
) -> Dict[str, float]:
    """Power of the bare analog ISC array (write + readout + leakage)."""
    e_w = cell_write_energy(cmem_f)
    return {
        "array_write": e_w * rate_eps,
        "array_read": READ_WRITE_ENERGY_RATIO * e_w * rate_eps,
        "array_leakage": cell_leakage_power(cmem_f) * h * w,
    }


# ----------------------------------------------------------------------------
# 2D vs 3D architectures (Fig. 7)
# ----------------------------------------------------------------------------

def arch_3d(
    h: int = C.QVGA_H, w: int = C.QVGA_W,
    rate_eps: float = C.EVENT_RATE_EPS,
) -> BlockReport:
    arr = isc_array_power(h, w, rate_eps)
    # one Cu-Cu bond toggles per event (1 pulse ~ 1 bit-line charge)
    p_cucu = C.CUCU_CAP_F * C.VDD_V**2 * rate_eps
    area_cell = C.ISC_CELL_AREA_M2 * h * w  # stacked under the sensor
    return BlockReport(
        power_w={**arr, "cucu": p_cucu},
        area_m2={"array": area_cell, "cucu": 0.002 * area_cell},
        delay_s={"event_write": C.EVENT_WRITE_LATENCY_S, "cucu": C.CUCU_LATENCY_S},
    )


def arch_2d(
    h: int = C.QVGA_H, w: int = C.QVGA_W,
    rate_eps: float = C.EVENT_RATE_EPS,
) -> BlockReport:
    arr = isc_array_power(h, w, rate_eps)
    # long-wire drivers: every event charges one WBL (column) + one WWL (row)
    wbl_len_um = h * 3.9  # cell pitch from Fig. 4(f)
    wwl_len_um = w * 4.8
    c_wire = WIRE_CAP_PER_UM_F * (wbl_len_um + wwl_len_um) * CROSSBAR_AREA_OVERHEAD
    e_buf = BUFFER_CHAIN_OVERHEAD * c_wire * C.VDD_V**2
    p_buf = e_buf * rate_eps
    p_encdec = ENCDEC_TO_BUFFER_RATIO * p_buf
    area_array = C.ISC_CELL_AREA_M2 * h * w * CROSSBAR_AREA_OVERHEAD
    return BlockReport(
        power_w={**arr, "buffers": p_buf, "encdec": p_encdec},
        area_m2={
            "array": area_array,
            "periphery": PERIPHERY_AREA_FRACTION_2D * area_array,
        },
        delay_s={
            "event_write": C.EVENT_WRITE_LATENCY_S,
            "encdec_handshake": C.ENCDEC_LATENCY_2D_S,
        },
    )


def compare_2d_3d(**kw) -> Dict[str, float]:
    """Fig. 7(b): the three headline ratios, derived."""
    d3, d2 = arch_3d(**kw), arch_2d(**kw)
    return {
        "power_ratio": d2.total_power / d3.total_power,
        "area_ratio": d2.total_area / d3.total_area,
        "delay_ratio": d2.total_delay / d3.total_delay,
        "p3d_w": d3.total_power,
        "p2d_w": d2.total_power,
        "lat3d_s": d3.total_delay,
        "lat2d_s": d2.total_delay,
    }


# ----------------------------------------------------------------------------
# ISC analog array vs SRAM timestamp storage (Fig. 8)
# ----------------------------------------------------------------------------

def sram_array_ref53(
    h: int = C.QVGA_H, w: int = C.QVGA_W,
    rate_eps: float = C.EVENT_RATE_EPS,
    n_bits: int = C.TIMESTAMP_BITS,
) -> BlockReport:
    """16-bit SRAM SAE storage costed with [53]'s energy/leakage numbers."""
    p_write = C.SRAM_WRITE_ENERGY_PER_BIT_J * n_bits * rate_eps
    p_leak = C.SRAM_LEAKAGE_PER_CELL_A * C.SRAM_VDD_V * h * w * n_bits
    # [53] is an in-memory-computing design: its 10T bitcell+periphery runs
    # ~3.6 um^2/bit (flagged estimate; standard 6T macro would be ~2.7).
    area = 3.63e-12 * n_bits * h * w
    return BlockReport(
        power_w={"write": p_write, "leakage": p_leak},
        area_m2={"array": area},
        delay_s={},
    )


def sram_array_ref26(
    h: int = C.QVGA_H, w: int = C.QVGA_W,
    rate_eps: float = C.EVENT_RATE_EPS,
    n_bits: int = C.TIMESTAMP_BITS,
) -> BlockReport:
    """TPI SRAM macro costed with [26]'s published macro numbers, scaled
    from 346x260x18b to the comparison resolution/precision."""
    scale = (h * w * n_bits) / (C.TPI_H * C.TPI_W * C.TPI_BITS)
    p_static = C.TPI_STATIC_POWER_W * scale
    p_write = C.TPI_WRITE_ENERGY_PER_EVENT_J * rate_eps
    area = C.SRAM_CELL_AREA_PER_BIT_M2 * n_bits * h * w
    return BlockReport(
        power_w={"static": p_static, "write": p_write},
        area_m2={"array": area},
        delay_s={},
    )


def isc_array_report(
    h: int = C.QVGA_H, w: int = C.QVGA_W,
    rate_eps: float = C.EVENT_RATE_EPS,
) -> BlockReport:
    return BlockReport(
        power_w=isc_array_power(h, w, rate_eps),
        area_m2={"array": C.ISC_CELL_AREA_M2 * h * w},
        delay_s={},
    )


# ----------------------------------------------------------------------------
# runtime energy metering (the serving stack's per-sensor accountant)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EnergyCosts:
    """The static per-operation cost card of one fidelity mode:
    J per event written, J per cell per readout dispatch, and W of
    retention leakage per cell.  Derived once from the same analytic
    models Fig. 7/8 are derived from, then multiplied by exact runtime
    counters (events, dispatches, wall-clock retention) host-side."""

    mode: str
    write_j_per_event: float
    read_j_per_cell: float
    leak_w_per_cell: float


class EnergyMeter:
    """Attributes modeled energy to runtime activity, per fidelity mode.

    The serving stack's counters are exact (events ingested, fused
    dispatches, retention wall-clock); this class turns them into joules
    using the mode's substrate model:

    ``ideal``      the digital baseline — 16-bit SRAM SAE storage costed
                   with [53]'s per-bit write energy and leakage (the
                   paper's Fig. 8 comparison axis)
    ``analog_3d``  the MOMCAP cell: CV^2 write through the LL switch,
                   source-follower read, capacitor retention leakage
    ``analog_2d``  the 3D cell costs plus the 2D integration's per-event
                   long-wire buffer + AER enc/dec energy (Fig. 7c)

    Reads are costed per *cell per dispatch* (a fused spec read samples
    the whole per-slot array once); leakage is costed per cell over the
    retention window actually served (wall-clock between attach and the
    accounting instant).  All methods are pure host float math — the
    meter never touches device state, so metering cannot perturb the
    bitwise replay contract.
    """

    def __init__(
        self,
        h: int = C.QVGA_H,
        w: int = C.QVGA_W,
        polarities: int = 2,
        cmem_f: float = C.ISC_CMEM_F,
        n_bits: int = C.TIMESTAMP_BITS,
    ):
        self.h, self.w, self.polarities = h, w, polarities
        self.cmem_f, self.n_bits = cmem_f, n_bits
        self._costs: Dict[str, EnergyCosts] = {}

    @property
    def cells(self) -> int:
        """Cells of one sensor's array (polarity planes included)."""
        return self.h * self.w * self.polarities

    def costs(self, mode: str) -> EnergyCosts:
        card = self._costs.get(mode)
        if card is not None:
            return card
        if mode == "ideal":
            e_w = C.SRAM_WRITE_ENERGY_PER_BIT_J * self.n_bits
            card = EnergyCosts(
                mode=mode,
                write_j_per_event=e_w,
                # SRAM reads cost less than writes (Sec. IV-B's 1.5-6x
                # band); take the conservative end, same as spice_fit
                read_j_per_cell=e_w / C.SRAM_WRITE_READ_RATIO,
                leak_w_per_cell=(C.SRAM_LEAKAGE_PER_CELL_A
                                 * C.SRAM_VDD_V * self.n_bits),
            )
        elif mode in ("analog_3d", "analog_2d"):
            e_w = cell_write_energy(self.cmem_f)
            if mode == "analog_2d":
                # every event also charges one WBL + one WWL through the
                # tapered drivers, plus the AER enc/dec handshake — the
                # same per-event energies arch_2d charges (Fig. 7c)
                wire_um = self.h * 3.9 + self.w * 4.8
                c_wire = (WIRE_CAP_PER_UM_F * wire_um
                          * CROSSBAR_AREA_OVERHEAD)
                e_buf = BUFFER_CHAIN_OVERHEAD * c_wire * C.VDD_V**2
                e_w = e_w + (1.0 + ENCDEC_TO_BUFFER_RATIO) * e_buf
            card = EnergyCosts(
                mode=mode,
                write_j_per_event=e_w,
                read_j_per_cell=(READ_WRITE_ENERGY_RATIO
                                 * cell_write_energy(self.cmem_f)),
                leak_w_per_cell=cell_leakage_power(self.cmem_f),
            )
        else:
            raise ValueError(f"unknown fidelity mode {mode!r}")
        self._costs[mode] = card
        return card

    def write_energy_j(self, mode: str, n_events: int) -> float:
        """Ingest cost: write energy x events scattered into the array."""
        return self.costs(mode).write_j_per_event * n_events

    def read_energy_j(self, mode: str, n_dispatches: int = 1) -> float:
        """Readout cost: per-cell access energy x the whole array, per
        fused dispatch that sampled this sensor's slot."""
        return self.costs(mode).read_j_per_cell * self.cells * n_dispatches

    def leakage_energy_j(self, mode: str, window_s: float) -> float:
        """Retention cost: leakage power x cells x the served window."""
        return self.costs(mode).leak_w_per_cell * self.cells * window_s


def compare_isc_sram(**kw) -> Dict[str, float]:
    """Fig. 8: power and area ratios of SRAM implementations over ISC."""
    isc = isc_array_report(**kw)
    s53 = sram_array_ref53(**kw)
    s26 = sram_array_ref26(**kw)
    return {
        "power_ratio_ref53": s53.total_power / isc.total_power,
        "power_ratio_ref26": s26.total_power / isc.total_power,
        "area_ratio_ref53": s53.total_area / isc.total_area,
        "area_ratio_ref26": s26.total_area / isc.total_area,
        "isc_power_w": isc.total_power,
        "sram53_power_w": s53.total_power,
        "sram26_power_w": s26.total_power,
    }
