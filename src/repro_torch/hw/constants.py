"""Hardware constants: the circuit constants published in the 3DS-ISC
paper (Sec. IV-B) and its references (a copy of ``repro.hw.constants``
without its accelerator roofline section, which the port does not use).

All values carry a comment citing where they come from.  Nothing in this
file is tuned to "make the ratios come out right": the Fig. 7/8 ratios are
*derived* downstream.
"""
from __future__ import annotations

# ----------------------------------------------------------------------------
# Paper circuit constants (65 nm CMOS unless stated)
# ----------------------------------------------------------------------------

#: Sensor resolution used for all architecture comparisons in the paper (QVGA).
QVGA_H = 240
QVGA_W = 320

#: Representative modern DVS event rate used for dynamic power (Sec. IV-B).
EVENT_RATE_EPS = 100e6  # 100 Meps

#: Cu-Cu hybrid-bond energy per byte [Ku et al., ICCAD'18], Sec. II-A.
CUCU_ENERGY_PER_BYTE_J = 0.7e-15  # 0.7 fJ/B

#: Cu-Cu bond parasitics [Ku et al.]: 0.5 fF capacitance, 0.2 ohm resistance.
CUCU_CAP_F = 0.5e-15
CUCU_RES_OHM = 0.2

#: Cu-Cu bonding transfer latency (Sec. IV-B, Fig. 7 discussion).
CUCU_LATENCY_S = 0.08e-9  # ~0.08 ns

#: Event-write latency into the cell, common to 2D and 3D (Fig. 7).
EVENT_WRITE_LATENCY_S = 5e-9  # ~5 ns

#: 2D-only encoder/decoder + AER handshake latency (Fig. 7: ~6 ns, 46.4 %).
ENCDEC_LATENCY_2D_S = 6e-9

#: SRAM write energy per bit [Bose et al., JSSC'21 ref 53].
SRAM_WRITE_ENERGY_PER_BIT_J = 5.1e-12  # 5.1 pJ/bit

#: SRAM static leakage per cell at 1 V [ref 53].
SRAM_LEAKAGE_PER_CELL_A = 350e-12  # 350 pA
SRAM_VDD_V = 1.0

#: TPI SRAM macro [Rios-Navarro et al., ref 26]: 346x260 px * 18 b, 35 mW static.
TPI_STATIC_POWER_W = 35e-3
TPI_H = 260
TPI_W = 346
TPI_BITS = 18
#: 7x7-patch SRAM access energy (ref 26) and write:read energy ratio (refs 53, 54).
TPI_PATCH_ACCESS_ENERGY_J = 2.4e-9
SRAM_WRITE_READ_RATIO = 1.5  # conservative end of the 1.5-6x range (Sec. IV-B)
#: Per-event timestamp write energy for the TPI ASIC (Sec. II-C).
TPI_WRITE_ENERGY_PER_EVENT_J = 0.072e-9

#: Timestamp bit width for digital SAE storage comparisons (Sec. II-B: n_T>=16).
TIMESTAMP_BITS = 16

#: 6T-1C ISC cell geometry (Fig. 4f): 4.8 um x 3.9 um under TSMC 65 nm.
ISC_CELL_AREA_M2 = 4.8e-6 * 3.9e-6  # ~20 um^2 (prose: "~20 um^2")
#: MOMCAP value at that footprint (M4-M7 interdigitated), Fig. 4f.
ISC_CMEM_F = 20e-15

#: 65 nm 6T SRAM bitcell area. The paper states the TPI SRAM macro occupies
#: 4.3 mm^2 for 346x260x18 b (Sec. II-C) -> 2.65 um^2/bit including overhead.
SRAM_CELL_AREA_PER_BIT_M2 = 4.3e-6 / (TPI_H * TPI_W * TPI_BITS)  # m^2/bit

#: eDRAM supply. 65 nm core V_dd; the SPICE fit anchors (Fig. 5b) are
#: consistent with a 1.2 V reset level decaying through 0.72/0.46/0.30 V.
VDD_V = 1.2

#: Memory window requirement from the STCF algorithm (Sec. IV-A, [51]).
MEMORY_WINDOW_S = 24e-3

#: V_tw thresholds corresponding to tau_tw = 24 ms (Fig. 10b).
V_TW_20FF_V = 0.383
V_TW_10FF_V = 0.172

#: Fig. 5b Monte-Carlo anchors for C_mem = 20 fF: (delta_t seconds, mean V, CV).
MC_ANCHORS_20FF = (
    (10e-3, 0.72, 0.0010),
    (20e-3, 0.46, 0.0039),
    (30e-3, 0.30, 0.0128),
)

#: Fig. 7 module-level breakdowns for the 2D architecture (fractions of total).
P2D_FRAC_ENCDEC = 0.538   # encoder/decoder power share
P2D_FRAC_BUFFER = 0.455   # WWL/WBL driver buffer power share
LAT2D_FRAC_ENCDEC = 0.464  # encoder/decoder+handshake latency share

#: Headline paper ratios (used only as *expected values in tests*, never as
#: model inputs): 3D-vs-2D and ISC-vs-SRAM.
PAPER_POWER_RATIO_2D_OVER_3D = 69.0
PAPER_AREA_RATIO_2D_OVER_3D = 1.9
PAPER_LATENCY_RATIO_2D_OVER_3D = 2.2
PAPER_SRAM53_POWER_RATIO = 1600.0
PAPER_SRAM26_POWER_RATIO = 6761.0
PAPER_SRAM53_AREA_RATIO = 3.1
PAPER_SRAM26_AREA_RATIO = 2.2
