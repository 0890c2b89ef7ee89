"""Hardware configurations.

``PAPER_HW`` reproduces Table III of the paper (the reproduction baseline).
``TPU_V5E`` is the adaptation target used by the pod-level planner and the
roofline analysis (constants from the assignment).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class HWConfig:
    name: str
    pe_rows: int = 32
    pe_cols: int = 32
    dot_product_size: int = 8          # MACs per PE per cycle (Table III)
    bytes_per_word: int = 1            # Table III: 8-bit words
    sram_bytes: int = 1 << 20          # 1 MB global buffer
    rf_bytes_per_pe: int = 512         # per-PE register file
    dram_bw_bytes_per_cycle: float = 256.0  # 256 GB/s at 1 GHz
    # relative energy per word: register/NoC-hop/SRAM/DRAM
    # (Eyeriss-style ratios; only *relative* numbers matter for Figs. 13-14)
    e_rf: float = 1.0
    e_hop: float = 2.0
    e_sram: float = 6.0
    e_dram: float = 200.0

    @property
    def num_pes(self) -> int:
        return self.pe_rows * self.pe_cols

    @property
    def rf_total_bytes(self) -> int:
        return self.num_pes * self.rf_bytes_per_pe

    @property
    def max_depth(self) -> int:
        """Sec. IV-A: the maximum depth we consider is sqrt(numPEs)."""
        return int(math.isqrt(self.num_pes))

    @property
    def macs_per_cycle(self) -> int:
        return self.num_pes * self.dot_product_size

    @property
    def amp_link_len(self) -> int:
        """AMP express-link length: Round(sqrt(rows/2)) (Sec. IV-D)."""
        return max(2, round(math.sqrt(self.pe_rows / 2)))


PAPER_HW = HWConfig(name="paper-table-iii")

#: TPU v5e-ish constants for the pod-level planner (per chip).
TPU_V5E = HWConfig(
    name="tpu-v5e",
    pe_rows=16, pe_cols=16,            # the 16x16 chip mesh of one pod
    dot_product_size=8,
    bytes_per_word=2,                  # bf16
    sram_bytes=128 << 20,              # VMEM
    rf_bytes_per_pe=16 << 30,          # per-"PE" (=chip) memory: HBM
    dram_bw_bytes_per_cycle=819.0,     # GB/s HBM
    e_rf=1.0, e_hop=8.0, e_sram=2.0, e_dram=64.0,
)

# The reference's TPU roofline constants (``PEAK_FLOPS_BF16``, ``HBM_BW``,
# ``ICI_BW_PER_LINK``, ``ICI_LINKS_PER_CHIP``) price a TPU v5e chip and
# its ICI links; the port runs on NVIDIA H100 cards joined by NVLink, so
# its roofline and the pod-level stage placement
# (``distributed.pipeline.placement_cost``) read the card's constants
# instead.  Source: NVIDIA H100 Tensor Core GPU datasheet, SXM5 column
# (dense rates, without sparsity), and the NVLink 4 figures of the
# NVIDIA Hopper architecture whitepaper (18 links, 900 GB/s in total).

#: dense bf16 tensor-core peak of one H100 SXM, FLOP/s
H100_PEAK_FLOPS_BF16 = 989e12
#: HBM3 bandwidth of one H100 SXM, B/s
H100_HBM_BW = 3.35e12
#: device memory of one H100 SXM, bytes (80 GB)
H100_HBM_BYTES = 80e9
#: NVLink 4 bandwidth of one link, B/s (both directions: 900 GB/s / 18)
H100_NVLINK_BW_PER_LINK = 50e9
#: NVLink 4 links of one H100 SXM
H100_NVLINK_LINKS = 18
