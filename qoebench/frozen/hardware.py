"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit), and the pacing
spec the harness hands the engine.

``H100_ROOFLINE`` is a roofline with no discount: efficiency 1, no fixed
overhead, host DMA at PCIe 5.0 x16's 64 GB/s. No step can run faster than
it prices, so an engine paced by it never holds device work back, and a
gain on the card reaches the wall clock.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12        # FLOP/s, tensor cores, bf16 dense
PEAK_HBM_BW = 3.35e12           # bytes/s
NVLINK_BW = 450e9               # bytes/s per direction (NVLink 4, 18 links)
PCIE5_X16_BW = 64e9             # bytes/s, host <-> device

H100_ROOFLINE = dict(name="h100-roofline", peak_flops=PEAK_BF16_FLOPS,
                     hbm_bw=PEAK_HBM_BW, link_bw=NVLINK_BW, chips=1,
                     host_dma_bw=PCIE5_X16_BW, efficiency=1.0, overhead=0.0)


def hardware_spec():
    """``H100_ROOFLINE`` as the port's ``HardwareSpec``."""
    from repro_torch.core.latency_model import HardwareSpec
    return HardwareSpec(**H100_ROOFLINE)
