"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, dense rates, at the card's full power limit). A roofline or an
mfu against them names the card beside the number."""

from __future__ import annotations

PEAKS = {
    # H100 SXM5 80GB: FP32 67 TFLOP/s (no tensor cores), FP64 34 TFLOP/s,
    # HBM3 3.35 TB/s
    "H100": {"fp32_flops": 67e12, "fp64_flops": 34e12, "hbm_bytes": 3.35e12},
}


def peaks_for(device_name: str):
    """The peaks of a card by its name, None for a card not in the
    table."""
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None
