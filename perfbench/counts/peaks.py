"""Published peaks of the cards the benchmark knows (NVIDIA's H100 SXM data
sheet, dense rates without sparsity, at the full 700 W power limit).

`peak(device_name, kind)` is None for a card the table lacks, and a reader
that needs it then reports nothing.
"""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,  # tensor cores, dense
        "fp32_flops": 67e12,  # outside the tensor cores
        "fp32_issue": 33.5e12,  # one fp32 operation per issue slot (half of the FMA rate)
        "hbm_bytes": 3.35e12,
    },
}


def peak(device_name: str, kind: str) -> Optional[float]:
    return PEAKS.get(device_name, {}).get(kind)
