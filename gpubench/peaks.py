"""Published peaks of the cards the benchmark knows (NVIDIA data sheets,
dense rates without sparsity, at the card's full power limit)."""

from __future__ import annotations

from typing import Optional

# name as torch.cuda.get_device_name() gives it -> peaks
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},  # SXM
}


def of(kind: Optional[str]) -> Optional[dict]:
    """The peaks of card ``kind``, or None for a card not in the table."""
    return PEAKS.get(kind or "")
