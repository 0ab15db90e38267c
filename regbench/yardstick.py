"""Peaks of the cards the benchmark knows, and the least time of K1.

The peaks are published figures (NVIDIA H100 data sheet, SXM part, dense
rates): 67 TFLOP/s in float32 outside the tensor cores, counting a fused
multiply-add as two operations, so 33.5e12 single add, subtract or
multiply instructions a second; 3.35 TB/s of HBM3. They hold at the card's
full power limit of 700 W; a traced run prints the card's limit beside its
numbers. A card not in the table has no roofline here: its readers return
nothing.
"""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_ops_per_s": 67e12 / 2, "hbm_bytes_per_s": 3.35e12},
}

# The TRIM predicate of one pair: for each cloud 3 subtractions, 3
# multiplications and 2 additions (the squared distance), then the sum, the
# difference, 2 multiplications and ``2 s - b2``, one fused multiply-add
# (doubling is exact, so fused it rounds as the separate operations do):
# 20 add/sub/mul instructions and one FMA.
TRIM_OPS_PER_PAIR = 21


def peaks(device_kind: str) -> Optional[dict]:
    return PEAKS.get(device_kind)


def trim_bits_least_s(valid_counts, n: int, device_kind: str) -> Optional[float]:
    """Least time of one K1 launch over problems of ``n`` points, of which
    ``valid_counts`` (one per problem) are valid.

    The work is what the inputs need, whatever the kernel does: the
    predicate is symmetric and a diagonal or padded pair needs none, so one
    predicate per unordered pair of valid points. The bytes: each problem's
    points and validity read once and its ``ceil(n/32) n`` words written
    once. The larger of the two times bounds the launch.
    """
    pk = peaks(device_kind)
    if pk is None:
        return None
    pairs = sum(m * (m - 1) // 2 for m in valid_counts)
    words = (n + 31) // 32
    nbytes = len(valid_counts) * (2 * 3 * n * 4 + n + words * n * 4)
    return max(TRIM_OPS_PER_PAIR * pairs / pk["fp32_ops_per_s"],
               nbytes / pk["hbm_bytes_per_s"])
