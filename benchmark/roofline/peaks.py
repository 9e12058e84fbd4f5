"""Peaks of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W limit.

HBM: 3.35 TB/s (NVIDIA's data sheet). int32 instructions: 132 SMs x 64
lanes x 1.98 GHz, the rate a three-input bitwise operation or an add
issues at. A card set below 700 W runs slower under load; a roofline share
is stated beside the card's power limit.
"""

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take for the bytes and int32
    operations of a call: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
