"""K1, the batched sort of B rows of N int32 keys: each key read once and
written once, 8 B a key; a sort's compare work is not the bound on this
card."""


def work(B: int, N: int) -> tuple[float, float]:
    """(bytes, int32 operations) of one sort call."""
    return 8.0 * B * N, 0.0
