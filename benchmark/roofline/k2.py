"""K2, the match count: Q query sketches against G stored sketches of F
slots, each slot a fingerprint of b = W + 1 bits (W value bits and the
bit that marks a slot that matches nothing).

Bytes: the queries and the stored fingerprints read once, (Q + G) F b / 8,
and the counts written once at the width the call returns. Operations:
one three-input bitwise operation per bit per 32 slots and pair,
Q G F b / 32, the fewest a bit-sliced equality needs.
"""


def work(Q: int, G: int, F: int, b: int, out_bytes: int
         ) -> tuple[float, float]:
    """(bytes, int32 operations) of one count call."""
    return (Q + G) * F * b / 8 + out_bytes, Q * G * F * b / 32
