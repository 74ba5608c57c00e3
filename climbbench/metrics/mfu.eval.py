"""The eval step's share of the card's peak while the device is busy
(``readers.mfu``, ``counts.forward_flops``)."""

from climbbench.metrics import counts, readers


def read(r):
    return readers.mfu(r, counts.forward_flops)
