"""The train step's share of the card's peak while the device is busy
(``readers.mfu``, ``counts.train_flops``). The rate is about mfu x (1 -
idle) x peak over the operations an example."""

from climbbench.metrics import counts, readers


def read(r):
    return readers.mfu(r, counts.train_flops)
