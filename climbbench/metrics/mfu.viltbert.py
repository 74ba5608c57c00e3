"""ViLT-BERT's train step's share of the card's peak while the device is
busy, BERT's forward counted (``readers.mfu``, ``counts.train_flops``)."""

from climbbench.metrics import counts, readers


def read(r):
    return readers.mfu(r, counts.train_flops)
