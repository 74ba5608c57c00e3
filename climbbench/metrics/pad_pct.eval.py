"""Share of the encoder's token positions that are padding, from the port's
counters ``tokens`` and ``token_slots``, in `vilt-b32`'s traced eval
steps: ``spans.pad_pct``."""

from climbbench.metrics import spans

read = spans.pad_pct
