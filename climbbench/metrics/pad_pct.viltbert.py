"""Share of the encoder's token positions that are padding, from the port's
counters ``tokens`` and ``token_slots``, in `viltbert`'s traced train
steps: ``spans.pad_pct``."""

from climbbench.metrics import spans

read = spans.pad_pct
