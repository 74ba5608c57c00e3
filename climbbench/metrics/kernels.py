"""What the ``*_roofline`` readers share: a kernel's share of its bound,
from its device time in the trace and its launch count."""

from climbbench.metrics import counts


def roofline_pct(reading, op, kernels, bound_s):
    """100 x the bound of one call over the measured seconds a call: the
    trace's time in the device functions whose names hold one of
    ``kernels`` over the calls of ``op`` that ``LAUNCHES`` counted in the
    window. None without a trace or a call."""
    trace, calls = reading.trace, reading.launches.get(op, 0)
    if trace is None or not calls:
        return None
    seconds = trace.device_s(lambda name: any(k in name for k in kernels))
    return 100.0 * bound_s / (seconds / calls) if seconds else None


def shape(reading):
    """(batch, S, heads, head size, compute dtype) of the cell's step."""
    c = reading.config
    heads = c["num_attention_heads"]
    return (reading.traffic["batch"], counts.seq_len(c, reading.traffic), heads,
            c["hidden_size"] // heads, counts.compute_dtype(c))
