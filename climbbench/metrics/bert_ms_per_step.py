"""Device milliseconds a step launched inside the span ``bench.bert``, which
forward hooks on ViLT-BERT's BERT module open and close."""


def read(r):
    if r.trace is None:
        return None
    seconds = r.trace.device_s_under("bench.bert")
    return 1e3 * seconds / r.trace.steps if seconds else None
