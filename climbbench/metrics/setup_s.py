"""Seconds from the start of the harness's process to the first timed step:
imports, the kernels' build or its reuse, the learner and its weights, the
pool of batches, the checked and warm-up steps."""


def read(r):
    return r.setup_s
