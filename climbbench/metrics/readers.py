"""What several metrics read the same way, each metric's file binding one of
these to its own name: a metric of one cell kind or configuration reads as
another's does, and moves its own cells' end-to-end metric."""

import re
import statistics

from climbbench.metrics import counts, kernels

# cuBLAS and CUTLASS kernels by name; the port's own GEMM kernels are not among them
LIBRARY = re.compile(r"gemm|gemv|xmma|nvjet|cutlass|cublas|splitKreduce", re.IGNORECASE)
FFN_KERNELS = ("linear_bf16_wgmma_kernel", "linear_f32_simt_kernel")
ATTENTION_BWD_KERNELS = ("attention_bwd_dq_bf16_kernel", "attention_bwd_dkdv_bf16_kernel",
                         "attention_bwd_dq_kernel", "attention_bwd_dkdv_kernel")


def examples_per_s(r):
    """Every example of every step dispatched in the window, over the
    window's seconds (a synchronisation before the first step to one after
    the last)."""
    return r.window.steps * r.examples_per_step / r.window.seconds


def step_ms_p95(r):
    """The 95th percentile of the window's step times, each the interval
    between the device events recorded at consecutive step ends."""
    ms = r.window.step_ms
    if len(ms) < 2:
        return ms[0] if ms else None
    return statistics.quantiles(ms, n=100, method="inclusive")[94]


def idle_pct(r):
    """Share of the traced window in which no kernel, copy or set ran."""
    t = r.trace
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def host_ms_per_step(r):
    """Host milliseconds a step inside the call into the port, the mean over
    the untraced host-clock steps."""
    if r.host is None or not r.host.host_s:
        return None
    return 1e3 * sum(r.host.host_s) / len(r.host.host_s)


def mfu(r, flops_per_example):
    """Model operations of the traced steps' examples over the trace's
    device-busy seconds and the compute dtype's peak rate."""
    t = r.trace
    if t is None or not t.ops:
        return None
    flops = t.steps * r.examples_per_step * flops_per_example(r.config, r.traffic)
    return 100.0 * flops / (t.busy_s * counts.peak_flops(r.config))


def library_gemm_ms(r):
    """Device milliseconds a traced step in library matrix products."""
    if r.trace is None:
        return None
    seconds = r.trace.device_s(LIBRARY.search)
    return 1e3 * seconds / r.trace.steps if seconds else None


def mlp_fwd_roofline(r):
    """The FFN kernel (two GEMM launches a call) against its bound at the
    step's rows."""
    b, s, _, _, dtype = kernels.shape(r)
    c = r.config
    bound = counts.mlp_fwd_bound_s(b * s, c["hidden_size"], c["intermediate_size"], dtype)
    return kernels.roofline_pct(r, "mlp_fwd", FFN_KERNELS, bound)


def attention_bwd_roofline(r):
    """The attention backward (the dQ and the dK/dV launches a call)
    against its bound at the step's (batch, S, heads, head size)."""
    return kernels.roofline_pct(r, "attention_bwd", ATTENTION_BWD_KERNELS,
                                counts.attention_bwd_bound_s(*kernels.shape(r)))
