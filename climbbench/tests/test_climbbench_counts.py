"""The operation and byte counts behind ``mfu.*`` and ``*_roofline``, the
trace reduction, and the readers on a trace made by hand."""

import types

import pytest

from climbbench.common import HARNESS, Manifest, load_json
from climbbench.metrics import counts, kernels
from climbbench.trace import Trace

VILT = load_json(HARNESS / "configs" / "vilt-b32.json")
VILTBERT = load_json(HARNESS / "configs" / "viltbert.json")
TRAIN = load_json(HARNESS / "traffic" / "train-snlive-b64.json")


def test_sequence_is_text_cls_and_every_patch():
    assert counts.seq_len(VILT, TRAIN) == 40 + 1 + 12 * 20 == 281


def test_vilt_train_step_is_151_9_gflop_an_example():
    s, d = 281, 768
    assert counts.train_flops(VILT, TRAIN) == 3 * 12 * (24 * s * d * d + 4 * s * s * d)
    assert round(counts.train_flops(VILT, TRAIN) / 1e9, 1) == 151.9
    assert counts.forward_flops(VILT, TRAIN) == counts.train_flops(VILT, TRAIN) / 3


def test_bert_forward_at_forty_tokens():
    bert = counts.encoder_flops(12, 40, 768)
    assert round(bert / 1e9, 2) == 6.85
    assert counts.train_flops(VILTBERT, TRAIN) == counts.train_flops(VILT, TRAIN) + bert
    assert round(counts.train_flops(VILTBERT, TRAIN) / 1e9, 1) == 158.8


@pytest.mark.parametrize("bound_ms, got", [
    (0.1716, lambda: counts.mlp_fwd_bound_s(17984, 768, 3072)),
    (0.0330, lambda: counts.attention_fwd_bound_s(64, 281, 12, 64)),
    (0.0289, lambda: counts.attention_bwd_bound_s(32, 281, 12, 64)),
    (2.5331, lambda: counts.mlp_fwd_bound_s(17984, 768, 3072, "float32")),
    (0.2317, lambda: counts.attention_fwd_bound_s(64, 281, 12, 64, "float32")),
])
def test_kernel_bounds_of_the_kernel_table(bound_ms, got):
    assert round(got() * 1e3, 4) == bound_ms


def event(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def hand_trace():
    """A 100 us window: two steps; kernels at 10-30 and 40-60 (one launched
    inside bench.bert), a copy at 55-70; idle 0-10, 30-40, 70-100."""
    return Trace([
        event("user_annotation", "bench.window", 0, 100),
        event("user_annotation", "bench.step", 1, 45),
        event("user_annotation", "bench.step", 50, 45),
        event("user_annotation", "bench.bert", 2, 5),
        event("cpu_op", "aten::mm", 2, 3),
        event("cpu_op", "aten::linear", 20, 20),
        event("cuda_runtime", "cudaLaunchKernel", 3, 1, corr=1),
        event("cuda_runtime", "cudaLaunchKernel", 21, 1, corr=2),
        event("kernel", "sm90_xmma_gemm_bf16", 10, 20, tid=7, corr=1),
        event("kernel", "linear_bf16_wgmma_kernel", 40, 20, tid=7, corr=2),
        event("gpu_memcpy", "Memcpy DtoD", 55, 15, tid=8),
        event("kernel", "outside", 150, 10, tid=7),
    ], steps=2)


def test_trace_busy_idle_and_spans():
    t = hand_trace()
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(50e-6)
    assert t.device_s(lambda n: "gemm" in n) == pytest.approx(20e-6)
    assert t.device_s_under("bench.bert") == pytest.approx(20e-6)
    assert t.device_s_under("bench.nothing") is None
    gaps = t.idle_gaps()
    assert [round(s * 1e6) for s, _ in gaps] == [10, 10, 30]
    assert gaps[1][1] == "bench.step/aten::linear"
    assert gaps[2][1] == "window end"
    top = t.breakdown()
    assert top["device_ops"][0][1] == pytest.approx(20e-6)
    assert sum(s for _, s in top["idle_gaps"]) == pytest.approx(50e-6)


def reading(trace, launches, config=VILT, traffic=TRAIN):
    return types.SimpleNamespace(trace=trace, launches=launches, config=config,
                                 traffic=traffic, examples_per_step=traffic["batch"], host=None)


def test_readers_read_the_hand_trace():
    manifest = Manifest(HARNESS.parent)
    r = reading(hand_trace(), {"mlp_fwd": 1})
    assert manifest.reader("idle_pct.train").read(r) == pytest.approx(50.0)
    assert manifest.reader("gemm_ms_per_step.train").read(r) == pytest.approx(0.01)
    assert manifest.reader("bert_ms_per_step").read(r) == pytest.approx(0.01)
    bound = counts.mlp_fwd_bound_s(64 * 281, 768, 3072)
    assert manifest.reader("mlp_fwd_roofline.train").read(r) == pytest.approx(
        100 * bound / 20e-6)
    f32 = reading(hand_trace(), {"mlp_fwd": 2},
                  config={**VILT, "port": {**VILT["port"], "compute_dtype": "float32"}})
    assert manifest.reader("mlp_fwd_roofline.eval").read(f32) == pytest.approx(
        100 * counts.mlp_fwd_bound_s(64 * 281, 768, 3072, "float32") / 10e-6)


def test_readers_find_nothing_and_return_nothing():
    manifest = Manifest(HARNESS.parent)
    empty = reading(None, {})
    for name in ("idle_pct.train", "gemm_ms_per_step.train", "bert_ms_per_step",
                 "mlp_fwd_roofline.eval", "attention_fwd_roofline.eval",
                 "attention_bwd_roofline.train", "mfu.train", "host_ms_per_step.eval"):
        assert manifest.reader(name).read(empty) is None, name
    no_calls = reading(hand_trace(), {"attention_fwd": 0})
    assert manifest.reader("attention_fwd_roofline.eval").read(no_calls) is None
    no_kernel = reading(hand_trace(), {"attention_bwd": 3})
    assert kernels.roofline_pct(no_kernel, "attention_bwd", ("absent",), 1.0) is None


def test_mfu_reads_the_device_busy_time():
    manifest = Manifest(HARNESS.parent)
    r = reading(hand_trace(), {})
    assert counts.peak_flops(VILT) == 989e12
    flops = 2 * 64 * counts.train_flops(VILT, TRAIN)
    assert manifest.reader("mfu.train").read(r) == pytest.approx(100 * flops / (50e-6 * 989e12))
    assert manifest.reader("mfu.eval").read(r) == pytest.approx(
        100 * flops / 3 / (50e-6 * 989e12))


def test_host_ms_reads_the_host_window():
    manifest = Manifest(HARNESS.parent)
    r = reading(None, {})
    r.host = types.SimpleNamespace(steps=10, seconds=1.0, host_s=[0.002] * 10)
    assert manifest.reader("host_ms_per_step.train").read(r) == pytest.approx(2.0)
