"""The span readers (``metrics/spans.py``) on a trace made by hand and on a
traced CPU run: the offset between the port's clock and the trace's
recovered from ``bench.step``, device time charged to the spans open at each
launch on any thread, idle gaps charged to the span of the launch that ends
them, nothing read where the records are empty or do not line up, and every
new metric resolving through the manifest."""

import types

import pytest

from climbbench import measure
from climbbench.common import HARNESS, Manifest
from climbbench.metrics import spans
from climbbench.tests.tiny import run_cell
from climbbench.trace import Trace

BASE_US = 1_760_000_000 * 10**6  # the trace's base time: a whole second, in microseconds
CELLS = {"train": "vilt-b32.train-snlive-b64", "viltbert": "viltbert.train-snlive-b64",
         "eval": "vilt-b32.eval-snlive-b64"}
NEW = {
    "train": ["forward_ms_per_step.train", "backward_ms_per_step.train",
              "optimizer_ms_per_step.train", "pad_pct.train"],
    "viltbert": ["forward_ms_per_step.viltbert", "backward_ms_per_step.viltbert",
                 "optimizer_ms_per_step.viltbert", "text_encoder_ms.viltbert",
                 "text_encoder_idle_ms.viltbert", "text_encoder_launches.viltbert",
                 "pad_pct.viltbert"],
    "eval": ["embed_ms_per_step.eval", "encoder_ms_per_step.eval", "pad_pct.eval"],
}


def event(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def kernel(corr, launch_ts, start, dur, tid=1):
    return [event("cuda_runtime", "cudaLaunchKernel", launch_ts, 1, tid=tid, corr=corr),
            event("kernel", f"k{corr}", start, dur, tid=9, corr=corr)]


def hand_trace():
    """A 1000 us window of two steps (10-480, 500-990). Kernels: 100-120
    launched in the text encoder, 120-140 in the embeddings, 260-300 from a
    second thread inside the backward, 300-340 in the optimizer, 710-760
    from the second thread in the second step's backward, 770-780 outside
    every span of the port's. Idle: 0-100, 140-260, 340-710, 760-770,
    780-1000."""
    return Trace([
        event("user_annotation", "bench.window", 0, 1000),
        event("user_annotation", "bench.step", 10, 470),
        event("user_annotation", "bench.step", 500, 490),
        *kernel(1, 45, 100, 20), *kernel(2, 95, 120, 20), *kernel(3, 250, 260, 40, tid=2),
        *kernel(4, 420, 300, 40), *kernel(5, 700, 710, 50, tid=2), *kernel(6, 475, 770, 10),
    ], steps=2)


def record(name, start, end, parent=None, tid=1, shift_us=0.0):
    """A span record of the port's at trace times ``start``-``end`` (us)."""
    return {"name": name, "parent": parent, "tid": tid,
            "start_ns": int((start + BASE_US + shift_us) * 1e3),
            "end_ns": int((end + BASE_US + shift_us) * 1e3)}


def records(shift_us=0.0):
    """A profiler warm-up step before the window, then the window's two."""
    out = [record("climb.train_step", -600, -100, shift_us=shift_us)]
    for at in (0, 490):
        def rec(name, a, b, parent="climb.train_step"):
            return record(name, at + a, at + b, parent, shift_us=shift_us)
        out += [rec("climb.forward", 30, 150), rec("climb.text_encoder", 40, 80, "climb.forward"),
                rec("climb.embed", 90, 100, "climb.forward"), rec("climb.backward", 200, 400),
                rec("climb.optimizer", 410, 460), rec("climb.train_step", 20, 470, None)]
    return out


def reading(trace, snap, monkeypatch):
    monkeypatch.setattr(spans, "port_snapshot", lambda: snap)
    return types.SimpleNamespace(trace=trace)


def test_the_offset_is_recovered_from_the_harness_steps():
    t = hand_trace()
    assert spans.offset_us(records(), t) == -BASE_US
    # a few microseconds of disagreement between the clocks round away
    assert spans.offset_us(records(shift_us=7.3), t) == -BASE_US


def test_device_time_is_charged_to_the_spans_open_at_the_launch():
    c = spans.Charges(hand_trace(), records(), -BASE_US)
    assert c.by_innermost() == pytest.approx({
        "climb.text_encoder": 20e-6, "climb.embed": 20e-6, "climb.backward": 90e-6,
        "climb.optimizer": 40e-6, "": 10e-6})
    # the second thread's kernels fall inside the main thread's climb.backward
    assert c.device_ms("climb.backward") == pytest.approx(0.045)
    assert c.device_ms("climb.forward") == pytest.approx(0.02)
    assert c.device_ms("climb.train_step") == pytest.approx(0.085)
    assert c.launches("climb.text_encoder") == 0.5
    assert c.launches("climb.backward") == 1.0


def test_idle_gaps_are_charged_to_the_span_of_the_launch_that_ends_them():
    c = spans.Charges(hand_trace(), records(), -BASE_US)
    assert c.idle_ms("climb.text_encoder") == pytest.approx(0.05)  # 0-100
    assert c.idle_ms("climb.backward") == pytest.approx((120 + 370) / 2e3)  # 140-260, 340-710
    assert c.idle_ms("climb.forward") == pytest.approx(0.05)
    assert sum(s for s, _ in c.gaps) == pytest.approx(sum(s for s, _ in hand_trace().idle_gaps()))


def test_the_readers_read_the_hand_trace(monkeypatch):
    manifest = Manifest(HARNESS.parent)
    r = reading(hand_trace(), {"spans": records(), "counters": {"tokens": 750.0,
                                                              "token_slots": 1000}},
                monkeypatch)
    want = {"backward_ms_per_step.train": 0.045, "forward_ms_per_step.viltbert": 0.02,
            "optimizer_ms_per_step.viltbert": 0.02, "text_encoder_ms.viltbert": 0.01,
            "text_encoder_idle_ms.viltbert": 0.05, "text_encoder_launches.viltbert": 0.5,
            "embed_ms_per_step.eval": 0.01, "pad_pct.train": 25.0, "pad_pct.eval": 25.0}
    for name, value in want.items():
        assert manifest.reader(name).read(r) == pytest.approx(value), name
    # no kernel launched inside the encoder: nothing to read
    assert manifest.reader("encoder_ms_per_step.eval").read(r) is None


@pytest.mark.parametrize("snap", [
    None,  # a program without the tracing module
    {"spans": [], "counters": {}},  # nothing recorded
    {"spans": records()[1:7], "counters": {}},  # fewer step records than steps
    {"spans": records(shift_us=0.6e6), "counters": {}},  # off by more than half a second
    {"spans": records(shift_us=2e3), "counters": {}},  # off by 2 ms: outside bench.step
], ids=["no-module", "empty", "too-few", "half-a-second", "two-ms"])
def test_records_that_do_not_line_up_read_nothing(snap, monkeypatch):
    manifest = Manifest(HARNESS.parent)
    r = reading(hand_trace(), snap, monkeypatch)
    assert spans.charges(r) is None
    for names in NEW.values():
        for name in names:
            if not name.startswith("pad_pct"):
                assert manifest.reader(name).read(r) is None, name
    assert spans.charges(types.SimpleNamespace(trace=None)) is None


def test_every_new_metric_resolves_for_its_cell():
    manifest = Manifest(HARNESS.parent)
    manifest.resolve_all()
    for kind, names in NEW.items():
        listed = [m["name"] for m in manifest.metrics(CELLS[kind], True)]
        assert set(names) <= set(listed), kind
        for name in names:
            assert manifest.reader(name).read(types.SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_a_traced_cpu_run_lines_up_and_counts_its_padding(kind, monkeypatch):
    """The port's records of a traced run on the CPU fall on the trace's
    clock; the CPU has no device operation to charge, so only the padding
    share reads."""
    traces = []
    whole = measure.traced_window

    def keep(*args, **kwargs):
        out = whole(*args, **kwargs)
        traces.append(out[0])
        return out

    monkeypatch.setattr(measure, "traced_window", keep)
    rc, result = run_cell(CELLS[kind], trace=1, dtype="float32")
    assert rc == 0 and result["correct"], result
    assert 0 < result["metrics"][f"pad_pct.{kind}"]["value"] < 100
    c = spans.charges(types.SimpleNamespace(trace=traces[0]))
    assert c is not None and c.steps == traces[0].steps
