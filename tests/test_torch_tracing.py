"""climb_tpu_torch.utils.tracing on the CPU: the port's spans and counters.

Nothing is recorded without a profiler, and ``span`` then hands back the
shared no-op. Under ``torch.profiler`` a train step and an eval step of a
tiny ViLT and a tiny ViLT-BERT record the phases with their parents; every
``climb.*`` span is a ``user_annotation`` of the exported trace, never a
host operator, and each record holds its event on the trace's clock
(``ts`` plus the trace's ``baseTimeNanoseconds``), most within 100 us. The
token counters match a count by hand, and an exported eval step holds no
profiler op.
"""

import io
import json
import zlib
from collections import defaultdict
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.serve import export
from climb_tpu_torch.train.eval_step import make_eval_step
from climb_tpu_torch.train.model_factory import create_cl_model
from climb_tpu_torch.train.optimizer import make_optimizer
from climb_tpu_torch.train.train_state import TrainState
from climb_tpu_torch.train.train_step import make_train_step
from climb_tpu_torch.utils import tracing

torch.set_num_threads(1)

BS, TEXT, HEIGHT, WIDTH, PATCH = 4, 40, 64, 96, 32
STEP = {"climb.prepare_batch": "step", "climb.forward": "step", "climb.metric": "step",
        "climb.embed": "climb.forward", "climb.encoder": "climb.forward",
        "climb.head": "climb.forward"}
TRAIN = {"climb.train_step": None,
         **{k: "climb.train_step" if v == "step" else v for k, v in STEP.items()},
         "climb.loss": "climb.train_step", "climb.backward": "climb.train_step",
         "climb.optimizer": "climb.train_step"}
EVAL = {"climb.eval_step": None,
        **{k: "climb.eval_step" if v == "step" else v for k, v in STEP.items()}}
TEXT_ENCODER = {"climb.text_encoder": "climb.forward"}


def _model(encoder="vilt"):
    args = SimpleNamespace(tiny=True, ordered_cl_tasks=["snli-ve"], encoder_name=encoder, seed=0,
                           compute_dtype="float32", attn_impl="pallas", mlp_impl="pallas",
                           dense_impl="xla")
    return create_cl_model(args, task_configs, torch.device("cpu"))


def _batch(text_lens, cols, seed=0):
    """A batch whose rows hold ``text_lens`` text tokens and images
    ``cols`` patches wide on the full canvas height."""
    rng = np.random.RandomState(seed)
    bs = len(text_lens)
    return {"input_ids": torch.from_numpy(rng.randint(1, 100, (bs, TEXT)).astype(np.int32)),
            "text_mask": torch.from_numpy((np.arange(TEXT) < np.array(text_lens)[:, None])
                                          .astype(np.float32)),
            "pixel_values": torch.from_numpy(rng.randint(0, 256, (bs, HEIGHT, WIDTH, 3))
                                             .astype(np.uint8)),
            "patch_hw": torch.tensor([[HEIGHT // PATCH, c] for c in cols], dtype=torch.int32),
            "labels": torch.from_numpy(rng.randint(0, 3, bs).astype(np.int32)),
            "valid": torch.ones(bs)}


def _steps(model):
    tx = make_optimizer([n for n, _ in model.named_parameters()], lr=1e-4, total_steps=10,
                        trainable_mask=model.trainable_mask)
    state = TrainState.create(model, tx)
    train = make_train_step(model, "snli-ve", "ce", torch.float32)
    return (lambda batch: train(state, batch)), make_eval_step(model, "snli-ve", "ce",
                                                              torch.float32)


@pytest.fixture(autouse=True)
def clean():
    tracing.reset()
    yield
    tracing.reset()


def test_nothing_is_recorded_without_a_profiler():
    assert tracing.span("climb.anything") is tracing.NOOP
    assert not tracing.recording()
    train, evaluate = _steps(_model())
    batch = _batch([5, 12, 40, 1], [3, 2, 1, 3])
    train(batch)
    evaluate(batch)
    tracing.count("token_slots", 7)
    tracing.count_on_device("tokens", torch.ones(()))
    assert tracing.snapshot() == {"spans": [], "counters": {}}


def _traced(steps, path=None):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for step in steps:
            step()
    if path is not None:
        prof.export_chrome_trace(str(path))
    return tracing.snapshot()


@pytest.mark.parametrize("encoder", ["vilt", "viltbert"])
def test_steps_record_their_phases_with_their_parents(encoder):
    train, evaluate = _steps(_model(encoder))
    batch = _batch([5, 12, 40, 1], [3, 2, 1, 3])
    extra = TEXT_ENCODER if encoder == "viltbert" else {}
    for step, want in ((train, {**TRAIN, **extra}), (evaluate, {**EVAL, **extra})):
        tracing.reset()
        spans = _traced([lambda: step(batch)])["spans"]
        assert sorted((s["name"], s["parent"]) for s in spans) == sorted(want.items())
        outer = {s["name"]: s for s in spans}
        for s in spans:
            assert s["start_ns"] <= s["end_ns"]
            if s["parent"] is not None:
                p = outer[s["parent"]]
                assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"], s


def test_spans_are_user_annotations_on_the_trace_clock(tmp_path):
    train, evaluate = _steps(_model("viltbert"))
    batch = _batch([5, 12, 40, 1], [3, 2, 1, 3])
    path = tmp_path / "trace.json"
    spans = _traced([lambda: train(batch), lambda: evaluate(batch)], path)["spans"]
    data = json.loads(path.read_text())
    base_us = int(data["baseTimeNanoseconds"]) / 1e3
    events = defaultdict(list)
    for e in data["traceEvents"]:
        if e.get("ph") == "X" and e.get("name", "").startswith("climb."):
            assert e["cat"] == "user_annotation", e
            events[e["name"]].append(e)
    records = defaultdict(list)
    for s in spans:
        records[s["name"]].append(s)
    assert set(events) == set(records) == set(TRAIN) | set(EVAL) | set(TEXT_ENCODER)
    gaps = []
    for name, got in records.items():
        got = sorted(got, key=lambda s: s["start_ns"])
        want = sorted(events[name], key=lambda e: e["ts"])
        assert len(got) == len(want), name
        for s, e in zip(got, want):
            # the record holds its event (a thread preempted between the two
            # stamps only widens it), to the clocks' agreement
            lead = e["ts"] + base_us - s["start_ns"] / 1e3
            tail = s["end_ns"] / 1e3 - (e["ts"] + e["dur"] + base_us)
            assert lead > -100 and tail > -100, (name, s, e)
            gaps += [lead, tail]
    assert np.median(np.abs(gaps)) < 100


def test_token_counters_match_a_count_by_hand():
    train, evaluate = _steps(_model())
    text_lens, cols = [5, 12, 40, 1], [3, 2, 1, 3]
    batch = _batch(text_lens, cols)
    grid = (HEIGHT // PATCH) * (WIDTH // PATCH)
    slots = BS * (TEXT + 1 + grid)
    tokens = sum(text_lens) + BS + sum(c * HEIGHT // PATCH for c in cols)
    counters = _traced([lambda: evaluate(batch), lambda: train(batch)])["counters"]
    assert counters == {"tokens": 2 * tokens, "token_slots": 2 * slots}


def test_an_exported_eval_step_holds_no_profiler_op(tmp_path):
    model = _model()
    meta = {"task_key": "snli-ve", "patch_size": PATCH, "model_type": "classification",
            "num_images": 1, "num_choices": 0, "tokenizer": "synthetic", "max_text_len": TEXT,
            "image_height": HEIGHT, "image_width": WIDTH, "batch_size": BS}
    path = str(tmp_path / "snli-ve.pt2")
    with profile(activities=[ProfilerActivity.CPU]):
        export.export_eval_step(model, "snli-ve", "ce", torch.float32,
                                _batch([5, 12, 40, 1], [3, 2, 1, 3]), path, meta,
                                platforms=("cpu",))
    assert tracing.snapshot()["spans"] == []
    programs = export.load_artifact(path)["programs"]
    assert programs
    for blob in programs.values():
        ep = torch.export.load(io.BytesIO(zlib.decompress(blob)))
        targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
        assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
