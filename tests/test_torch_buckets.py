"""Aspect and text bucketing of climb_tpu_torch's loader and drivers against
climb_tpu on the CPU (mirrors ``tests/test_aspect_buckets.py`` and
``tests/test_text_buckets.py``).

The port's ``DataLoader`` and the JAX package's, over the same synthetic
splits (each package's own, which are equal), with ``--aspect_buckets``,
``--text_buckets`` or both, shuffled, over two epochs, under ``drop_last``
both ways and with thread and process workers, emit the same batches bit
for bit: the same indices, canvas widths, text lengths and arrays. Also
``set_skip``, ``example_order``, the crops' widen-don't-cut rules, the flag
parsers, and a Phase I run with canvas buckets and a ``predict`` with canvas
and text buckets against the JAX drivers (the port's predict reads the JAX
run's msgpack checkpoint).
"""

import json

import numpy as np
import pytest

from climb_tpu.cli.predict import main as jax_predict
from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.data import loader as jax_loader
from climb_tpu.data.collation import stack_collate as jax_collate
from climb_tpu.data.synthetic import make_synthetic_vl_dataset as jax_synthetic
from climb_tpu_torch.cli.predict import main as port_predict
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.data import loader
from climb_tpu_torch.data.collation import stack_collate
from climb_tpu_torch.data.synthetic import make_synthetic_vl_dataset
from test_torch_cl_driver_common import assert_results_match, experiment, run_both
from test_torch_data_common import jit_flax_init, share_jax_eval_steps

CANVAS = (64, 96)
BUCKETS = {"aspect": ((32, 64, 96), None), "text": (None, (16, 24, 40)),
           "both": ((32, 64, 96), (16, 24, 40))}


def _splits(task, size=37, seed=4):
    return (make_synthetic_vl_dataset(task, task_configs[task], "train", size, 40, CANVAS, seed),
            jax_synthetic(task, jax_task_configs[task], "train", size, 40, CANVAS, seed))


def _loaders(task, mode, drop_last, worker_mode="thread", batch_size=5):
    port_ds, jax_ds = _splits(task)
    widths, lens = BUCKETS[mode]
    kw = dict(shuffle=True, drop_last=drop_last, seed=9, num_workers=2,
              worker_mode=worker_mode, bucket_widths=widths, text_bucket_lens=lens)
    return (loader.DataLoader(port_ds, batch_size, stack_collate, **kw),
            jax_loader.DataLoader(jax_ds, batch_size, jax_collate, host_id=0, host_count=1,
                                  **kw))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("mode", list(BUCKETS))
def test_bucketed_batches_match_jax(mode, drop_last, worker_mode):
    task = "vcr" if mode == "text" else "nlvr2" if mode == "aspect" else "snli-ve"
    port, ref = _loaders(task, mode, drop_last, worker_mode)
    assert port.is_bucketed and ref.is_bucketed
    for epoch in (1, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert len(port) == len(ref)
        plan, ref_plan = port._index_batches(), ref._index_batches()
        assert [(list(i), w, t) for i, w, t in plan] == [(list(i), w, t) for i, w, t in ref_plan]
        _assert_batches_equal(list(port), list(ref))
        np.testing.assert_array_equal(port.example_order(), ref.example_order())
    # every batch is homogeneous: its canvas and text are its bucket's
    for (inds, w, t), batch in zip(plan, port):
        if w is not None:
            assert batch["pixel_values"].shape[-2] == w
        if t is not None:
            assert batch["input_ids"].shape[-1] == t


def test_set_skip_replays_the_suffix():
    port, _ = _loaders("snli-ve", "both", False)
    port.set_epoch(2)
    whole = list(port)
    port.set_skip(3)
    _assert_batches_equal(list(port), whole[3:])
    _assert_batches_equal(list(port), whole)  # the skip holds for one iteration only


def test_example_order_is_the_emission_order():
    port, _ = _loaders("snli-ve", "both", False)
    port.set_epoch(1)
    order = port.example_order()
    assert sorted(order.tolist()) == list(range(len(port.dataset)))
    assert order.tolist() == [int(i) for inds, _, _ in port._index_batches() for i in inds]
    port.drop_last = True
    port._len_cache = (None, 0)
    assert len(port.example_order()) < len(port.dataset)  # partial buckets dropped
    unbucketed = loader.DataLoader(port.dataset, 5, stack_collate)
    assert not unbucketed.is_bucketed


def _example(width_patches, tokens, canvas_w=96, length=40):
    mask = (np.arange(length) < tokens).astype(np.int32)
    return {"pixel_values": np.zeros((64, canvas_w, 3), np.uint8),
            "patch_hw": np.array([2, width_patches], np.int32),
            "input_ids": np.arange(length, dtype=np.int32), "text_mask": mask,
            "token_type_ids": np.zeros(length, np.int32)}


@pytest.mark.parametrize("bucket_w,widths", [(64, (1, 2)), (32, (1, 2)), (64, (3,)), (None, (1,))])
def test_canvas_crop_widens_instead_of_cutting(bucket_w, widths):
    examples = [_example(w, 10) for w in widths]
    got = loader.crop_examples_to_bucket(examples, bucket_w)
    want = jax_loader.crop_examples_to_bucket(examples, bucket_w)
    needed = 32 * max(widths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["pixel_values"], w["pixel_values"])
        if bucket_w is not None:
            assert g["pixel_values"].shape[1] == max(bucket_w, needed)


@pytest.mark.parametrize("text_len,tokens", [(16, (9, 12)), (16, (9, 21)), (24, (40,)),
                                             (None, (3,)), (40, (5,))])
def test_text_cut_widens_instead_of_cutting(text_len, tokens):
    examples = [_example(1, n) for n in tokens]
    got = loader.crop_examples_to_text_len(examples, text_len)
    want = jax_loader.crop_examples_to_text_len(examples, text_len)
    for g, w in zip(got, want):
        for k in loader.TEXT_KEYS:
            np.testing.assert_array_equal(g[k], w[k])
        assert g["text_mask"].sum() == examples[0]["text_mask"].sum() or len(tokens) > 1
    if text_len is not None:
        need = -(-max(tokens) // 8) * 8
        assert got[0]["input_ids"].shape[-1] == min(max(text_len, need), 40)


@pytest.mark.parametrize("value", [None, "auto", "384,512,640", "640,384", "", (512, 640)])
def test_parse_bucket_widths_matches_jax(value):
    for canvas in (640, 96):
        assert loader.parse_bucket_widths(value, canvas) == \
            jax_loader.parse_bucket_widths(value, canvas)


@pytest.mark.parametrize("value", [None, "auto", "16,40", "24", "48,8", "", (12, 30)])
def test_parse_text_buckets_matches_jax(value):
    for max_len in (40, 20, 16):
        assert loader.parse_text_buckets(value, max_len) == \
            jax_loader.parse_text_buckets(value, max_len)


def test_dataset_without_hints_runs_unbucketed(caplog):
    class Plain:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return _example(1, 4)

    dl = loader.DataLoader(Plain(), 2, stack_collate, bucket_widths=(32, 96),
                           text_bucket_lens=(16, 40))
    assert not dl.is_bucketed and len(dl) == 2
    assert "provides no canvas_widths()" in caplog.text


# The Phase I run buckets canvases alone (each bucket shape costs the JAX
# driver a compile); the predict run below adds --text_buckets
FLAGS = ["--cl_algorithm", "sequential_ft", "--ordered_cl_tasks", "snli-ve,nlvr2",
         "--aspect_buckets", "64,96"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(tmp_path_factory, {"bucketed": FLAGS})


def test_bucketed_phase1_run_matches_jax_driver(runs):
    assert_results_match(runs, FLAGS)


def test_bucketed_predict_matches_jax_cli(runs, tmp_path, monkeypatch):
    """Both CLIs on the JAX run's msgpack snli-ve checkpoint, bucketed: the
    same predictions in dataset order and the same metric."""
    jit_flax_init(monkeypatch)
    share_jax_eval_steps(monkeypatch)
    ckpt = experiment(runs["jax"], FLAGS) / "checkpoints" / "task0_snli-ve" / "model"

    def argv(out):
        return ["--encoder_name", "vilt", "--ordered_cl_tasks", "snli-ve,nlvr2",
                "--task_key", "snli-ve", "--checkpoint", str(ckpt), "--synthetic", "--tiny",
                "--synthetic_train_size", "48", "--batch_size", "4", "--seed", "3",
                "--compute_dtype", "float32", "--aspect_buckets", "64,96",
                "--text_buckets", "auto", "--output_dir", str(out),
                "--output_file", str(out / "preds.json")]

    ref = jax_predict(argv(tmp_path / "jax"))
    got = port_predict(argv(tmp_path / "port") + ["--device", "cpu"])
    assert got["n_examples"] == ref["n_examples"] == 12
    assert got["predictions"] == ref["predictions"]
    assert got["metric"] == ref["metric"]
    assert json.loads((tmp_path / "port" / "preds.json").read_text()) == got
