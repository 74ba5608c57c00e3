"""climb_tpu_torch.cli.predict's serving modes against climb_tpu.cli.predict on the CPU.

One tiny checkpoint, written by the JAX package in the reference torch layout,
serves raw JSONL rows (images as JPEG and PNG paths, base64 bytes and nested
uint8 arrays) through both CLIs: the output JSONs agree (predictions, metric,
keys; metric null for unlabelled rows), with float dense layers and with
``--dense_impl int8_static`` (calibrated on ``--quant_calibration_batches``
batches). ``--export_model`` then ``--from_export`` gives the eager predict's
JSON on raw rows and on the synthetic split, and the export flags are
checked.
"""

import base64
import io
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from climb_tpu.ckpt.torch_import import save_reference_checkpoint
from climb_tpu.cli.predict import main as jax_predict
from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.models import ViltContinualLearner as JaxLearner
from climb_tpu.models import head_specs_from_task_configs as jax_head_specs
from climb_tpu.train.model_factory import dummy_batch, vilt_config_from_args
from climb_tpu_torch.cli.predict import main as port_predict
from test_torch_data_common import jit_flax_init

torch.set_num_threads(1)

TASKS = "nlvr2,snli-ve,vcr"
N_ROWS = 10  # three batches of 4, the last one padded
TEXTS = ("a photo of two dogs", "the cat is on the grass", "a man holding a red ball",
         "left image is blue", "dogs running", "an empty street at night")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny learner for TASKS, every leaf from numpy, saved by the JAX package."""
    cfg = vilt_config_from_args(SimpleNamespace(tiny=True), needs_three_modalities=True)
    module = JaxLearner(cfg, jax_head_specs(TASKS.split(","), jax_task_configs))
    init = jax.jit(lambda key: module.init(key, dummy_batch(cfg), method=JaxLearner.init_all))
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0))["params"])
    rng = np.random.RandomState(7)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    tree = jax.tree_util.tree_unflatten(treedef, [
        (rng.randn(*x.shape) * 0.1 + (x == 1.0)).astype(np.float32) for x in leaves])
    path = tmp_path_factory.mktemp("ckpt") / "model"
    save_reference_checkpoint(tree, str(path), "model")
    return str(path)


def _image_specs(root, rng, n):
    specs = []
    for i in range(n):
        h, w = rng.randint(30, 130), rng.randint(30, 130)
        arr = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        kind = i % 4
        if kind == 3:
            specs.append(arr.tolist())
            continue
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG" if kind == 1 else "JPEG")
        if kind == 2:
            specs.append({"b64": base64.b64encode(buf.getvalue()).decode()})
        else:
            path = root / f"img{i}.{'png' if kind == 1 else 'jpg'}"
            path.write_bytes(buf.getvalue())
            specs.append(str(path))
    return specs


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """{task: JSONL path}: snli-ve and vcr rows with labels, nlvr2 without;
    and "vocab", the WordPiece vocabulary of their words."""
    root = tmp_path_factory.mktemp("rows")
    rng = np.random.RandomState(11)
    images = _image_specs(root, rng, 2 * N_ROWS)
    text = lambda i: TEXTS[i % len(TEXTS)]
    per_task = {
        "snli-ve": [{"text": text(i), "image": images[i], "label": int(rng.randint(3))}
                    for i in range(N_ROWS)],
        "nlvr2": [{"text": text(i), "images": [images[i], images[N_ROWS + i]]}
                  for i in range(N_ROWS)],
        "vcr": [{"choices": [f"{text(i)} {c}" for c in ("a", "b", "c", "d")],
                 "image": images[N_ROWS + i], "label": int(rng.randint(4))}
                for i in range(N_ROWS)],
    }
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(
        {w for t in TEXTS for w in t.split()} | set("abcd"))
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n")
    out = {"vocab": root / "vocab.txt"}
    for task, task_rows in per_task.items():
        out[task] = root / f"{task}.jsonl"
        out[task].write_text("".join(json.dumps(r) + "\n" for r in task_rows))
    return out


def _argv(task, out_dir, checkpoint, name, *extra):
    return ["--encoder_name", "vilt", "--ordered_cl_tasks", TASKS, "--task_key", task,
            "--checkpoint", checkpoint, "--tiny", "--batch_size", "4",
            "--compute_dtype", "float32", "--seed", "3",
            "--output_dir", str(out_dir), "--output_file", str(out_dir / f"{name}.json"),
            *extra]


PORT = ("--device", "cpu", "--attn_impl", "pallas", "--mlp_impl", "pallas")


def _same_json(out, ref, path):
    assert json.loads(path.read_text()) == out
    assert sorted(out) == sorted(ref)
    assert out["n_examples"] == ref["n_examples"] == N_ROWS
    assert out["predictions"] == ref["predictions"]
    assert out["metric"] == ref["metric"]
    assert out["checkpoint"] == ref["checkpoint"]


@pytest.mark.parametrize("task", ["snli-ve", "nlvr2", "vcr"])
def test_input_jsonl_matches_jax_cli(task, checkpoint, rows, tmp_path, monkeypatch):
    jit_flax_init(monkeypatch)
    flags = ("--input_jsonl", str(rows[task]), "--vocab_path", str(rows["vocab"]))
    ref = jax_predict(_argv(task, tmp_path, checkpoint, "jax", *flags))
    out = port_predict(_argv(task, tmp_path, checkpoint, "port", *flags, *PORT))
    _same_json(out, ref, tmp_path / "port.json")
    assert (out["metric"] is None) == (task == "nlvr2")  # nlvr2's rows carry no label


def test_int8_static_jsonl_matches_jax_cli(checkpoint, rows, tmp_path, monkeypatch):
    """--dense_impl int8_static calibrates on --quant_calibration_batches
    batches of the served rows, then serves int8."""
    jit_flax_init(monkeypatch)
    flags = ("--input_jsonl", str(rows["snli-ve"]), "--vocab_path", str(rows["vocab"]),
             "--dense_impl", "int8_static",
             "--mlp_impl", "xla", "--quant_calibration_batches", "2")
    ref = jax_predict(_argv("snli-ve", tmp_path, checkpoint, "jax", *flags))
    calibrated = []
    from climb_tpu_torch.cli import predict

    real = predict.calibrate_quant_scales
    monkeypatch.setattr(predict, "calibrate_quant_scales",
                        lambda *a, **k: calibrated.append(real(*a, **k)) or calibrated[-1])
    out = port_predict(_argv("snli-ve", tmp_path, checkpoint, "port", *flags, "--device", "cpu"))
    _same_json(out, ref, tmp_path / "port.json")
    assert len(calibrated[0]) == 6 * 2 + 1  # q, k, v, attn_out, fc1, fc2 a block; patches


def _without_rate(out):
    return {k: v for k, v in out.items() if k not in ("examples_per_sec", "checkpoint")}


def test_export_then_from_export_matches_eager(checkpoint, rows, tmp_path):
    """A 2 x 2 ladder artifact (batch 2 and 4, canvas 64 and 96) serves the
    eager predict's JSON on raw rows and on the synthetic split (aspect
    buckets snapped to the width ladder)."""
    artifact = str(tmp_path / "snli-ve.pt2")
    data = ("--synthetic", "--synthetic_train_size", "40", "--aspect_buckets", "auto")
    meta = port_predict(_argv("snli-ve", tmp_path, checkpoint, "export", *data, *PORT,
                              "--export_model", artifact, "--export_platforms", "cpu",
                              "--export_batch_sizes", "2", "--export_canvas_widths", "64"))
    assert meta["batch_sizes"] == [2, 4] and meta["canvas_widths"] == [64, 96]
    assert meta["platforms"] == ["cpu"] and meta["batch_size"] == 4
    assert not (tmp_path / "export.json").exists()  # export writes no predictions
    jsonl = ("--input_jsonl", str(rows["snli-ve"]), "--vocab_path", str(rows["vocab"]))
    eager = port_predict(_argv("snli-ve", tmp_path, checkpoint, "eager", *jsonl, *PORT))
    served = port_predict(_argv("snli-ve", tmp_path, checkpoint, "served", *jsonl,
                                "--device", "cpu", "--from_export", artifact))
    assert served["checkpoint"] == artifact
    assert _without_rate(served) == _without_rate(eager)
    eager = port_predict(_argv("snli-ve", tmp_path, checkpoint, "eager_ds", *data, *PORT))
    served = port_predict(_argv("snli-ve", tmp_path, checkpoint, "served_ds", *data,
                                "--device", "cpu", "--from_export", artifact))
    assert served["n_examples"] == eager["n_examples"] == 10
    assert _without_rate(served) == _without_rate(eager)


def test_export_platform_tpu_raises(checkpoint, tmp_path):
    with pytest.raises(ValueError, match="tpu"):
        port_predict(_argv("snli-ve", tmp_path, checkpoint, "x", "--synthetic", *PORT,
                           "--export_model", str(tmp_path / "a.pt2"),
                           "--export_platforms", "tpu"))
    assert not (tmp_path / "a.pt2").exists()


def test_from_export_refuses_a_jax_artifact(checkpoint, tmp_path):
    from flax import serialization

    path = tmp_path / "snli-ve.climbx"
    path.write_bytes(serialization.msgpack_serialize({"stablehlo": b"\x00", "params": {},
                                                      "meta": {"format_version": 1}}))
    with pytest.raises(ValueError, match="JAX"):
        port_predict(_argv("snli-ve", tmp_path, checkpoint, "x", "--synthetic", "--device",
                           "cpu", "--from_export", str(path)))
