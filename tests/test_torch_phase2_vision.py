"""climb_tpu_torch's Phase II vision datasets and driver against climb_tpu's
on the CPU.

Each of the four datasets (ImageNet, Places365, iNat2019, COCO-cls) reads a
root fabricated here in its on-disk layout, with small JPEGs: the port's
file lists, labels, splits and n-shot draws equal
``climb_tpu.data.vision.build_vision_dataset``'s, its examples equal the JAX
package's bit for bit on the same decode route (both native, as in
``tests/test_torch_data_images.py``), and so do the canvas-width hints.
``cli.train_vision`` without ``--synthetic`` gives the JAX driver's results
JSON on imagenet (cross entropy, accuracy) and coco-cls (multi-label BCE,
micro-F1), the port starting from the JAX driver's initial parameters.
"""

import csv
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import climb_tpu.train.downstream as jax_downstream
from climb_tpu.cli.train_vision import main as jax_main
from climb_tpu.data.tokenization import load_tokenizer as jax_load_tokenizer
from climb_tpu.data.vision import build_vision_dataset as jax_build
from climb_tpu_torch.ckpt.convert import state_dict_from_jax
from climb_tpu_torch.cli import train_vision as port
from climb_tpu_torch.data.tokenization import load_tokenizer
from climb_tpu_torch.data.vision import build_vision_dataset
from test_torch_data_common import (  # noqa: F401
    copy_root,
    jax_native_route,
    jit_flax_init,
    share_jax_eval_steps,
)

torch.set_num_threads(1)


SCORE_ATOL = 1e-9  # the same predictions on the same examples: equal scores
CANVAS = (64, 96)  # the --tiny canvas
SIZES = ((48, 36), (36, 48), (60, 40))  # (w, h) of the fabricated JPEGs
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "this", "is", "an", "image", "."]
DATA_DIRS = {"imagenet": "ILSVRC2012", "places365": "Places365", "inat2019": "iNat2019",
             "coco-cls": "ms-coco"}
# (n_shot, subsample_seed) of the train draws held against the JAX package
DRAWS = {"imagenet": [(4, 3), (2, None), (None, 5)], "places365": [(4, 3), (None, 1)],
         "inat2019": [(4, 3), (2, 7)], "coco-cls": [(0.5, 3), (0.25, 9), (None, 4)]}


def _jpeg(path, rng, i):
    w, h = SIZES[i % len(SIZES)]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(path, quality=90)


def fabricate_vision_root(root, seed=0):
    """ImageNet and Places365 with 3 classes of 56 train images (50 a class
    go to val) and 4 test images a class; iNat2019 with classes of 30, 12, 3
    and 2 train images (the last two kept whole at 4 shots) and 8 test
    images; COCO-cls with 40 train and 10 val images, 1-3 of 12 categories
    each; and the vocab of the dummy text."""
    rng = np.random.RandomState(seed)
    root = Path(root)
    imagenet = root / DATA_DIRS["imagenet"]
    rows = []
    for c in range(3):
        wnid = f"n0{c:07d}"
        for i in range(56):
            _jpeg(imagenet / "train" / wnid / f"{wnid}_{i}.JPEG", rng, i)
        for i in range(4):
            image_id = f"ILSVRC2012_val_{4 * c + i:08d}"
            _jpeg(imagenet / "val" / f"{image_id}.JPEG", rng, i)
            rows.append((image_id, f"{wnid} 1 2 3 4"))
    rng.shuffle(rows)
    with open(imagenet / "LOC_val_solution.csv", "w", newline="") as f:
        csv.writer(f).writerows([("ImageId", "PredictionString"), *rows])

    places = root / DATA_DIRS["places365"]
    for c, name in enumerate(("airfield", "bakery", "canyon")):
        for i in range(56):
            _jpeg(places / "train" / name / f"{i:08d}.jpg", rng, i)
        for i in range(4):
            _jpeg(places / "val" / name / f"val_{i:08d}.jpg", rng, i)

    inat = root / DATA_DIRS["inat2019"]
    for split, counts in (("train", (30, 12, 3, 2)), ("val", (2, 2, 2, 2))):
        images, annotations = [], []
        for c, n in enumerate(counts):
            for i in range(n):
                fn = f"train_val2019/Plants/{c}/{split}_{c}_{i}.jpg"
                _jpeg(inat / fn, rng, i)
                images.append({"file_name": fn})
                annotations.append({"category_id": c})
        order = rng.permutation(len(images))
        with open(inat / f"{split}2019.json", "w") as f:
            json.dump({"images": [images[i] for i in order],
                       "annotations": [annotations[i] for i in order]}, f)

    coco = root / DATA_DIRS["coco-cls"]
    categories = [1, 2, 3, 5, 7, 11, 18, 24, 44, 62, 77, 90]
    image_id = 100
    for split, n in (("train", 40), ("val", 10)):
        annotations = []
        for i in range(n):
            image_id += 1 + rng.randint(3)
            _jpeg(coco / "images" / f"{image_id:012d}.jpg", rng, i)
            for cat in rng.choice(categories, 1 + rng.randint(3), replace=False):
                annotations.append({"image_id": image_id, "category_id": int(cat)})
        path = coco / "detections" / "annotations" / f"instances_{split}2017.json"
        os.makedirs(path.parent, exist_ok=True)
        path.write_text(json.dumps({"annotations": annotations}))
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    return root


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One root for each package (copies, so that neither reads the other's
    COCO-cls parse cache)."""
    src = fabricate_vision_root(tmp_path_factory.mktemp("vision") / "root")
    out = tmp_path_factory.mktemp("copies")
    return {"src": src, "jax": Path(copy_root(src, out / "jax")),
            "port": Path(copy_root(src, out / "port"))}


def _relative(dataset, root):
    return [[os.path.relpath(fn, root), label] for fn, label in dataset.dataset]


def _both(roots, task, split, n_shot, seed):
    vocab = str(roots["src"] / "vocab.txt")
    got = build_vision_dataset(task, str(roots["port"] / DATA_DIRS[task]), split, n_shot, seed,
                               load_tokenizer(vocab_path=vocab), 40, CANVAS)
    ref = jax_build(task, str(roots["jax"] / DATA_DIRS[task]), split, n_shot, seed,
                    jax_load_tokenizer(vocab_path=vocab), 40, CANVAS)
    return got, ref


@pytest.mark.parametrize("task", list(DATA_DIRS))
def test_splits_and_draws_match_jax(roots, task):
    sizes = {}
    for split, (n_shot, seed) in [("train", d) for d in DRAWS[task]] + [
            ("val", (DRAWS[task][0][0], None)), ("test", (None, None))]:
        got, ref = _both(roots, task, split, n_shot, seed)
        assert _relative(got, roots["port"]) == _relative(ref, roots["jax"]), (split, n_shot)
        sizes.setdefault(split, len(got))
    expected = {"imagenet": {"train": 12, "val": 150, "test": 12},
                "places365": {"train": 12, "val": 150, "test": 12},
                "inat2019": {"train": 13, "val": 4, "test": 8},
                "coco-cls": {"train": 20, "val": 4, "test": 10}}[task]
    assert sizes == expected


@pytest.mark.parametrize("task", list(DATA_DIRS))
def test_examples_bit_equal_to_jax(roots, task, jax_native_route):  # noqa: F811
    got, ref = _both(roots, task, "train", *DRAWS[task][0])
    widths = got.canvas_widths()
    np.testing.assert_array_equal(widths, ref.canvas_widths())
    for i in range(len(got)):
        a, b = got[i], ref[i]
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (task, i, k)
        assert a["patch_hw"][1] * 32 == widths[i]
    ex = got[0]
    assert ex["pixel_values"].shape == CANVAS + (3,) and ex["pixel_values"].dtype == np.uint8
    assert ex["labels"].shape == ((80,) if task == "coco-cls" else ())
    assert int(ex["text_mask"].sum()) == 7  # [CLS] this is an image . [SEP]


RUNS = {
    "imagenet": ["--task_name", "imagenet", "--num_shot", "4", "--task_config_overrides",
                 "imagenet.num_epochs=2,imagenet.lr=2e-3"],
    "coco-cls": ["--task_name", "coco-cls", "--num_shot", "0.5", "--task_config_overrides",
                 "coco-cls.num_epochs=2,coco-cls.lr=2e-3"],
}


def _argv(root, out_dir, run):
    return ["--encoder_name", "vilt", "--checkpoint_name", "scratch",
            "--pretrained_model_name", "scratch", "--tiny", "--climb_data_dir", str(root),
            "--vocab_path", str(Path(root) / "vocab.txt"), "--batch_size", "8", "--seed", "5",
            "--subsample_seed", "3", "--output_dir", str(out_dir), *RUNS[run]]


@pytest.mark.parametrize("run", list(RUNS))
def test_vision_driver_matches_jax(run, roots, tmp_path, monkeypatch,
                                   jax_native_route):  # noqa: F811
    """The results JSON of both drivers, the port's classifier starting from
    the JAX driver's initial parameters (recorded as the JAX driver hands them
    to its training loop)."""
    made = {}
    jax_train, port_train = jax_downstream.train_downstream, port.train_downstream

    def jax_recording(args, module, params, *a, **kw):
        made["params"] = jax.tree_util.tree_map(np.asarray, params)
        return jax_train(args, module, params, *a, **kw)

    def port_from_jax(args, model, *a, **kw):
        model.load_state_dict(state_dict_from_jax(made["params"]))
        return port_train(args, model, *a, **kw)

    jit_flax_init(monkeypatch)
    share_jax_eval_steps(monkeypatch)
    monkeypatch.setattr(jax_downstream, "train_downstream", jax_recording)
    monkeypatch.setattr(port, "train_downstream", port_from_jax)
    jax_main(_argv(roots["jax"], tmp_path / "jax", run))
    out_fn = port.main(_argv(roots["port"], tmp_path / "port", run) + ["--device", "cpu"])
    name = f"{'imagenet' if run == 'imagenet' else 'coco'}_scratch_results.json"
    assert Path(out_fn) == tmp_path / "port" / name
    ref = json.loads((tmp_path / "jax" / name).read_text())
    got = json.loads(Path(out_fn).read_text())
    nshot = "nshot-4" if run == "imagenet" else "nshot-0.5"
    assert got.keys() == ref.keys() == {nshot}
    (test, dev, epoch), (rtest, rdev, repoch) = got[nshot]["seed-3"], ref[nshot]["seed-3"]
    assert epoch == repoch == 2
    np.testing.assert_allclose([test, dev], [rtest, rdev], atol=SCORE_ATOL)
    assert all(0.0 <= x <= 100.0 for x in (test, dev))


def test_vision_driver_synthetic_multilabel(tmp_path):
    """--synthetic coco-cls: multi-hot labels over --synthetic_vision_labels."""
    out_fn = port.main(["--task_name", "coco-cls", "--encoder_name", "vilt", "--checkpoint_name",
                        "scratch", "--pretrained_model_name", "scratch", "--synthetic", "--tiny",
                        "--synthetic_train_size", "16", "--synthetic_vision_labels", "5",
                        "--num_shot", "0.5", "--batch_size", "8", "--output_dir", str(tmp_path),
                        "--task_config_overrides", "coco-cls.num_epochs=1", "--device", "cpu"])
    test, dev, epoch = json.loads(Path(out_fn).read_text())["nshot-0.5"]["seed-None"]
    assert epoch == 1 and all(0.0 <= x <= 100.0 for x in (test, dev))


SCALE_OUT_FLAGS = ["--use_mesh", "--n_model", "2", "--fsdp", "--pp_stages", "2",
                   "--pp_microbatches", "4", "--sharded_checkpoints", "--async_checkpoint"]


def test_vision_driver_runs_with_the_scale_out_flags(tmp_path, caplog):
    """The JAX Phase II drivers parse the scale-out flags and build no mesh;
    the port's run their one-process path too: the same results JSON as
    without the flags, and one line that names them."""
    argv = ["--task_name", "coco-cls", "--encoder_name", "vilt", "--checkpoint_name", "scratch",
            "--pretrained_model_name", "scratch", "--synthetic", "--tiny",
            "--synthetic_train_size", "16", "--synthetic_vision_labels", "5", "--num_shot", "0.5",
            "--batch_size", "8", "--task_config_overrides", "coco-cls.num_epochs=1",
            "--device", "cpu"]
    plain = port.main(argv + ["--output_dir", str(tmp_path / "plain")])
    with caplog.at_level("WARNING"):
        scaled = port.main(argv + ["--output_dir", str(tmp_path / "scaled"), *SCALE_OUT_FLAGS])
    assert Path(scaled).read_text() == Path(plain).read_text()
    assert ("these flags change nothing: --n_model 2, --use_mesh True, --pp_stages 2, "
            "--fsdp True, --pp_microbatches 4, --sharded_checkpoints True, "
            "--async_checkpoint True") in caplog.text


def test_vision_driver_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port.main(_argv(tmp_path, tmp_path, "imagenet"))  # --device defaults to cuda
