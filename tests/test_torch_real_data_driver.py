"""The port's Phase I driver and ``predict`` on a CLiMB data root (no
``--synthetic``) against the JAX package's, on the CPU in float32.

Both drivers run sequential_ft snli-ve -> nlvr2 over the mini data root of
``tests/test_driver_real_data.py`` (each package on its own copy, so each
parses and caches it), with the WordPiece vocabulary written by that test and
their loaders' default two thread workers; the port starts from the JAX
driver's initialization. Results, eval results and every task checkpoint's
parameters are held to the driver tolerances of
``tests/test_torch_cl_driver_common.py``. ``predict`` of both packages then
serves the snli-ve dev split from the port's checkpoint: the same predictions
in example order and the same metric. A ``--visual_input_type raw`` run
(pixels normalized on the host) takes the same steps as the ``pil-image``
run: its checkpoint is bit-equal.
"""

import json
import os

import pytest
import torch

from climb_tpu.cli.predict import main as jax_predict
from climb_tpu.cli.train_upstream_continual_learning import main as jax_main
from climb_tpu_torch.ckpt.checkpoint import load_task_checkpoint
from climb_tpu_torch.cli import predict as port_predict
from climb_tpu_torch.cli import train_upstream_continual_learning as port
from test_driver_real_data import climb_dir  # noqa: F401  (the mini data root)
from test_torch_cl_driver_common import (
    LR,
    assert_parameters_match,
    assert_results_match,
    experiment,
    start_from_jax,
)
from test_torch_data_common import (  # noqa: F401
    copy_root,
    jax_native_route,
    jit_flax_init,
    share_jax_eval_steps,
)

torch.set_num_threads(1)

FLAGS = ["--ordered_cl_tasks", "snli-ve,nlvr2", "--cl_algorithm", "sequential_ft"]
OVERRIDES = ",".join(f"{t}.lr={LR},{t}.num_epochs=1" for t in ("snli-ve", "nlvr2"))
# snli-ve: 6 examples at batch 4; nlvr2: 4 pairs at batch 4 / 2
N_UPDATES = 2 + 2


def real_argv(root, out_dir, flags, *extra):
    return ["--encoder_name", "vilt", "--pretrained_model_name", "scratch",
            "--climb_data_dir", root, "--vocab_path", os.path.join(root, "vocab.txt"),
            "--tiny", "--batch_size", "4", "--seed", "5", "--task_config_overrides", OVERRIDES,
            "--output_dir", str(out_dir), "--do_train", "--do_eval", *flags, *extra]


@pytest.fixture(scope="module")
def runs(climb_dir, tmp_path_factory, jax_native_route):  # noqa: F811
    base = tmp_path_factory.mktemp("real_driver")
    out = {"jax": base / "jax", "port": base / "port",
           "root_jax": copy_root(climb_dir, base / "root_jax"),
           "root_port": copy_root(climb_dir, base / "root_port")}
    mp = pytest.MonkeyPatch()
    start_from_jax(mp)
    try:
        jax_main(real_argv(out["root_jax"], out["jax"], FLAGS))
        port.main(real_argv(out["root_port"], out["port"], FLAGS, "--device", "cpu"))
    finally:
        mp.undo()
    return out


def test_driver_matches_jax_on_the_data_root(runs):
    assert_results_match(runs, FLAGS)
    assert_parameters_match(runs, FLAGS, N_UPDATES)
    # each package parsed its own copy of the root into the same caches
    for pkg in ("root_jax", "root_port"):
        assert os.path.exists(os.path.join(runs[pkg], "snli-ve", "cached_ve_data",
                                           "snli-ve_train.pkl"))


def test_predict_from_disk_matches_jax(runs, tmp_path, monkeypatch):
    ckpt = str(experiment(runs["port"], FLAGS) / "checkpoints" / "task1_nlvr2" / "model")

    def argv(out):
        return ["--encoder_name", "vilt", "--ordered_cl_tasks", "snli-ve,nlvr2",
                "--task_key", "snli-ve", "--checkpoint", ckpt, "--climb_data_dir",
                runs["root_port"], "--vocab_path", os.path.join(runs["root_port"], "vocab.txt"),
                "--tiny", "--batch_size", "2", "--compute_dtype", "float32", "--seed", "5",
                "--output_dir", str(out), "--output_file", str(out / "preds.json")]

    jit_flax_init(monkeypatch)
    share_jax_eval_steps(monkeypatch)
    want = jax_predict(argv(tmp_path / "jax"))
    got = port_predict.main(argv(tmp_path / "port") + ["--device", "cpu"])
    assert got["n_examples"] == want["n_examples"] == 3
    assert got["predictions"] == want["predictions"]
    assert got["metric"] == want["metric"]
    assert json.loads((tmp_path / "port" / "preds.json").read_text()) == got


def test_raw_visual_input_run_equals_pil_image_run(climb_dir, tmp_path):  # noqa: F811
    root = copy_root(climb_dir, tmp_path / "root")
    flags = ["--ordered_cl_tasks", "snli-ve", "--cl_algorithm", "singletask_ft", "--device",
             "cpu"]
    for vit in ("pil-image", "raw"):
        port.main(real_argv(root, tmp_path / vit, flags, "--visual_input_type", vit))
    exps = {vit: experiment(tmp_path / vit, flags[:4]) for vit in ("pil-image", "raw")}
    results = {vit: json.loads((exp / "results.json").read_text()) for vit, exp in exps.items()}
    assert results["raw"] == results["pil-image"]
    pil, raw = (load_task_checkpoint(str(exps[vit]), 0, "snli-ve") for vit in ("pil-image", "raw"))
    assert pil.keys() == raw.keys()
    assert all(torch.equal(pil[k], raw[k]) for k in pil)
