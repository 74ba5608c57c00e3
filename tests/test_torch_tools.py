"""The port's tools against the JAX package's: ``evaluation/make_table``
(the same JSON on fabricated Phase II result trees), ``data/mean_image``
(the same PNG bytes), ``data/host_cost`` (the same cost model on one
measurement, the same measured keys), and the trainer's ``--profile_dir`` and
``--memory_profile`` windows on the CPU. W&B's history against JAX's is held
on the Phase I runs of ``tests/test_torch_train_driver.py``."""

import json
import logging

import numpy as np
import pytest
import torch
from PIL import Image

from climb_tpu.data import host_cost as jax_host_cost
from climb_tpu.data.mean_image import compute_mean_image as jax_mean_image
from climb_tpu.evaluation import make_table as jax_make_table
from climb_tpu_torch.cli import train_upstream_continual_learning as port
from climb_tpu_torch.data import host_cost
from climb_tpu_torch.data.mean_image import compute_mean_image
from climb_tpu_torch.data.mean_image import main as mean_image_main
from climb_tpu_torch.evaluation import make_table
from climb_tpu_torch.train.profiling import StepProfiler
from test_torch_data_common import jax_native_route  # noqa: F401  (fixture)


def _write_results(path, rng, shots, seeds):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({
        f"nshot-{n}": {f"seed-{s}": [float(v) for v in rng.uniform(40, 90, 3)] for s in seeds}
        for n in shots}))


@pytest.fixture(scope="module")
def results_root(tmp_path_factory):
    """Phase II result files under the layout make_table globs, with the
    three name forms it parses (base model, single task, CL run)."""
    root = tmp_path_factory.mktemp("phase2")
    rng = np.random.RandomState(0)
    for sub in ("lang_only", "lang_only/viltbert"):
        for name in ("piqa_vilt", "piqa_singletask_snli-ve",
                     "piqa_task0_snli-ve_sequential-ft", "piqa_task1_nlvr2_ewc",
                     "imdb_vilt"):
            _write_results(root / sub / f"{name}_results.json", rng, (16, 32), (10, 50, 100))
    for name in ("imagenet_vilt", "imagenet_task0_snli-ve_sequential-ft",
                 "imagenet_singletask_vqa"):
        _write_results(root / "vision_only" / f"{name}_results.json", rng, (16,), (0,))
    return root


@pytest.mark.parametrize("task", ["piqa", "imagenet", "sst2"])
def test_make_table_matches_jax(task, results_root, tmp_path, capsys):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = jax_make_table.main([task, "--results_root", str(results_root),
                               "--out_dir", str(tmp_path / "jax")])
    got = make_table.main([task, "--results_root", str(results_root),
                           "--out_dir", str(tmp_path / "port")])
    assert open(got, "rb").read() == open(ref, "rb").read()
    table = json.loads(open(got).read())
    if task == "piqa":
        assert set(table) == {"ViLT", "ViLTBERT"}
        assert set(table["ViLT"]) == {"ViLT", "single", "sequential-ft", "ewc"}
    elif task == "imagenet":
        assert set(table) == {"ViLT", "single", "sequential-ft"}
    else:
        assert table == {}


def test_mean_image_matches_jax(tmp_path):
    """Images of several sizes and modes (and a file that is not one) averaged
    into the same PNG bytes; the CLI writes the same file."""
    rng = np.random.RandomState(1)
    d = tmp_path / "images"
    d.mkdir()
    for i, (w, h, mode) in enumerate([(80, 60, "RGB"), (50, 90, "L"), (64, 64, "RGBA"),
                                      (120, 40, "CMYK"), (33, 17, "RGB")]):
        arr = rng.randint(0, 256, (h, w, len(mode)) if mode != "L" else (h, w), np.uint8)
        Image.fromarray(arr, mode).save(d / f"{i}.{'jpg' if mode == 'CMYK' else 'png'}")
    (d / "notes.txt").write_text("not an image")
    ref = jax_mean_image(str(d), str(tmp_path / "jax.png"), size=(96, 64))
    got = compute_mean_image(str(d), str(tmp_path / "port.png"), size=(96, 64))
    assert got.dtype == ref.dtype == np.uint8 and np.array_equal(got, ref)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    mean_image_main([str(d), str(tmp_path / "cli.png"), "--limit", "3"])
    jax_mean_image(str(d), str(tmp_path / "jax3.png"), limit=3)
    assert (tmp_path / "cli.png").read_bytes() == (tmp_path / "jax3.png").read_bytes()


def test_host_cost_matches_jax(tmp_path, jax_native_route):  # noqa: F811
    """One measurement through both cost models (the same dict at the same
    bandwidth; the port's default bandwidth is the measured one, JAX's
    model_this_host), and both measurements' keys. The JAX package takes its
    native route from a private build, whatever other test processes have
    built in its own directory, as the port builds its own at first use."""
    measured = host_cost.measure_host_costs(iters=1, tmpdir=str(tmp_path), bw_nbytes=1 << 20)
    ref = jax_host_cost.measure_host_costs(iters=1, tmpdir=str(tmp_path), bw_nbytes=1 << 20)
    assert measured.keys() == ref.keys()
    assert measured["jpeg_to_canvas_impl"] == ref["jpeg_to_canvas_impl"]
    assert measured["tokenize_impl"] == ref["tokenize_impl"]
    assert measured["bytes_per_example"] == ref["bytes_per_example"]
    for bw in (5e9, 2.5e10):
        assert host_cost.cost_model(measured, 873.3, 16, bw) == \
            jax_host_cost.cost_model(measured, 873.3, 16, bw)
    assert host_cost.cost_model(measured, 500.0, 8) == jax_host_cost.cost_model(
        measured, 500.0, 8, host_bw_bytes_per_s=measured["host_bw_bytes_per_s"])
    with pytest.raises(SystemExit):  # no TPU headline by default: the caller gives one
        host_cost.main([])


def test_step_profiler_writes_the_window(tmp_path, caplog):
    """Steps 6-10 traced on the CPU and written as a Chrome trace; a task that
    ends inside the window writes what it recorded; the memory snapshot
    warns on the CPU and writes nothing."""
    x = torch.randn(16, 16)
    for name, n_steps in (("full", 12), ("short", 7)):
        with caplog.at_level(logging.WARNING):
            prof = StepProfiler(str(tmp_path / "trace"), str(tmp_path / "mem.pickle"),
                                torch.device("cpu"), name)
        try:
            for step in range(n_steps):
                prof.before_step(step)
                torch.mm(x, x)
                prof.after_step(step + 1)
        finally:
            prof.close()
        trace = json.loads((tmp_path / "trace" / f"{name}.pt.trace.json").read_text())
        mms = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
        assert len(mms) == min(n_steps, 10) - 5
    assert "nothing is written" in caplog.text
    assert not (tmp_path / "mem.pickle").exists()


def test_phase1_profile_names_the_kernels(tmp_path):
    """The Phase I driver with --profile_dir over 12 steps (two epochs of
    six): the trace of steps 6-10 holds the kernel ops (the dispatcher ops of
    the attention forward and the FFN)."""
    argv = ["--encoder_name", "vilt", "--pretrained_model_name", "scratch",
            "--ordered_cl_tasks", "snli-ve", "--cl_algorithm", "singletask_ft",
            "--climb_data_dir", str(tmp_path), "--synthetic", "--tiny",
            "--synthetic_train_size", "48", "--batch_size", "8", "--seed", "5",
            "--task_config_overrides", "snli-ve.num_epochs=2", "--device", "cpu",
            "--attn_impl", "pallas", "--mlp_impl", "pallas", "--output_dir", str(tmp_path),
            "--do_train", "--profile_dir", str(tmp_path / "trace")]
    port.main(argv)
    trace = json.loads((tmp_path / "trace" / "snli-ve.pt.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"climb_tpu_torch::attention_fwd", "climb_tpu_torch::fused_mlp"} <= names
    steps = [e for e in trace["traceEvents"] if e.get("name") == "climb_tpu_torch::fused_mlp"]
    # five steps of two layers, and epoch 1's eval (two batches), which falls
    # inside the window as in the JAX trainer
    assert len(steps) == 5 * 2 + 2 * 2
