"""climb_tpu_torch's adapter algorithm against the JAX package on the CPU:
the Phase I driver with houlsby adapters and with LoRA (on q, v and fc1, so
the FFN runs per op) over snli-ve then nlvr2, and ``predict --cl_algorithm
adapter``.

Both drivers run from the same initialization
(``test_torch_cl_driver_common.py``); their ``results.json`` and
``eval_results.json`` must agree, and so must every task checkpoint's
parameters, adapters included (the port keeps them in the ``adapters`` file
beside the reference-layout ``model``). Only the active task's adapters and
head move while it trains.
"""

import json

import jax
import numpy as np
import pytest
import torch

from test_torch_cl_driver_common import (
    assert_parameters_match,
    assert_results_match,
    changed,
    run_both,
    task_checkpoints,
)
from test_torch_data_common import jit_flax_init, share_jax_eval_steps, shape_only_flax_init
from climb_tpu.ckpt.checkpoint import save_params as jax_save_params
from climb_tpu.ckpt.torch_import import save_reference_checkpoint
from climb_tpu.cl.adapters import AdapterHandler as JaxAdapterHandler
from climb_tpu.cli.predict import main as jax_predict
from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.train.model_factory import create_cl_model as jax_create_cl_model
from climb_tpu_torch.ckpt.checkpoint import save_state_dict
from climb_tpu_torch.ckpt.convert import state_dict_from_jax
from climb_tpu_torch.cli.predict import main as port_predict
from climb_tpu_torch.models.adapters import is_adapter_param

torch.set_num_threads(1)

ADAPTER = ["--cl_algorithm", "adapter", "--adapter_method", "vanilla",
           "--ordered_cl_tasks", "snli-ve,nlvr2"]
RUNS = {
    "houlsby": [*ADAPTER, "--adapter_config", "houlsby", "--adapter_reduction_factor", "4"],
    "lora": [*ADAPTER, "--adapter_config", "lora", "--lora_targets", "q,v,fc1"],
}
UPDATES = 6  # 2 snli-ve and 4 nlvr2 steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(tmp_path_factory, RUNS)


@pytest.mark.parametrize("run", list(RUNS))
def test_results_match_jax_driver(run, runs):
    assert_results_match(runs, RUNS[run])


@pytest.mark.parametrize("run", list(RUNS))
def test_task_checkpoints_match_jax_driver(run, runs):
    assert_parameters_match(runs, RUNS[run], UPDATES)


@pytest.mark.parametrize("run", list(RUNS))
def test_only_the_active_task_moves(run, runs):
    init = runs["init"][run]
    after_snli, after_nlvr2 = task_checkpoints(runs, RUNS[run], "port")
    for ckpt, prev, task in ((after_snli, init, "snli_ve"), (after_nlvr2, after_snli, "nlvr2")):
        moved = changed(prev, ckpt)
        assert any(is_adapter_param(n) for n in moved)
        assert all(n.startswith(f"head_{task}.") or (is_adapter_param(n) and f"_{task}." in n)
                   for n in moved), moved


@pytest.mark.parametrize("config", ["houlsby", "lora"])
def test_predict_adapter_matches_jax(config, tmp_path, monkeypatch):
    """Both CLIs serve nlvr2 with its adapter active from one checkpoint whose
    every leaf (adapters, with non-zero LoRA b, included) is drawn from numpy:
    the JAX CLI from its msgpack file, the port from the reference-layout
    ``model`` file and the ``adapters`` file beside it."""
    flags = ["--cl_algorithm", "adapter", "--adapter_config", config]
    flags += ["--adapter_reduction_factor", "4"] if config == "houlsby" else \
        ["--lora_targets", "q,v,fc1"]
    args = jax_predict.__globals__["build_parser"]().parse_args(
        ["--encoder_name", "vilt", "--ordered_cl_tasks", "snli-ve,nlvr2", "--task_key",
         "nlvr2", "--tiny", "--output_dir", str(tmp_path), *flags])
    args.ordered_cl_tasks = args.ordered_cl_tasks.split(",")
    args.image_height, args.image_width = 64, 96
    with pytest.MonkeyPatch.context() as mp:  # every leaf is drawn from numpy below
        shape_only_flax_init(mp)
        model = jax_create_cl_model(args, jax_task_configs,
                                    adapter_handler=JaxAdapterHandler("vanilla", args))
    rng = np.random.RandomState(4)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.randn(*np.shape(x)) * 0.1
                      + (getattr(p[-1], "key", "") == "scale")).astype(np.float32),
        model.params)
    jax_file = tmp_path / "jax" / "model"
    jax_file.parent.mkdir()
    jax_save_params(tree, str(jax_file))
    port_file = tmp_path / "port" / "model"
    port_file.parent.mkdir()
    save_reference_checkpoint(tree, str(port_file), "model")
    save_state_dict({k: v for k, v in state_dict_from_jax(tree).items() if is_adapter_param(k)},
                    str(port_file.parent / "adapters"))
    common = ["--encoder_name", "vilt", "--ordered_cl_tasks", "snli-ve,nlvr2", "--task_key",
              "nlvr2", "--synthetic", "--tiny", "--synthetic_train_size", "48",
              "--batch_size", "8", "--compute_dtype", "float32", "--seed", "3", *flags]
    jit_flax_init(monkeypatch)
    share_jax_eval_steps(monkeypatch)
    ref = jax_predict(common + ["--checkpoint", str(jax_file), "--output_dir",
                                str(tmp_path / "jax"), "--output_file",
                                str(tmp_path / "jax.json")])
    out = port_predict(common + ["--checkpoint", str(port_file), "--output_dir",
                                 str(tmp_path / "port"), "--output_file",
                                 str(tmp_path / "port.json"), "--device", "cpu"])
    assert out["n_examples"] == ref["n_examples"] == 12
    assert out["predictions"] == ref["predictions"]
    assert out["metric"] == ref["metric"]
    assert json.loads((tmp_path / "port.json").read_text()) == out
