"""climb_tpu_torch's Phase I driver against the JAX driver on the CPU: the
freeze algorithms over snli-ve then nlvr2, and VQA then VCR training.

Both drivers run from the same initialization
(``test_torch_cl_driver_common.py``); their ``results.json`` and
``eval_results.json`` must agree, and so must every task checkpoint's
parameters. The frozen parameters of the port's checkpoints must equal the
initialization bit for bit.
"""

import pytest
import torch

from test_torch_cl_driver_common import (
    assert_parameters_match,
    assert_results_match,
    changed,
    run_both,
    task_checkpoints,
)

torch.set_num_threads(1)

TWO = ["--ordered_cl_tasks", "snli-ve,nlvr2"]
RUNS = {
    "freeze_encoder": ["--cl_algorithm", "freeze_encoder", *TWO],
    "freeze_bottom_k_layers": ["--cl_algorithm", "freeze_bottom_k_layers",
                               "--layers_to_freeze", "1", *TWO],
    # VQA at 8 synthetic answers (soft-target BCE), then VCR (batch 8 / 4 choices)
    "vqa_vcr": ["--cl_algorithm", "sequential_ft", "--ordered_cl_tasks", "vqa,vcr",
                "--synthetic_vqa_labels", "8"],
}
# optimizer updates: 2 snli-ve + 4 nlvr2 steps; 2 vqa + 8 vcr steps
UPDATES = {"freeze_encoder": 6, "freeze_bottom_k_layers": 6, "vqa_vcr": 10}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(tmp_path_factory, RUNS)


@pytest.mark.parametrize("run", list(RUNS))
def test_results_match_jax_driver(run, runs):
    assert_results_match(runs, RUNS[run])


@pytest.mark.parametrize("run", list(RUNS))
def test_task_checkpoints_match_jax_driver(run, runs):
    assert_parameters_match(runs, RUNS[run], UPDATES[run])


@pytest.mark.parametrize("run", ["freeze_encoder", "freeze_bottom_k_layers"])
def test_frozen_parameters_keep_their_initial_values(run, runs):
    init = runs["init"][run]
    for ckpt in task_checkpoints(runs, RUNS[run], "port"):
        moved = changed(init, ckpt)
        if run == "freeze_encoder":
            assert moved and all(n.startswith("head_") for n in moved), moved
        else:  # embeddings and block 0 frozen; block 1, pooler, final LN, heads train
            assert all(n.startswith(("head_", "vilt.encoder.1.", "vilt.pooler.",
                                     "vilt.final_layernorm.")) for n in moved), moved
            assert any(n.startswith("vilt.encoder.1.") for n in moved)
