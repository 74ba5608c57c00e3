"""The port's Phase I driver against the JAX package's on the mini CLiMB data
root's VQAv2 and VCR splits (no ``--synthetic``), on the CPU in float32:
sequential_ft vqa -> vcr, with VQA's soft targets over the task config's
3,129 answers from the annotation files and VCR's four 'question [SEP]
answer' choices a batch. The set-up and tolerances are those of
``tests/test_torch_real_data_driver.py`` (snli-ve and nlvr2 there).
"""

import pytest
import torch

from climb_tpu.cli.train_upstream_continual_learning import main as jax_main
from climb_tpu_torch.cli import train_upstream_continual_learning as port
from test_driver_real_data import climb_dir  # noqa: F401  (the mini data root)
from test_torch_cl_driver_common import (
    LR,
    assert_parameters_match,
    assert_results_match,
    start_from_jax,
)
from test_torch_data_common import copy_root, jax_native_route  # noqa: F401
from test_torch_real_data_driver import real_argv

torch.set_num_threads(1)

FLAGS = ["--ordered_cl_tasks", "vqa,vcr", "--cl_algorithm", "sequential_ft",
         "--task_config_overrides", ",".join(f"{t}.lr={LR},{t}.num_epochs=1"
                                             for t in ("vqa", "vcr"))]
# vqa: 4 examples at batch 4; vcr: 4 examples at batch 4 / 4 choices
N_UPDATES = 1 + 4


def test_vqa_vcr_driver_matches_jax_on_the_data_root(climb_dir, tmp_path,  # noqa: F811
                                                      jax_native_route):  # noqa: F811
    runs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    mp = pytest.MonkeyPatch()
    start_from_jax(mp)
    try:
        jax_main(real_argv(copy_root(climb_dir, tmp_path / "root_jax"), runs["jax"], FLAGS))
        port.main(real_argv(copy_root(climb_dir, tmp_path / "root_port"), runs["port"], FLAGS,
                            "--device", "cpu"))
    finally:
        mp.undo()
    assert_results_match(runs, FLAGS[:4])
    assert_parameters_match(runs, FLAGS[:4], N_UPDATES)
